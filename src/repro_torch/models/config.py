"""Model configuration and layer-pattern machinery, copied from the
JAX package's ``models/config.py`` as plain data.

A model is a stack of ``n_layers`` layers formed by repeating a
``pattern`` unit (e.g. jamba's 8-layer mamba/attention interleave,
gemma2's local/global pair).  ``scan_spec`` is built on the port's
:class:`~repro_torch.core.scan_api.ScanSpec`.  The parameter and FLOP
accounting reads the parameter tables of ``models/params.py``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Literal

from repro_torch.core.scan_api import ScanSpec

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating pattern unit."""

    kind: str  # "attn" | "mamba" | "rwkv"
    use_moe: bool = False
    sliding_window: int = 0  # >0: local attention with this window


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert_ff: int = 0  # per-expert hidden (d_ff used if 0)

    # --- attention variants ---
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0  # gemma2 final-logit softcap
    attn_softcap: float = 0.0  # gemma2 attention-score softcap
    sliding_window: int = 0  # applied to "local" pattern positions
    local_global_period: int = 0  # gemma2: alternate local/global attn
    causal: bool = True
    encoder_only: bool = False

    # --- SSM (mamba) ---
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    attn_period: int = 0  # hybrid: one attn layer per this many layers

    # --- modality frontend stub ---
    frontend: str = ""  # "" | "vision" | "audio"
    n_prefix: int = 0  # stub prefix-embedding positions (vlm)

    # --- runtime ---
    dtype: str = "bfloat16"
    # Scan collective policy for every exscan site (MoE dispatch,
    # context-parallel SSM/WKV carries, gradient compression): the
    # planner resolves "auto" per call site from (p, payload bytes,
    # monoid cost) — see core/scan_api.py and DESIGN.md §7.  Call sites
    # read ``cfg.scan_spec`` and re-target it with ``.over(axes, ...)``.
    scan: ScanSpec = ScanSpec(kind="exclusive", algorithm="auto")
    # DEPRECATED: pre-planner string knob.  When set, overrides
    # ``scan.algorithm`` (compatibility shim; use ``scan=ScanSpec(...)``).
    exscan_algorithm: str | None = None
    capacity_factor: float = 1.25
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_chunk: int = 512  # q-chunk for memory-bounded attention
    # unroll the layer stack instead of lax.scan — used by the dry-run's
    # cost probes (XLA cost_analysis counts while bodies once)
    unroll_stack: bool = False
    remat: bool = True
    remat_policy: str = "nothing"  # "nothing" | "dots"
    # decode-path MoE: keep expert weights FSDP-sharded and move the
    # (tiny) activations instead of gathering weights (§Perf)
    moe_weight_stationary: bool = True
    # parallelism strategy (sharding/rules.py):
    #   "tp"      — FSDP over (pod, data) + tensor parallel over "model"
    #   "fsdp_sp" — FSDP over all axes + sequence parallel over "model"
    #               (no per-layer TP activation reductions)
    sharding_strategy: str = "tp"

    @property
    def scan_spec(self) -> ScanSpec:
        """The effective ScanSpec, honouring the deprecated
        ``exscan_algorithm`` string override."""
        if self.exscan_algorithm is not None:
            warnings.warn(
                "ModelConfig.exscan_algorithm is deprecated; pass "
                "scan=ScanSpec(algorithm=...) instead",
                DeprecationWarning, stacklevel=2)
            return dataclasses.replace(
                self.scan, algorithm=self.exscan_algorithm)
        return self.scan

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def moe_d_ff(self) -> int:
        return self.d_expert_ff or self.d_ff

    # ----------------------- pattern -----------------------

    def pattern(self) -> tuple[LayerSpec, ...]:
        """The repeating layer unit; len divides n_layers."""
        if self.family == "ssm":
            return (LayerSpec("rwkv"),)
        if self.family == "hybrid":
            # jamba: one attention layer per `attn_period` mamba-ish
            # layers, MoE on every second layer of the unit.
            period = self.attn_period or 8
            unit = []
            for j in range(period):
                kind = "attn" if j == period // 2 else "mamba"
                unit.append(LayerSpec(kind, use_moe=(j % 2 == 1)))
            return tuple(unit)
        if self.local_global_period:
            # gemma2: (local, global) alternation
            return (
                LayerSpec("attn", use_moe=False,
                          sliding_window=self.sliding_window),
                LayerSpec("attn", use_moe=False, sliding_window=0),
            )
        moe = self.n_experts > 0
        return (LayerSpec("attn", use_moe=moe),)

    @property
    def n_repeats(self) -> int:
        unit = len(self.pattern())
        if self.n_layers % unit:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern unit {unit}"
            )
        return self.n_layers // unit

    # ----------------------- accounting -----------------------

    def param_count(self) -> int:
        """Exact parameter count (matches init_params)."""
        from repro_torch.models import params as P  # lazy, avoids cycle

        return P.count_params(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts)."""
        from repro_torch.models import params as P

        return P.count_params(self, active_only=True)

    def model_flops_per_token(self, seq_len: int, training: bool) -> float:
        """6·N_active per token (+ attention window term), the §Roofline
        MODEL_FLOPS convention; fwd-only is 1/3 of the training value."""
        n = self.active_param_count()
        base = 6.0 * n
        # attention score/value FLOPs: 12 * H * hd * attended_len
        attended = _mean_attended(self, seq_len)
        attn = 12.0 * self.n_heads * self.head_dim_ * attended * (
            self._attn_layer_fraction()
        )
        total = (base + attn * self.n_layers / max(self.n_layers, 1))
        return total if training else total / 3.0

    def _attn_layer_fraction(self) -> float:
        pat = self.pattern()
        return sum(1 for s in pat if s.kind == "attn") / len(pat)


def _mean_attended(cfg: ModelConfig, seq_len: int) -> float:
    if cfg.sliding_window and cfg.local_global_period:
        local = min(cfg.sliding_window, seq_len)
        full = (seq_len + 1) / 2 if cfg.causal else seq_len
        return (local + full) / 2
    if cfg.causal:
        return (seq_len + 1) / 2
    return float(seq_len)
