"""Unified scan API: ``ScanSpec`` in, ``ScanPlan`` out, one ``scan()``.

The paper's observation is that the right prefix-scan algorithm depends
on the regime: for small payloads the round count dominates (the
123-doubling algorithm's q = ⌈log₂(p−1)+log₂(4/3)⌉ rounds win), for
large ones bandwidth does.  Callers describe *what* they need with a
:class:`ScanSpec` and the planner decides *how*:

    spec = ScanSpec(kind="exclusive", monoid="xor", algorithm="auto")
    y = scan(x, spec)                 # x: leaves (p, ...), ranks stacked
    pl = plan(spec, p=512, nbytes=8)  # inspect the choice first
    pl.algorithm, pl.rounds, pl.schedule().describe(), pl.explain()

Every registered algorithm builds an explicit schedule
(:mod:`repro_torch.core.schedule`); the planner counts its predictions
off that IR and the :class:`~repro_torch.core.schedule.StackedExecutor`
runs the same IR, so a plan predicts what ``collect_stats()`` measures.
``algorithm="auto"`` minimises the α·rounds + β·bytes + γ·⊕ model of
:class:`CostModel`; plans are cached by (spec, sizes, payload bytes,
resolved pricing constants).  The planner is, decision for decision,
the JAX package's ``core/scan_api.py``: under the same constants both
pick the same algorithm, segment count and cost.

:func:`fused_scan` packs k concurrent scans into one payload that rides
one schedule's rounds when the cost model approves, and
:func:`scan_with_total` fuses an exclusive scan with an allreduce of
the same payload.  Multi-axis specs plan (``plan_hierarchical``), but
their composed schedules do not execute on one card yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable

import numpy as np

from repro_torch import _tree
from repro_torch import device as device_lib
from repro_torch.core import monoid as monoid_lib
from repro_torch.core import schedule as schedule_lib


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------


# Defaults for ranks stacked on ONE card: NVIDIA H100 80GB HBM3, power
# limit 700.00 W (nvidia-smi name and power.limit of the card measured).
#   alpha — the per-round overhead, almost all of it the host's issue of
#     a round's gather, mask and kernel launch: chip_smoke.py's table1
#     "alpha_s", the median time of a 123-doubling exscan of one int64
#     at p = 512 divided by its 10 rounds (2.00 ms / 10 on that card;
#     PERF.md gives the spread).
#   beta, gamma — from the card's published HBM rate (3.35 TB/s) until a
#     calibration measures them: a wire byte is read and written once by
#     the rank-axis gather (2 bytes of traffic); one ⊕ reads two operands
#     and writes one (3).  Ranks share the one HBM, so the true cost of
#     a round grows with p; the per-rank model does not see that yet.
HBM_BYTES_PER_S = 3.35e12
STACKED_ALPHA_S = 200e-6


@dataclasses.dataclass(frozen=True)
class CostModel:
    """The immutable α-β-γ *pricing kernel* for algorithm selection.

    ``cost = alpha * latency_hops + beta * serial_bytes
           + gamma * op_applications * payload_bytes * monoid.op_cost``

    alpha: seconds per send-receive round.  An all-gather counts as
      its internal hop count (p−1 hops).
    beta: seconds per byte on the bandwidth-critical path.
    gamma: seconds per byte touched by one ⊕ application, scaled by the
      monoid's relative op cost.
    gamma_pass: seconds per byte per *HBM pass* of the round kernels
      (``Schedule.kernel_passes``).  The default 0.0 keeps γ pricing
      purely op-count-based; a calibrated profile can charge the fused
      single-pass round path less than the multi-pass baseline.
    source: provenance of the constants — "default" or "calibrated".
      Part of equality/hash, so plans priced under a calibrated model
      never alias cached plans priced under identical-looking defaults.
    """

    alpha: float = STACKED_ALPHA_S
    beta: float = 2.0 / HBM_BYTES_PER_S
    gamma: float = 3.0 / HBM_BYTES_PER_S
    gamma_pass: float = 0.0  # per-byte-per-HBM-pass (0: op-count only)
    source: str = "default"  # "default" | "calibrated"

    def parts(self, *, hops: int, serial_bytes: float, ops: int,
              payload_bytes: int, op_cost: float = 1.0,
              passes: int = 0, op_bytes: float = -1.0,
              pass_bytes: float = -1.0) -> dict:
        """The three cost components, separately (``explain()`` uses
        them to say *why* a candidate lost).  ``passes`` — the plan's
        HBM-pass count — folds into the γ component when
        ``gamma_pass`` is nonzero (it prices memory traffic, like γ).

        ``op_bytes`` / ``pass_bytes`` (when >= 0) override the uniform
        ``ops·payload_bytes`` / ``passes·payload_bytes`` products with
        the schedule's exact per-step byte laws — needed by the
        block-distributed algorithms whose ⊕ rounds each touch a
        different slice of the payload (``schedule.op_wire_bytes``)."""
        gamma_op = (op_bytes if op_bytes >= 0
                    else ops * payload_bytes)
        gamma_mem = (pass_bytes if pass_bytes >= 0
                     else passes * payload_bytes)
        return {
            "alpha": self.alpha * hops,
            "beta": self.beta * serial_bytes,
            "gamma": self.gamma * gamma_op * op_cost
            + self.gamma_pass * gamma_mem,
        }

    def cost(self, *, hops: int, serial_bytes: float, ops: int,
             payload_bytes: int, op_cost: float = 1.0,
             passes: int = 0, op_bytes: float = -1.0,
             pass_bytes: float = -1.0) -> float:
        return sum(self.parts(
            hops=hops, serial_bytes=serial_bytes, ops=ops,
            payload_bytes=payload_bytes, op_cost=op_cost,
            passes=passes, op_bytes=op_bytes,
            pass_bytes=pass_bytes).values())


DEFAULT_COST_MODEL = CostModel()

PROFILE_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class CostProfile:
    """A full pricing *profile*: per-tier :class:`CostModel` kernels
    plus the provenance that justifies them.

    The planner prices every decision off one of these (directly, or
    through a per-axis resolver like ``launch.mesh.axis_cost_model``).
    A profile is either the ``source="default"`` one, or
    ``source="calibrated"`` — fitted from measured schedule timings on
    a specific machine, in which case ``mesh_fingerprint`` records
    which machine the constants describe and ``residuals`` the per-tier
    relative fit error.  ``to_json``/``from_json`` read and write the
    JAX package's profile schema, so a profile carries across.

    Attributes:
      tiers: ``((tier_name, CostModel), ...)`` — e.g. "stacked".
      source: "default" | "calibrated".
      mesh_fingerprint: identity of the mesh the profile was measured
        on ("" for defaults).
      axis_tiers: ``((axis_name, tier_name), ...)`` routing mesh axes
        to tiers (axes not listed use ``default_tier``).
      default_tier: tier for unlisted axes.
      residuals: ``((tier_name, relative_rms_residual), ...)`` fit
        diagnostics from the calibration's non-negative least squares.
      schema_version: persisted-JSON schema version
        (:data:`PROFILE_SCHEMA_VERSION`).
    """

    tiers: tuple
    source: str = "default"
    mesh_fingerprint: str = ""
    axis_tiers: tuple = ()
    default_tier: str = "ici"
    residuals: tuple = ()
    schema_version: int = PROFILE_SCHEMA_VERSION

    def __post_init__(self):
        for field in ("tiers", "axis_tiers", "residuals"):
            v = getattr(self, field)
            if isinstance(v, dict):
                object.__setattr__(self, field, tuple(v.items()))

    def model(self, tier: str) -> CostModel:
        for name, cm in self.tiers:
            if name == tier:
                return cm
        raise KeyError(f"profile has no tier {tier!r}; "
                       f"known: {tuple(n for n, _ in self.tiers)}")

    def tier_for_axis(self, axis_name) -> str:
        """Tier for a mesh axis name or axis tuple.  A tuple routes to
        any member's listed NON-default tier first (the slowest link a
        collective over the tuple traverses, whatever the order), then
        to a listed default-tier mapping, then to ``default_tier``."""
        names = (axis_name,) if isinstance(axis_name, str) else \
            tuple(axis_name or ())
        routing = dict(self.axis_tiers)
        for n in names:
            tier = routing.get(n)
            if tier is not None and tier != self.default_tier:
                return tier
        for n in names:
            if n in routing:
                return routing[n]
        return self.default_tier

    def for_axis(self, axis_name) -> CostModel:
        """The pricing kernel for a mesh axis (or axis tuple — the
        slowest member's tier wins; see :meth:`tier_for_axis`)."""
        return self.model(self.tier_for_axis(axis_name))

    def fingerprint(self) -> str:
        """Stable content hash — the plan-cache and profile-store key.
        Two profiles with identical constants but different provenance
        (source/mesh) fingerprint differently."""
        import hashlib

        # gamma_pass joins the blob only when set, so profiles written
        # before the pass-aware γ term keep their recorded fingerprints
        blob = repr((self.schema_version, self.source,
                     self.mesh_fingerprint, self.axis_tiers,
                     self.default_tier,
                     tuple((n, cm.alpha, cm.beta, cm.gamma, cm.source)
                           if cm.gamma_pass == 0.0 else
                           (n, cm.alpha, cm.beta, cm.gamma,
                            cm.gamma_pass, cm.source)
                           for n, cm in self.tiers))).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def to_json(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "source": self.source,
            "mesh_fingerprint": self.mesh_fingerprint,
            "default_tier": self.default_tier,
            "axis_tiers": dict(self.axis_tiers),
            "residuals": dict(self.residuals),
            "tiers": {
                name: {"alpha": cm.alpha, "beta": cm.beta,
                       "gamma": cm.gamma, "source": cm.source,
                       **({"gamma_pass": cm.gamma_pass}
                          if cm.gamma_pass else {})}
                for name, cm in self.tiers
            },
            "fingerprint": self.fingerprint(),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "CostProfile":
        if obj.get("schema_version") != PROFILE_SCHEMA_VERSION:
            raise ValueError(
                f"cost-profile schema {obj.get('schema_version')!r} "
                f"!= supported {PROFILE_SCHEMA_VERSION}")
        return cls(
            tiers=tuple(
                (name, CostModel(alpha=t["alpha"], beta=t["beta"],
                                 gamma=t["gamma"],
                                 gamma_pass=t.get("gamma_pass", 0.0),
                                 source=t.get("source", "default")))
                for name, t in sorted(obj["tiers"].items())),
            source=obj.get("source", "default"),
            mesh_fingerprint=obj.get("mesh_fingerprint", ""),
            axis_tiers=tuple(sorted(obj.get("axis_tiers", {}).items())),
            default_tier=obj.get("default_tier", "ici"),
            residuals=tuple(sorted(obj.get("residuals", {}).items())))


_tls = threading.local()


@contextlib.contextmanager
def use_cost_model(cm):
    """Install ``cm`` as the default cost model for ``scan``/``plan``
    calls inside the context.  ``cm`` is a :class:`CostModel`, a
    :class:`CostProfile` (axes routed to tiers via its ``axis_tiers``),
    or a callable ``axis_name -> CostModel`` so multi-axis plans can
    price each sub-axis by its own interconnect tier (e.g.
    ``launch.mesh.axis_cost_model``).

    Re-entrant: contexts nest, each exit restores the previous model
    (an explicit per-thread stack, so interleaved generators that
    close out of order fail loudly instead of corrupting the state).
    """
    stack = getattr(_tls, "cm_stack", None)
    if stack is None:
        stack = _tls.cm_stack = []
    stack.append(cm)
    try:
        yield cm
    finally:
        popped = stack.pop()
        if popped is not cm:
            raise RuntimeError(
                "use_cost_model contexts exited out of order")


def current_cost_model():
    stack = getattr(_tls, "cm_stack", None)
    # use_cost_model(None) means "the defaults", not "inherit"
    return (stack[-1] if stack else None) or DEFAULT_COST_MODEL


def _resolve_cm(cm, axis_name) -> CostModel:
    if isinstance(cm, CostProfile):
        return cm.for_axis(axis_name)
    resolved = cm(axis_name) if callable(cm) else cm
    if isinstance(resolved, CostProfile):
        resolved = resolved.for_axis(axis_name)
    return resolved


# ---------------------------------------------------------------------------
# Algorithm registry
# ---------------------------------------------------------------------------


# The planner only considers power-of-two segment counts (exact byte
# prediction for power-of-two payloads, bounded padding) up to this
# cap.  Since the rolled round-table executor the traced ring is O(1)
# in S, so the cap only bounds padding slack and pipeline fill cost.
MAX_SEGMENTS = 64


@dataclasses.dataclass(frozen=True)
class ScanAlgorithm:
    """A registered scan algorithm: a schedule builder plus metadata.

    ``build(p)`` (or ``build(p, segments)`` when ``segmentable``)
    returns the :class:`~repro_torch.core.schedule.Schedule` the executors
    run.  Rounds / ⊕ / all-gather predictions are *counted off that
    IR*, so plans match ``collect_stats()`` measurements by
    construction (tests still enforce this for p in 2..17).

    Cost-model inputs derived per (p, m, S):

      latency_hops:  rounds + (p−1)·allgathers (all-gathers are
                     ring-based on torus interconnects).
      wire_bytes:    rounds·ceil(m/S) + allgathers·p·m — the bytes
                     through each device's port; for the segmented ring
                     this IS the serialized critical path, which is how
                     pipelining earns its large-m win honestly.
    """

    name: str
    kind: str  # "exclusive" | "inclusive" | "allreduce"
    build: Callable[..., "schedule_lib.Schedule"]
    segmentable: bool = False
    # Block-distributed algorithms split payload leaves into row
    # blocks, so the monoid's ⊕ must act elementwise over aligned
    # positions (Monoid.segmentable) even though the *schedule* takes
    # no segment parameter.  "auto" skips them for non-segmentable
    # monoids (matmul); pinning one raises.
    requires_segmentable: bool = False

    def schedule(self, p: int,
                 segments: int = 1) -> "schedule_lib.Schedule":
        return _build_cached(self, int(p), int(segments))


@functools.lru_cache(maxsize=4096)
def _build_cached(algo: ScanAlgorithm, p: int, segments: int):
    if algo.segmentable:
        return algo.build(p, segments)
    if segments != 1:
        raise ValueError(
            f"algorithm {algo.name!r} does not support segmentation")
    return algo.build(p)


_REGISTRY: dict[tuple[str, str], ScanAlgorithm] = {}

KINDS = ("exclusive", "inclusive", "allreduce", "scan_total")


def register_algorithm(name: str, *, kind: str,
                       segmentable: bool = False,
                       requires_segmentable: bool = False):
    """Decorator registering a schedule builder as a scan algorithm.

    Usage (collectives.py)::

        register_algorithm("123", kind="exclusive")(schedule.build_123)
        register_algorithm("ring", kind="exclusive",
                           segmentable=True)(schedule.build_ring)

    ``segmentable`` builders take ``(p, segments)`` and must honour the
    p−2+S pipelined round structure the planner prices.
    """
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")

    def deco(build):
        key = (kind, name)
        if key in _REGISTRY:
            raise ValueError(f"algorithm {name!r} already registered "
                             f"for kind {kind!r}")
        _REGISTRY[key] = ScanAlgorithm(
            name=name, kind=kind, build=build, segmentable=segmentable,
            requires_segmentable=requires_segmentable)
        return build

    return deco


def _ensure_registered():
    # Implementations live in collectives.py and register on import;
    # imported lazily here to avoid a module cycle.
    if not _REGISTRY:
        from repro_torch.core import collectives  # noqa: F401


def algorithms(kind: str | None = None) -> tuple[str, ...]:
    """Registered algorithm names (optionally for one kind)."""
    _ensure_registered()
    return tuple(sorted(n for k, n in _REGISTRY
                        if kind is None or k == kind))


def get_algorithm(kind: str, name: str) -> ScanAlgorithm:
    _ensure_registered()
    try:
        return _REGISTRY[(kind, name)]
    except KeyError:
        raise ValueError(
            f"unknown {kind} scan algorithm {name!r}; "
            f"known: {algorithms(kind)}") from None


# ---------------------------------------------------------------------------
# ScanSpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScanSpec:
    """Declarative description of a scan collective.

    Attributes:
      kind: "exclusive" | "inclusive" | "allreduce" | "scan_total"
        (the last fuses an exclusive scan with an allreduce of the
        same payload and yields ``(prefix, total)``).
      monoid: a :class:`repro_torch.core.monoid.Monoid` or registry name.
      algorithm: a registered algorithm name, or "auto" to let the
        planner pick by cost model.
      axis_name: mesh axis name, or tuple of names major→minor (ranks
        row-major over the tuple).  May be None for pure planning math.
      payload_bytes: per-rank message size hint m, used by ``plan``
        when no concrete operand is available yet.
      segments: pin the payload segment count S of segmentable
        algorithms (the pipelined ring); None lets the planner pick S
        from the α/β trade-off.  Non-segmentable algorithms and monoids
        always run S=1.
    """

    kind: str = "exclusive"
    monoid: Any = "add"
    algorithm: str = "auto"
    axis_name: Any = None
    payload_bytes: int | None = None
    segments: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if isinstance(self.axis_name, list):
            object.__setattr__(self, "axis_name", tuple(self.axis_name))

    @property
    def axes(self) -> tuple:
        """Axis names as a tuple (a single placeholder if unset)."""
        if self.axis_name is None:
            return (None,)
        if isinstance(self.axis_name, tuple):
            return self.axis_name
        return (self.axis_name,)

    def over(self, axis_name, **replacements) -> "ScanSpec":
        """This spec re-targeted at ``axis_name`` (e.g. per call site),
        with optional field overrides: ``spec.over("data",
        monoid="affine")``."""
        if isinstance(axis_name, list):
            axis_name = tuple(axis_name)
        return dataclasses.replace(self, axis_name=axis_name,
                                   **replacements)


# ---------------------------------------------------------------------------
# ScanPlan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """A resolved scan: algorithm choice + predicted costs, pre-tracing.

    ``rounds``/``op_applications``/``allgathers`` predict exactly what
    ``collectives.collect_stats()`` measures when the plan is executed.
    ``bytes_on_wire`` is the total bytes through each device's port for
    the planned payload (for the segmented ring: rounds·ceil(m/S), the
    pipelined serialization).  ``segments`` is the planner-chosen (or
    spec-pinned) payload segment count S.  ``kernel_passes`` is the
    fused-path HBM-pass budget of the schedule's round kernels
    (``Schedule.kernel_passes``) — what the fused ``StackedExecutor``
    records in ``collect_stats()``; a cost model with nonzero
    ``gamma_pass`` prices it.  Multi-axis plans report a
    ``composite(inner+allreduce+outer)`` algorithm label and keep
    their ``sub_plans`` (inner exscan, minor-axis allreduce, outer
    exscan) as inspectable provenance — ``schedule()`` inlines them
    into ONE axis-annotated schedule (``schedule_lib.compose``), plus
    one combining ⊕.

    A plan is executable: ``schedule()`` returns the round-by-round IR,
    ``execute(x)`` runs it (default: the stacked executor on the CUDA
    card; ``executor=StackedExecutor("cpu")`` or the unfused baseline
    on request).
    """

    spec: ScanSpec
    p: int  # total ranks (product over axes)
    algorithm: str  # resolved (never "auto")
    payload_bytes: int
    rounds: int
    op_applications: int
    allgathers: int
    bytes_on_wire: float
    cost: float  # cost-model seconds estimate
    cost_model: CostModel
    segments: int = 1
    sub_plans: tuple = ()
    kernel_passes: int = 0
    # Exact γ-term byte laws off the schedule IR (Σ over ⊕-steps /
    # HBM passes of the bytes each one touches); -1 falls back to the
    # uniform ops·⌈m/S⌉ product, which they equal for every uniform
    # (non-block) schedule.
    op_bytes: float = -1.0
    pass_bytes: float = -1.0

    def schedule(self) -> "schedule_lib.Schedule":
        """The executable round-by-round IR of this plan (cached).

        Multi-axis plans compose their sub-plans' schedules into one
        axis-annotated schedule (``schedule_lib.compose``)."""
        if self.sub_plans:
            axes = self.spec.axes
            outer = self.sub_plans[-1]
            outer_axis = None if outer.sub_plans else outer.spec.axes[-1]
            if self.spec.kind == "scan_total":
                inner, outer = self.sub_plans
                return schedule_lib.compose_total(
                    inner.schedule(), outer.schedule(),
                    minor_axis=axes[-1], outer_axis=outer_axis)
            inner, reduce_, outer = self.sub_plans
            return schedule_lib.compose(
                inner.schedule(), reduce_.schedule(), outer.schedule(),
                minor_axis=axes[-1], outer_axis=outer_axis)
        return get_algorithm(self.spec.kind, self.algorithm).schedule(
            self.p, self.segments)

    def execute(self, x, *, executor=None):
        """Run this plan on payload tree ``x`` (leaves (p, ...), the
        ranks stacked on the leading axis).  The default executor is
        ``StackedExecutor()`` on the CUDA card; pass
        ``StackedExecutor("cpu")`` to run on the CPU."""
        m = monoid_lib.get(self.spec.monoid)
        return _run_plan(self, x, m, executor)

    def describe(self) -> str:
        """Human-readable one-liner (benchmarks print these)."""
        seg = f" S={self.segments}" if self.segments != 1 else ""
        head = (f"{self.spec.kind} scan over p={self.p} "
                f"[{self.algorithm}{seg}] rounds={self.rounds} "
                f"ops={self.op_applications} "
                f"allgathers={self.allgathers} "
                f"wire={self.bytes_on_wire:.0f}B "
                f"cost={self.cost * 1e6:.2f}us")
        for sp in self.sub_plans:
            head += "\n  " + sp.describe().replace("\n", "\n  ")
        return head

    @property
    def cost_model_source(self) -> str:
        """Provenance of the constants that priced this plan:
        "default" (hand-guessed) or "calibrated" (fitted from measured
        schedule timings)."""
        return self.cost_model.source

    def _cost_parts(self) -> dict:
        _, op_cost = _monoid_name_and_cost(self.spec.monoid)
        seg_bytes = -(-self.payload_bytes // self.segments) \
            if self.payload_bytes else 0
        return self.cost_model.parts(
            hops=self.rounds + (self.p - 1) * self.allgathers,
            serial_bytes=self.bytes_on_wire, ops=self.op_applications,
            payload_bytes=seg_bytes, op_cost=op_cost,
            passes=self.kernel_passes, op_bytes=self.op_bytes,
            pass_bytes=self.pass_bytes)

    def explain(self) -> tuple:
        """The runner-up table: every candidate algorithm's predicted
        cost under this plan's cost model, and why each loser lost.

        Returns a tuple of dicts (cheapest first), one per candidate
        algorithm at its best segment count, with the winner marked
        ``chosen=True``.  ``why`` names the dominant α/β/γ component of
        the loser's cost excess over the chosen plan (or notes that the
        spec pinned the choice).  Composite (multi-axis) plans return
        the concatenation of their sub-plans' tables, each row tagged
        with its axis.
        """
        if self.sub_plans:
            return tuple(row for sp in self.sub_plans
                         for row in sp.explain())
        free = dataclasses.replace(self.spec, algorithm="auto",
                                   segments=None)
        best: dict[str, ScanPlan] = {}
        for cand in _candidate_plans(free, self.p, self.payload_bytes,
                                     self.cost_model):
            cur = best.get(cand.algorithm)
            if cur is None or (cand.cost, cand.rounds, cand.segments) \
                    < (cur.cost, cur.rounds, cur.segments):
                best[cand.algorithm] = cand
        best[self.algorithm] = self  # the resolved plan speaks for itself
        chosen_parts = self._cost_parts()
        pinned = self.spec.algorithm != "auto"
        rows = []
        order = sorted(best.values(),
                       key=lambda pl: (pl.cost, pl.rounds, pl.algorithm))
        cheapest = order[0]
        for cand in order:
            parts = cand._cost_parts()
            if cand.algorithm == self.algorithm:
                why = ("pinned by spec" if pinned
                       else "chosen: minimum α·hops+β·bytes+γ·⊕ cost")
                if pinned and cand is not cheapest:
                    why += (f" (auto would pick {cheapest.algorithm}, "
                            f"{(self.cost - cheapest.cost) * 1e6:.3g}us "
                            f"cheaper)")
            else:
                excess = {k: parts[k] - chosen_parts[k] for k in parts}
                delta = cand.cost - self.cost
                if delta >= 0:
                    dom = max(excess, key=lambda k: excess[k])
                    why = (f"+{delta * 1e6:.3g}us vs "
                           f"{self.algorithm}, dominated by {dom} "
                           f"(+{excess[dom] * 1e6:.3g}us)")
                else:
                    # only reachable under a pinned spec: the pin kept
                    # a cheaper candidate from winning
                    dom = min(excess, key=lambda k: excess[k])
                    why = (f"{-delta * 1e6:.3g}us cheaper than pinned "
                           f"{self.algorithm}, led by {dom} "
                           f"({excess[dom] * 1e6:.3g}us)")
            rows.append({
                "axis": self.spec.axes[-1],
                "algorithm": cand.algorithm,
                "segments": cand.segments,
                "rounds": cand.rounds,
                "op_applications": cand.op_applications,
                "allgathers": cand.allgathers,
                "bytes_on_wire": cand.bytes_on_wire,
                "kernel_passes": cand.kernel_passes,
                "cost": cand.cost,
                "cost_alpha": parts["alpha"],
                "cost_beta": parts["beta"],
                "cost_gamma": parts["gamma"],
                "chosen": cand.algorithm == self.algorithm,
                "why": why,
            })
        return tuple(rows)


def _monoid_name_and_cost(monoid) -> tuple[str, float]:
    m = monoid_lib.get(monoid)
    return m.name, getattr(m, "op_cost", 1.0)


def _candidate_plans(spec: ScanSpec, p: int, nbytes: int,
                     cm: CostModel) -> list[ScanPlan]:
    """Every (algorithm, segment-count) candidate for one axis, priced.

    For segmentable algorithms (the pipelined ring) the segment count S
    is part of the optimization: candidates are power-of-two S up to
    ``MAX_SEGMENTS`` (and no finer than one byte per segment), each
    priced at α·(p−2+S) + β·(p−2+S)·⌈m/S⌉ + γ·ops·⌈m/S⌉ — the α/β
    trade-off of the paper's large-m pipelining citation.
    """
    _, op_cost = _monoid_name_and_cost(spec.monoid)
    mono = monoid_lib.get(spec.monoid)

    def one(algo: ScanAlgorithm, S: int) -> ScanPlan:
        sched = algo.schedule(p, S)
        rounds = sched.rounds
        # monoid-aware: commutative monoids elide the redundant
        # combine order in butterfly exchange (2→1) and scan_reduce
        # (3→2) rounds — the executors apply the same elision, so
        # the prediction still equals collect_stats() measurement
        ops = sched.op_count(mono.commutative)
        ag = sched.allgathers
        seg_bytes = -(-nbytes // S) if nbytes else 0
        # per-step byte laws off the IR: for uniform
        # schedules these reduce to rounds·⌈m/S⌉ / ops·⌈m/S⌉ exactly;
        # block-distributed schedules shrink per-round payloads, which
        # is where their 2·(p−1)/p·m wire total comes from
        wire = (schedule_lib.wire_bytes(sched, nbytes)
                + ag * p * nbytes)
        op_bytes = schedule_lib.op_wire_bytes(sched, nbytes,
                                              mono.commutative)
        passes = sched.kernel_passes(mono.commutative)
        pass_bytes = schedule_lib.pass_wire_bytes(sched, nbytes,
                                                  mono.commutative)
        return ScanPlan(
            spec=spec, p=p, algorithm=algo.name, payload_bytes=nbytes,
            rounds=rounds, op_applications=ops, allgathers=ag,
            bytes_on_wire=wire,
            cost=cm.cost(hops=rounds + (p - 1) * ag,
                         serial_bytes=wire, ops=ops,
                         payload_bytes=seg_bytes, op_cost=op_cost,
                         passes=passes, op_bytes=op_bytes,
                         pass_bytes=pass_bytes),
            cost_model=cm, segments=S, kernel_passes=passes,
            op_bytes=op_bytes, pass_bytes=pass_bytes)

    def candidates(algo: ScanAlgorithm) -> list[ScanPlan]:
        if algo.requires_segmentable and not mono.segmentable:
            if spec.algorithm != "auto":
                raise ValueError(
                    f"algorithm {algo.name!r} splits the payload into "
                    f"row blocks and requires a segmentable monoid; "
                    f"monoid {mono.name!r} is not")
            return []
        if not (algo.segmentable and mono.segmentable):
            if spec.segments not in (None, 1) and spec.algorithm != "auto":
                raise ValueError(
                    f"algorithm {algo.name!r} (monoid "
                    f"{mono.name!r}) does not support segmentation; "
                    f"got segments={spec.segments}")
            return [one(algo, 1)]
        if spec.segments is not None:
            # pins are honoured verbatim; an S beyond the payload's
            # element count degenerates to 1-element segments (measured
            # bytes exceed the ceil(m/S) prediction)
            return [one(algo, max(1, int(spec.segments)))]
        # segments cannot be finer than one element; the planner only
        # knows bytes, so cap S at nbytes/8 (the largest itemsize) to
        # keep the predicted ceil(m/S) above the achievable floor
        ss, s = [], 1
        while s <= min(MAX_SEGMENTS, max(1, nbytes // 8)):
            ss.append(s)
            s *= 2
        return [one(algo, s) for s in ss]

    _ensure_registered()
    if spec.algorithm != "auto":
        algos = [get_algorithm(spec.kind, spec.algorithm)]
    else:
        algos = [a for (k, _), a in sorted(_REGISTRY.items())
                 if k == spec.kind]
        if not algos:
            raise ValueError(f"no algorithms registered for {spec.kind!r}")
    return [pl for a in algos for pl in candidates(a)]


def _plan_single(spec: ScanSpec, p: int, nbytes: int,
                 cm: CostModel) -> ScanPlan:
    """Plan one axis: resolve "auto" by cost, fill predicted counts."""
    # deterministic tie-break: cost, then rounds, name, fewest segments
    plans = _candidate_plans(spec, p, nbytes, cm)
    return min(plans, key=lambda pl: (pl.cost, pl.rounds, pl.algorithm,
                                      pl.segments))


PLAN_CACHE_MAXSIZE = 1024


def _plan_impl(spec: ScanSpec, ps: tuple, nbytes: int,
               cms: tuple) -> ScanPlan:
    """Memoized planning, keyed by *resolved* per-axis cost models.

    ``cms`` is one :class:`CostModel` per axis of ``spec.axes`` — the
    caller (:func:`plan`) resolves callables/profiles *before* the
    cache lookup, so the key is the pricing constants themselves (a
    value fingerprint), never a resolver's object identity.  Per-call
    closures that resolve to the same constants hit the cache, and
    installing a recalibrated profile changes the key, invalidating
    every stale plan at once."""
    if len(ps) == 1:
        return _plan_single(spec, ps[0], nbytes, cms[0])
    # Multi-axis rewrite: exscan within the minor axis,
    # allreduce of the minor-axis total, exscan of totals over the
    # major axes, then one ⊕ combining outer and inner.  The top-level
    # algorithm is the honest composite label, never the inner's name;
    # schedule() inlines the sub-plans into one composed schedule.
    if spec.kind not in ("exclusive", "scan_total"):
        raise ValueError(
            f"multi-axis scan only supports kind 'exclusive' or "
            f"'scan_total', got {spec.kind!r}")
    _, op_cost = _monoid_name_and_cost(spec.monoid)
    axes = spec.axes
    inner = _plan_cached(
        spec.over(axes[-1]), (ps[-1],), nbytes, cms[-1:])
    outer = _plan_cached(
        spec.over(axes[:-1] if len(axes) > 2 else axes[0]),
        ps[:-1], nbytes, cms[:-1])
    if spec.kind == "scan_total":
        # the inner scan_total's total IS the minor-axis allreduce:
        # no separate reduce stage (schedule_lib.compose_total)
        subs = (inner, outer)
        label = f"composite({inner.algorithm}+{outer.algorithm})"
    else:
        reduce_ = _plan_cached(
            spec.over(axes[-1], kind="allreduce", algorithm="auto"),
            (ps[-1],), nbytes, cms[-1:])
        subs = (inner, reduce_, outer)
        label = (f"composite({inner.algorithm}+{reduce_.algorithm}"
                 f"+{outer.algorithm})")
    cm_top = cms[-1]  # final ⊕ is local compute
    return ScanPlan(
        spec=spec, p=int(np.prod(ps)),
        algorithm=label, payload_bytes=nbytes,
        rounds=sum(s.rounds for s in subs),
        op_applications=sum(s.op_applications for s in subs) + 1,
        allgathers=sum(s.allgathers for s in subs),
        bytes_on_wire=sum(s.bytes_on_wire for s in subs),
        cost=sum(s.cost for s in subs) + cm_top.gamma * nbytes * op_cost,
        cost_model=cm_top, sub_plans=subs,
        kernel_passes=sum(s.kernel_passes for s in subs),
        op_bytes=(sum(s.op_bytes for s in subs)
                  if all(s.op_bytes >= 0 for s in subs) else -1.0),
        pass_bytes=(sum(s.pass_bytes for s in subs)
                    if all(s.pass_bytes >= 0 for s in subs) else -1.0))


# functools.lru_cache counts a miss even when the wrapped call raises
# (no entry is stored), so eviction accounting needs the error misses
# tracked separately: evictions = misses - error_misses - currsize.
_plan_error_misses = 0


def _plan_counted(spec: ScanSpec, ps: tuple, nbytes: int,
                  cms: tuple) -> ScanPlan:
    global _plan_error_misses
    try:
        return _plan_impl(spec, ps, nbytes, cms)
    except BaseException:
        _plan_error_misses += 1
        raise


_plan_cached = functools.lru_cache(maxsize=PLAN_CACHE_MAXSIZE)(
    _plan_counted)


def plan(spec: ScanSpec, p: int | tuple | None = None, *,
         nbytes: int | None = None,
         cost_model=None) -> ScanPlan:
    """Resolve ``spec`` into an inspectable :class:`ScanPlan`.

    Args:
      spec: what to compute.
      p: axis size, or tuple of sizes matching ``spec.axes`` for a
        multi-axis scan (major→minor).
      nbytes: per-rank payload size in bytes (falls back to
        ``spec.payload_bytes``, then 0 — a pure round-count plan).
      cost_model: overrides the ambient :func:`current_cost_model`; a
        :class:`CostModel`, a :class:`CostProfile`, or a per-axis
        ``axis_name -> CostModel`` callable.

    Plans are cached by (spec, axis sizes, payload bytes, *resolved*
    per-axis pricing constants): callables/profiles are resolved to one
    :class:`CostModel` per axis before the lookup, so equal constants
    hit the cache regardless of resolver identity, and installing a
    recalibrated profile invalidates stale plans by changing the key.
    Repeated calls with the same signature return the same object.
    """
    if p is None:
        raise ValueError("plan() needs the axis size(s) p")
    ps = tuple(p) if isinstance(p, (tuple, list)) else (int(p),)
    if len(ps) != len(spec.axes):
        raise ValueError(
            f"got {len(ps)} axis sizes for {len(spec.axes)} axes "
            f"({spec.axes})")
    m_bytes = nbytes if nbytes is not None else (spec.payload_bytes or 0)
    cm = cost_model if cost_model is not None else current_cost_model()
    cms = tuple(_resolve_cm(cm, a) for a in spec.axes)
    for a, resolved in zip(spec.axes, cms):
        if not isinstance(resolved, CostModel):
            raise TypeError(
                f"cost model for axis {a!r} resolved to "
                f"{type(resolved).__name__}, expected CostModel")
    return _plan_cached(spec, ps, int(m_bytes), cms)


def plan_hierarchical(spec: ScanSpec, *, p_inter: int, p_intra: int,
                      nbytes: int | None = None, cost_model=None,
                      inter_axis: str = "proc",
                      intra_axis: str = "local") -> ScanPlan:
    """Two-level hierarchical planning: factor p = p_inter × p_intra.

    ``p_intra`` ranks live inside each of ``p_inter`` processes or
    hosts.  This re-targets ``spec`` at the ``(inter_axis, intra_axis)``
    pair — the multi-axis rewrite composes intra exscan + bridging
    reduce + inter exscan into ONE axis-annotated schedule — and, when
    the pricing profile has a "dci" tier (as a profile carried across
    from the JAX package does), routes ``inter_axis`` to it, so each
    tier's algorithm is chosen by its own cost model.  ``cost_model``
    defaults to the installed launch-layer profile; the port's own
    default has one tier, which prices both axes alike.  Planning
    only: composed schedules do not execute on one card yet.
    """
    if p_inter < 1 or p_intra < 1:
        raise ValueError(f"need p_inter >= 1 and p_intra >= 1, got "
                         f"{p_inter}/{p_intra}")
    cm = cost_model
    if cm is None:
        cm = current_cost_model()
        if cm is DEFAULT_COST_MODEL:
            # nothing installed: the launch layer's tiered profile is
            # the only default that can tell the two tiers apart
            from repro_torch.launch import mesh as mesh_lib  # lazy: no cycle

            cm = mesh_lib.current_profile()
    if isinstance(cm, CostProfile):
        tier_names = tuple(n for n, _ in cm.tiers)
        if ("dci" in tier_names
                and inter_axis not in dict(cm.axis_tiers)):
            cm = dataclasses.replace(
                cm, axis_tiers=cm.axis_tiers + ((inter_axis, "dci"),))
    return plan(spec.over((inter_axis, intra_axis)),
                (int(p_inter), int(p_intra)), nbytes=nbytes,
                cost_model=cm)


def plan_cache_clear():
    global _plan_error_misses
    _plan_cached.cache_clear()
    _plan_error_misses = 0


def plan_cache_resize(maxsize: int = PLAN_CACHE_MAXSIZE) -> int:
    """Rebuild the plan cache with a new LRU capacity (entries are
    dropped).  The cache is *always* bounded — least-recently-used
    plans are evicted at capacity — so a long-running service cannot
    grow it without bound; services that want a tighter ceiling than
    :data:`PLAN_CACHE_MAXSIZE` (or a larger one for a big declared
    bucket set) install it here before warmup.

    Returns the number of cached entries dropped by the rebuild, which
    is how the autotune controller reports how many stale plans a
    profile install flushed (calling with the current maxsize is the
    idiomatic "drop everything now" — distinct from LRU pressure,
    which ``plan_cache_info()['evictions']`` counts)."""
    global _plan_cached, _plan_error_misses
    if maxsize is not None and maxsize < 1:
        raise ValueError(f"plan cache maxsize must be >= 1, "
                         f"got {maxsize}")
    dropped = _plan_cached.cache_info().currsize
    _plan_cached = functools.lru_cache(maxsize=maxsize)(_plan_counted)
    _plan_error_misses = 0
    return dropped


def plan_cache_info() -> dict:
    """Plan-cache observability: hit/miss counters plus size of the
    memoized ``plan()`` resolution (printed by ``benchmarks/plan_table
    .py --verbose``; the serve subsystem's warmup gate reads the miss
    counter to prove steady state never compiles).  Repeated ``plan()``
    calls with the same (spec, axis sizes, payload bytes, cost model)
    signature are cache hits; ``size`` never exceeds ``maxsize``.

    ``evictions`` counts entries LRU-dropped under capacity pressure
    in the current cache generation (a miss that raised stores no
    entry and is excluded).  ``plan_cache_resize`` starts a fresh
    generation — its *return value* accounts for the dropped entries,
    so drift-invalidation flushes never masquerade as LRU pressure."""
    info = _plan_cached.cache_info()
    evictions = max(0, info.misses - _plan_error_misses - info.currsize)
    return {"hits": info.hits, "misses": info.misses,
            "size": info.currsize, "maxsize": info.maxsize,
            "evictions": evictions}


# ---------------------------------------------------------------------------
# scan(): execute a spec over a rank-stacked payload
# ---------------------------------------------------------------------------


def _rank_count(tree) -> int:
    leaves = _tree.leaves(tree)
    if not leaves:
        raise ValueError("scan payload has no leaves")
    return int(leaves[0].shape[0])


def _tree_nbytes(tree) -> int:
    """Bytes of one rank's part of a rank-stacked payload (the
    planner's per-rank message size m)."""
    total = 0
    for x in _tree.leaves(tree):
        itemsize = getattr(x, "itemsize", None) or x.dtype.itemsize
        total += int(np.prod(x.shape[1:])) * int(itemsize)
    return total


def _single_axis(spec: ScanSpec):
    if len(spec.axes) > 1:
        raise NotImplementedError(
            "executing multi-axis scans on one card is not ported yet; "
            "plan them with plan() / plan_hierarchical()")


def _run_plan(pl: ScanPlan, x, m: monoid_lib.Monoid, executor=None):
    if executor is None:
        executor = schedule_lib.StackedExecutor()
    return executor.execute(pl.schedule(), x, m)


def scan(x, spec: ScanSpec, *, cost_model=None, executor=None):
    """Execute ``spec`` on payload tree ``x`` whose leaves carry the p
    ranks on their leading axis.  Plans first, with p and the per-rank
    payload size taken from ``x``, so ``algorithm="auto"`` adapts to
    the actual message size (the ring's segment count included).
    ``executor`` defaults to ``StackedExecutor()`` on the card."""
    _ensure_registered()
    _single_axis(spec)
    m = monoid_lib.get(spec.monoid)
    pl = plan(spec, _rank_count(x), nbytes=_tree_nbytes(x),
              cost_model=cost_model)
    return _run_plan(pl, x, m, executor)


def scan_with_total(x, spec: ScanSpec, *, cost_model=None,
                    executor=None):
    """Fused exclusive scan + allreduce of the same payload: returns
    ``(prefix, total)`` from ONE "scan_total" schedule.  For
    power-of-two p the fused (prefix, total) butterfly computes both in
    the allreduce's ⌈log₂p⌉ rounds; otherwise the exscan's last rank
    completes the total with one local ⊕ and broadcasts it.  Pinned
    exclusive algorithm names carry over."""
    if spec.kind not in ("exclusive", "scan_total"):
        raise ValueError(
            f"scan_with_total fuses exclusive scans, got kind="
            f"{spec.kind!r}")
    _ensure_registered()
    algo = spec.algorithm
    if algo != "auto":
        get_algorithm("scan_total", algo)
    return scan(x, spec.over(spec.axis_name, kind="scan_total",
                             algorithm=algo),
                cost_model=cost_model, executor=executor)


# ---------------------------------------------------------------------------
# Fusing k concurrent small scans into shared rounds
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """The planner's fuse-or-not decision for k concurrent scans.

    ``plans`` are the k serial plans (one per payload), ``packed`` the
    single-plan candidate priced at the packed payload size, ``fused``
    whether packing won: the α saving of riding one schedule's rounds
    must beat the β cost of the packed payload under the ambient cost
    model.  ``rounds``/``cost`` reflect the chosen execution.
    """

    plans: tuple[ScanPlan, ...]
    packed: ScanPlan
    fused: bool

    @property
    def rounds(self) -> int:
        return self.packed.rounds if self.fused else \
            sum(pl.rounds for pl in self.plans)

    @property
    def cost(self) -> float:
        return self.packed.cost if self.fused else \
            sum(pl.cost for pl in self.plans)

    def describe(self) -> str:
        serial = sum(pl.rounds for pl in self.plans)
        head = (f"fused_scan k={len(self.plans)} p={self.packed.p} "
                f"[{'fused' if self.fused else 'serial'}] "
                f"rounds={self.rounds} (serial={serial}) "
                f"cost={self.cost * 1e6:.2f}us")
        return head

    def schedule(self, layout) -> "schedule_lib.Schedule":
        """The fused schedule carrying ``layout`` (raises when the
        decision was serial)."""
        if not self.fused:
            raise ValueError("plan decided against fusing; execute "
                             "the serial plans instead")
        return schedule_lib.fuse([self.packed.schedule()], layout)

    def execute(self, xs, *, executor=None):
        """Run the k scans on payloads ``xs`` (same order as the
        plans), fused or serial per the decision.  Returns the list of
        k results."""
        m = monoid_lib.get(self.plans[0].spec.monoid)
        if not self.fused:
            return [_run_plan(pl, x, m, executor)
                    for pl, x in zip(self.plans, xs)]
        layout = schedule_lib.make_layout(xs, lead=1)
        if executor is None:
            executor = schedule_lib.StackedExecutor()
        return list(executor.execute(self.schedule(layout), xs, m))

    def verify(self, *, rank_elems: int = 3, seed: int = 0) -> dict:
        """Drift check on the CPU: the fused execution must reproduce k
        independent sequential references while measuring exactly the
        packed plan's rounds/⊕/all-gathers (one scan's rounds, not k×).
        """
        m = monoid_lib.get(self.plans[0].spec.monoid)
        p = self.packed.p
        xs = [device_lib.to_torch(schedule_lib._witness_payload(
            m.name, p, rank_elems + i, seed + i), "cpu")
            for i in range(len(self.plans))]
        with schedule_lib.collect_stats() as st:
            got = self.execute(
                xs, executor=schedule_lib.StackedExecutor("cpu"))
        ok_vals = all(
            schedule_lib._close(g, schedule_lib._host_reference(
                self.plans[0].spec.kind, x, m, p))
            for g, x in zip(got, xs))
        want_plan = self.packed if self.fused else None
        res = {
            "k": len(self.plans), "p": p, "fused": self.fused,
            "rounds_predicted": self.rounds,
            "rounds_measured": st.rounds,
            "correct": bool(ok_vals),
        }
        if want_plan is not None:
            res.update(
                ops_predicted=want_plan.op_applications,
                ops_measured=st.op_applications,
                allgathers_predicted=want_plan.allgathers,
                allgathers_measured=st.allgathers)
            res["ok"] = bool(
                ok_vals
                and st.rounds == want_plan.rounds
                and st.op_applications == want_plan.op_applications
                and st.allgathers == want_plan.allgathers)
        else:
            res["ok"] = bool(ok_vals and st.rounds == self.rounds)
        return res


def plan_fused(specs, p, nbytes_list, *, cost_model=None) -> FusedPlan:
    """Price k concurrent scans fused vs serial (the tentpole's α/β
    trade-off): the packed candidate pays one schedule's α·q but moves
    the concatenated payload every round; each serial plan optimizes
    its own payload.  Fusion requires one (kind, axis, monoid)
    signature, a single algorithm choice, and a monoid whose ⊕ acts on
    aligned element positions independently (``Monoid.segmentable`` —
    packing concatenates flattened leaves)."""
    specs = list(specs)
    if not specs:
        raise ValueError("plan_fused needs at least one spec")
    s0 = specs[0]
    mono = monoid_lib.get(s0.monoid)
    fusable = mono.segmentable
    for s in specs[1:]:
        if (s.kind, s.axis_name) != (s0.kind, s0.axis_name):
            raise ValueError(
                "fused scans must share kind and axis; got "
                f"{(s.kind, s.axis_name)} vs {(s0.kind, s0.axis_name)}")
        if monoid_lib.get(s.monoid).name != mono.name:
            raise ValueError("fused scans must share one monoid")
        if s.algorithm != s0.algorithm:
            fusable = False  # conflicting pins: run serially
    nbytes_list = [int(nb) for nb in nbytes_list]
    if len(nbytes_list) != len(specs):
        raise ValueError("one payload size per spec required")
    cm = cost_model or current_cost_model()
    serial = tuple(plan(s, p, nbytes=nb, cost_model=cm)
                   for s, nb in zip(specs, nbytes_list))
    packed = plan(s0, p, nbytes=sum(nbytes_list), cost_model=cm)
    fused = bool(fusable and len(specs) > 1
                 and packed.cost < sum(pl.cost for pl in serial))
    return FusedPlan(plans=serial, packed=packed, fused=fused)


def fused_scan(pairs, *, cost_model=None, executor=None):
    """Execute k concurrent scans, fused into shared rounds when the
    cost model approves: ``fused_scan([(x1, spec1), (x2, spec2), ...])``
    returns the list of k results.

    k small same-axis exscans issued per step (MoE dispatch counts,
    compression offsets) pay k·α·q serially; packed into one flattened
    payload (:class:`~repro_torch.core.schedule.PayloadLayout`) they ride
    a single schedule's q rounds.  The decision is :func:`plan_fused`'s.
    Every payload carries the p ranks on its leading axis.
    """
    pairs = list(pairs)
    if not pairs:
        return []
    xs = [x for x, _ in pairs]
    specs = [s for _, s in pairs]
    _ensure_registered()
    _single_axis(specs[0])
    fp = plan_fused(specs, _rank_count(xs[0]),
                    [_tree_nbytes(x) for x in xs],
                    cost_model=cost_model)
    return fp.execute(xs, executor=executor)
