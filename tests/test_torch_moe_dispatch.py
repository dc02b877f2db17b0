"""MoE dispatch accounting, the serve workload generators and the ported
configs against the JAX package, on the CPU.

``dispatch_slots`` is held bit for bit (integers) against the pieces
the JAX layer runs: ``kernels.ops.moe_routing`` per rank (interpret
mode), the fused scan_total of the counts through
``plan(...).execute(x, executor=SimulatorExecutor())``, and the
keep/slot formula of ``models/moe.py``.  The workload generators must
give the JAX package's integers for the same seed, and each ported
config must equal its JAX twin field by field.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import scan_api as rsa
from repro.core import schedule as rsch
from repro.kernels import ops as rops
from repro.models import params as rparams
from repro.serve import workloads as rwl
from repro_torch import configs as tconfigs
from repro_torch.core.scan_api import ScanSpec
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.serve import workloads as twl


def _top_e(p, n0, k, n_experts, seed):
    """k distinct experts in [0, n_experts) per token."""
    rng = np.random.default_rng(seed)
    keys = rng.random((p, n0, n_experts))
    return np.argsort(keys, axis=-1)[..., :k].astype(np.int32)


def _jax_dispatch(cfg, top_e, algorithm):
    """The reference: JAX routing per rank, the simulator's scan_total
    of the counts, and moe.py's keep/slot formula."""
    p, n0, k = top_e.shape
    e_pad = rparams.experts_padded(cfg)
    pos, counts = zip(*(rops.moe_routing(jnp.asarray(top_e[r]), e_pad,
                                         interpret=True) for r in range(p)))
    pos = np.stack([np.asarray(x) for x in pos])
    counts = np.stack([np.asarray(x) for x in counts]).astype(np.int32)
    if p > 1:
        spec = rsa.ScanSpec(kind="scan_total", monoid="add",
                            algorithm=algorithm)
        pl = rsa.plan(spec, p, nbytes=4 * e_pad)
        offsets, totals = pl.execute(counts,
                                     executor=rsch.SimulatorExecutor())
        offsets, totals = np.asarray(offsets), np.asarray(totals)
    else:
        offsets, totals = np.zeros_like(counts), counts
    cap = max(8, int(cfg.capacity_factor * n0 * k / e_pad))
    flat_e = top_e.reshape(p, -1)
    flat_pos = pos.reshape(p, -1)
    global_pos = np.take_along_axis(offsets, flat_e, axis=1) + flat_pos
    keep = (flat_pos < cap) & (global_pos < cap * p)
    slot = np.where(keep, flat_e * cap + flat_pos, e_pad * cap)
    return pos, offsets, totals, keep, slot.astype(np.int32)


@pytest.mark.parametrize("algorithm", ["auto", "123"])
@pytest.mark.parametrize("p", [1, 2, 5, 8])
def test_dispatch_slots_bit_exact(p, algorithm):
    cfg = tconfigs.get("qwen2-moe-a2.7b")
    n0, k = 96, cfg.top_k
    top_e = _top_e(p, n0, k, cfg.n_experts, seed=p)
    spec = ScanSpec(kind="exclusive", monoid="add", algorithm=algorithm)
    got = tmoe.dispatch_slots(cfg, torch.from_numpy(top_e), spec=spec)
    want = _jax_dispatch(rconfigs.get("qwen2-moe-a2.7b"), top_e, algorithm)
    names = ("positions", "offsets", "totals", "keep", "slot")
    for name, g, w in zip(names, got, want):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_dispatch_slots_drops_past_capacity():
    """Every token on one expert: the capacity drop bites."""
    cfg = tconfigs.get_smoke("qwen2-moe-a2.7b")  # 8 experts, top-2
    p, n0, k = 4, 64, cfg.top_k
    top_e = np.zeros((p, n0, k), np.int32)
    top_e[..., 1] = 1
    pos, offsets, totals, keep, slot = tmoe.dispatch_slots(
        cfg, torch.from_numpy(top_e))
    want = _jax_dispatch(rconfigs.get_smoke("qwen2-moe-a2.7b"), top_e,
                         "auto")
    for g, w in zip((pos, offsets, totals, keep, slot), want):
        np.testing.assert_array_equal(g.numpy(), w)
    # rank 0's first cap entries per expert fill the global capacity
    # cap·p: the other ranks' offsets start past it
    cap = max(8, int(cfg.capacity_factor * n0 * k / 16))
    assert int(keep[0].sum()) == int(keep.sum()) == k * cap
    assert int((slot == 16 * cap).sum()) == p * n0 * k - k * cap


# ------------------------------ workloads ------------------------------

MOE_ARCHS = ("qwen2_moe_a2_7b", "granite_moe_3b_a800m",
             "jamba_1_5_large_398b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dispatch_payload_matches_jax(arch):
    p = 8
    got = twl.moe_dispatch_payload(tconfigs.get(arch), p,
                                   np.random.default_rng(21), device="cpu")
    want = rwl.moe_dispatch_payload(rconfigs.get(arch), p,
                                    np.random.default_rng(21))
    assert got.shape == want.shape == (p, rparams.experts_padded(
        rconfigs.get(arch)))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_moe_dispatch_payload_smoke_and_token_count():
    got = twl.moe_dispatch_payload(tconfigs.get_smoke("qwen2-moe-a2.7b"),
                                   3, np.random.default_rng(2),
                                   n_tokens=17, device="cpu")
    want = rwl.moe_dispatch_payload(rconfigs.get_smoke("qwen2-moe-a2.7b"),
                                    3, np.random.default_rng(2),
                                    n_tokens=17)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=1) == 17 * 2).all()


@pytest.mark.parametrize("thresholded", [False, True])
def test_compression_offset_payloads_match_jax(thresholded):
    sizes = (4096, 1000, 37, 3)
    kw = dict(k_fraction=0.02, thresholded=thresholded)
    got = twl.compression_offset_payloads(
        16, sizes, rng=np.random.default_rng(8), **kw)
    want = rwl.compression_offset_payloads(
        16, sizes, rng=np.random.default_rng(8), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_buckets_and_arrivals_match_jax():
    cfg = tconfigs.get("qwen2-moe-a2.7b")
    assert twl.moe_bucket(cfg).key == rwl.moe_bucket(
        rconfigs.get("qwen2-moe-a2.7b")).key
    assert twl.compression_bucket().key == rwl.compression_bucket().key
    with pytest.raises(ValueError):
        twl.moe_bucket(tconfigs.get("llama3-8b"))
    np.testing.assert_array_equal(
        twl.poisson_arrivals(np.random.default_rng(1), 50.0, 20),
        rwl.poisson_arrivals(np.random.default_rng(1), 50.0, 20))


# ------------------------------ configs ------------------------------


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                       else v)
    return out


@pytest.mark.parametrize("arch", rconfigs.ARCHITECTURES)
def test_configs_equal_jax(arch):
    for getter in ("get", "get_smoke"):
        t = getattr(tconfigs, getter)(arch)
        r = getattr(rconfigs, getter)(arch)
        assert _fields(t) == _fields(r), (arch, getter)
        assert [dataclasses.asdict(s) for s in t.pattern()] == \
            [dataclasses.asdict(s) for s in r.pattern()]
        assert t.n_repeats == r.n_repeats
        assert (t.head_dim_, t.d_inner, t.moe_d_ff) == \
            (r.head_dim_, r.d_inner, r.moe_d_ff)
        assert dataclasses.asdict(t.scan_spec) == \
            dataclasses.asdict(r.scan_spec)
        assert (tparams.experts_padded(t), tparams.dt_rank(t)) == \
            (rparams.experts_padded(r), rparams.dt_rank(r))


def test_config_registry_and_accounting():
    assert tconfigs.ARCHITECTURES == rconfigs.ARCHITECTURES
    assert tconfigs.ALIASES == rconfigs.ALIASES
    assert tconfigs.canonical("qwen2-moe-a2.7b") == "qwen2_moe_a2_7b"
    with pytest.raises(KeyError):
        tconfigs.canonical("no-such-model")
    cfg = tconfigs.get("llama3-8b", n_layers=4)
    assert cfg.n_layers == 4
    assert tparams.round_up(61, 16) == rparams.round_up(61, 16) == 64
    ref = rconfigs.get("llama3-8b", n_layers=4)
    assert (cfg.param_count(), cfg.active_param_count(),
            cfg.model_flops_per_token(128, True)) == \
        (ref.param_count(), ref.active_param_count(),
         ref.model_flops_per_token(128, True))
    legacy = tconfigs.get("llama3-8b", exscan_algorithm="123")
    with pytest.warns(DeprecationWarning):
        assert legacy.scan_spec.algorithm == "123"
    assert set(tconfigs.all_configs()) == set(rconfigs.ARCHITECTURES)
