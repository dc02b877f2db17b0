"""The RWKV6 layer of the port against the JAX package's, on the CPU.

``wkv_scan_chunked`` is one ``affine_chunk`` launch with the decay a
broadcast leaf; the reference walks 32-row chunks with a log-depth
associative scan in each.  Both are fp32 recurrences summed in other
orders, so the states are held at rtol = atol = 2e-4, the JAX package's
own tolerance for its context-parallel wkv scan
(``tests/test_context_parallel.py``); the layer's outputs, which go
through the projections and norms, at the cross-mesh tolerance of
``tests/test_models.py`` (atol 3e-4, rtol 3e-3).  The broadcast plain
version must equal the materialised one bit for bit: the card kernel
is held to the plain version bit for bit (``tests/test_torch_cuda_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import params as rparams
from repro.models.rwkv import init_rwkv_cache as ref_cache
from repro.models.rwkv import rwkv_block as ref_block
from repro.models.rwkv import wkv_scan_chunked as ref_wkv
from repro.core import scan_api as rsa
from repro.models import context_parallel as rcp
from repro_torch import configs as tconfigs
from repro_torch.benchmarks.dist_bench import REFERENCE_PROFILE
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch
from repro_torch.core.scan_api import ScanSpec
from repro_torch.kernels import scan_engine as se
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import context_parallel as tcp
from repro_torch.models import rwkv as trwkv

SCAN_TOL = 2e-4
ATOL, RTOL = 3e-4, 3e-3
ALGOS = ("auto", "123", "1doubling", "two_op")


def _wkv_inputs(B, S, H, hd, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.8, 1.0, (B, S, H, hd, 1)).astype(np.float32)
    kv = (rng.standard_normal((B, S, H, hd, hd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return w, kv, s0


@pytest.mark.parametrize("S", [64, 20, 1])
def test_wkv_scan_matches_reference(S):
    """S = 64 (two reference chunks), 20 (one short chunk), 1."""
    w, kv, s0 = _wkv_inputs(2, S, 3, 8)
    want_prev, want_fin = ref_wkv(jnp.asarray(w), jnp.asarray(kv),
                                  jnp.asarray(s0))
    before = se.affine_chunk.launches
    got_prev, got_fin = trwkv.wkv_scan_chunked(
        torch.from_numpy(w), torch.from_numpy(kv), torch.from_numpy(s0))
    assert se.affine_chunk.launches == before  # the CPU runs the plain one
    assert got_prev.shape == kv.shape and got_fin.shape == s0.shape
    np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(got_fin.numpy(), np.asarray(want_fin),
                               rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("exclusive", [False, True])
def test_broadcast_plain_equals_materialised(exclusive, dtype):
    """``affine_chunk_plain`` with a broadcast decay gives the h outputs
    of the materialised decay bit for bit, and A outputs of a's shape
    that are the materialised ones' columns."""
    g = torch.Generator().manual_seed(1)
    r = 8
    a = torch.rand((3, 11, 5), generator=g, dtype=dtype) * 0.2 + 0.9
    b = torch.randn((3, 11, 5 * r), generator=g, dtype=dtype)
    a0 = torch.rand((3, 5), generator=g, dtype=dtype) + 0.5
    h0 = torch.randn((3, 5 * r), generator=g, dtype=dtype)
    kw = dict(exclusive=exclusive, a_traj=True, a_final=True, h_final=True)
    got = se.affine_chunk_plain(a, b, a0=a0, h0=h0, **kw)
    full = se.affine_chunk_plain(a.repeat_interleave(r, 2), b,
                                 a0=a0.repeat_interleave(r, 1), h0=h0, **kw)
    assert torch.equal(got[1], full[1]) and torch.equal(got[3], full[3])
    assert got[0].shape == a.shape and got[2].shape == a0.shape
    assert torch.equal(got[0].repeat_interleave(r, 2), full[0])
    assert torch.equal(got[2].repeat_interleave(r, 1), full[2])
    # the wrapper takes the same operands on the CPU
    wrapped = se.affine_chunk(a, b, a0=a0, h0=h0, **kw)
    assert all(torch.equal(x, y) for x, y in zip(wrapped, got))


def test_broadcast_rejects_bad_shapes():
    a = torch.ones((2, 4, 3))
    with pytest.raises(ValueError, match="dividing"):
        se.affine_chunk(a, torch.ones((2, 4, 10)))
    with pytest.raises(ValueError, match="dividing"):
        se.affine_chunk(a, torch.ones((2, 5, 6)))
    with pytest.raises(ValueError, match="a0"):
        se.affine_chunk(a, torch.ones((2, 4, 6)), a0=torch.ones((2, 6)))


def _layer_params(cfg, seed=0):
    """One rwkv layer's weights at the table's shapes, all nonzero."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, d in rparams._rwkv_defs(cfg, cfg.pattern()[0]).items():
        if len(d.shape) == 2:
            v = rng.standard_normal(d.shape) / np.sqrt(d.shape[0])
        elif k.startswith("mu_"):
            v = rng.uniform(0, 1, d.shape)
        elif k.startswith("norm"):
            v = 1 + 0.1 * rng.standard_normal(d.shape)
        else:
            v = 0.5 * rng.standard_normal(d.shape)
        out[k] = v.astype(np.float32)
    return out


def _block_case(cfg, mode, seed=0):
    """(params, x, cache) for ``mode`` in full / prefill / decode."""
    rng = np.random.default_rng(seed + 7)
    p = _layer_params(cfg, seed)
    S = 1 if mode == "decode" else 12
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    cache = None
    if mode != "full":
        cache = {k: (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
                 for k, v in ref_cache(cfg, 2, jnp.float32).items()}
    return p, x, cache


@pytest.mark.parametrize("mode", ["full", "prefill", "decode"])
def test_rwkv_block_matches_reference(mode):
    rcfg, tcfg = (rconfigs.get_smoke("rwkv6_1_6b"),
                  tconfigs.get_smoke("rwkv6_1_6b"))
    p, x, cache = _block_case(rcfg, mode)
    jc = None if cache is None else {k: jnp.asarray(v)
                                     for k, v in cache.items()}
    want, want_cache = jax.jit(lambda p_, x_, c_: ref_block(
        rcfg, p_, x_, cache=c_))({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), jc)
    tc = None if cache is None else {k: torch.from_numpy(v.copy())
                                     for k, v in cache.items()}
    got, got_cache = trwkv.rwkv_block(
        tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x), cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    if cache is None:
        assert got_cache is None
    else:
        assert got_cache is tc  # updated in place
        for k in cache:
            np.testing.assert_allclose(got_cache[k].numpy(),
                                       np.asarray(want_cache[k]),
                                       atol=ATOL, rtol=RTOL)


def test_rwkv_block_context_parallel_matches_sequential():
    """Under fsdp_sp with 4 "model" ranks the full-sequence wkv runs
    through ``cp_wkv_scan`` (the carry's rounds are the plan's); the
    layer matches the reference's sequential layer."""
    rcfg = rconfigs.get_smoke("rwkv6_1_6b")
    tcfg = tconfigs.get_smoke("rwkv6_1_6b", sharding_strategy="fsdp_sp")
    p, x, _ = _block_case(rcfg, "full", seed=3)
    want, _ = jax.jit(lambda p_, x_: ref_block(rcfg, p_, x_))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    with tsa.use_cost_model(REFERENCE_PROFILE), \
            tsch.collect_stats() as st:
        got, _ = trwkv.rwkv_block(
            tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x), mesh=make_host_mesh(1, 4))
    H, hd = tcfg.d_model // 64, 64
    pl = _reference_carry_plan(rcp._carry_spec(rcfg.scan_spec, None, "model"),
                               4, 2, H, hd)
    assert (st.rounds, st.op_applications) == (pl.rounds,
                                               pl.op_applications)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


CP_B, CP_S, CP_H, CP_HD = 1, 128, 2, 8


def _reference_carry_plan(spec, p, B, H, hd):
    """The JAX package's plan of its wkv carry: ``scan`` prices the
    ``(w_tot, s_final)`` tree, (B, H, hd, 1) and (B, H, hd, hd) fp32,
    with ``_tree_nbytes``, under its default constants (the ici tier of
    ``REFERENCE_PROFILE``)."""
    tree = (jnp.zeros((B, H, hd, 1)), jnp.zeros((B, H, hd, hd)))
    return rsa.plan(spec, p, nbytes=rsa._tree_nbytes(tree))


# (B, H, hd, p): RWKV6-1.6B's width at p = 4 and 8, where the plan on
# the materialised bytes picks another schedule than the reference's
CARRY_SHAPES = [(1, 32, 64, 4), (2, 16, 64, 4), (4, 32, 64, 4),
                (4, 32, 64, 8)]


@pytest.mark.parametrize("B,H,hd,p", CARRY_SHAPES)
def test_cp_wkv_carry_plan_is_the_references(B, H, hd, p):
    """``cp_wkv_scan`` under the reference's constants picks the
    reference's algorithm and segment count for its carry: the plan is
    priced on the (w_tot, s_final) tree's bytes, not on the decay
    materialised to the state's width.  One token a shard; the plan the
    forward ran is read off its autograd node."""
    want = _reference_carry_plan(
        rcp._carry_spec(None, None, "model"), p, B, H, hd)
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.uniform(0.9, 1.0, (p, B, 1, H, hd, 1))
                         .astype(np.float32)).requires_grad_()
    kv = torch.from_numpy((rng.standard_normal((p, B, 1, H, hd, hd)) * 0.1)
                          .astype(np.float32))
    with tsa.use_cost_model(REFERENCE_PROFILE), \
            tsch.collect_stats() as st:
        out = tcp.cp_wkv_scan(w, kv)
    node = out.grad_fn
    while not hasattr(node, "plan"):
        node = node.next_functions[0][0]
    got = node.plan
    assert (got.algorithm, got.segments) == (want.algorithm, want.segments)
    assert (st.rounds, st.op_applications) == (want.rounds,
                                               want.op_applications)
    assert got.payload_bytes == rsa._tree_nbytes(
        (jnp.zeros((B, H, hd, 1)), jnp.zeros((B, H, hd, hd))))


@pytest.fixture(scope="module")
def cp_case():
    """JAX's sequential wkv scan of the whole sequence, as
    ``tests/test_context_parallel.py`` holds its cp_wkv_scan."""
    rng = np.random.default_rng(1)
    w = rng.uniform(0.8, 1.0, (CP_B, CP_S, CP_H, CP_HD, 1)).astype(np.float32)
    kv = (rng.standard_normal((CP_B, CP_S, CP_H, CP_HD, CP_HD))
          * 0.1).astype(np.float32)
    ref, _ = ref_wkv(jnp.asarray(w), jnp.asarray(kv),
                     jnp.zeros((CP_B, CP_H, CP_HD, CP_HD)))
    return w, kv, np.asarray(ref)


@pytest.mark.parametrize("alg", ALGOS)
@pytest.mark.parametrize("p", [2, 4, 8])
def test_cp_wkv_matches_sequential(cp_case, p, alg):
    w, kv, ref = cp_case
    got = tcp.cp_wkv_scan(trwkv._split(torch.from_numpy(w), p),
                          trwkv._split(torch.from_numpy(kv), p),
                          algorithm=alg)
    assert got.shape == (p, CP_B, CP_S // p, CP_H, CP_HD, CP_HD)
    np.testing.assert_allclose(trwkv._join(got).numpy(), ref, rtol=SCAN_TOL,
                               atol=SCAN_TOL)


@pytest.mark.parametrize("p", [3, 8])
def test_cp_wkv_carry_runs_the_plan(cp_case, p):
    """An explicit spec and executor; the carry's measured rounds and ⊕
    are the reference's plan at the reference's bytes (the decay total
    at its broadcast (B, H, hd, 1)), though the wire carries it
    materialised to (B, H, hd, hd)."""
    w, kv, ref = cp_case
    S = CP_S - CP_S % p
    spec = ScanSpec(kind="exclusive", monoid="affine", algorithm="123")
    with tsch.collect_stats() as st:
        got = tcp.cp_wkv_scan(
            trwkv._split(torch.from_numpy(w[:, :S]), p),
            trwkv._split(torch.from_numpy(kv[:, :S]), p), spec=spec,
            executor=tsch.StackedExecutor("cpu"))
    pl = _reference_carry_plan(
        rsa.ScanSpec(kind="exclusive", monoid="affine", algorithm="123"), p,
        CP_B, CP_H, CP_HD)
    assert (st.rounds, st.op_applications) == (pl.rounds,
                                               pl.op_applications)
    np.testing.assert_allclose(trwkv._join(got).numpy(), ref[:, :S],
                               rtol=SCAN_TOL, atol=SCAN_TOL)


def test_cp_wkv_rejects_bad_shapes():
    kv = torch.zeros((2, 1, 4, 2, 8, 8))
    with pytest.raises(ValueError):
        tcp.cp_wkv_scan(torch.ones((2, 1, 4, 2, 8, 8)), kv)
    with pytest.raises(ValueError):
        tcp.cp_wkv_scan(torch.ones((2, 1, 4, 2, 8, 1)), kv[0])


def test_rwkv_constants_follow_the_reference():
    from repro.models import rwkv as rrwkv

    assert (trwkv.HEAD_DIM, trwkv.WKV_CHUNK) == (rrwkv.HEAD_DIM,
                                                 rrwkv.WKV_CHUNK)
    cfg = tconfigs.get_smoke("rwkv6_1_6b")
    cache = trwkv.init_rwkv_cache(cfg, 3, torch.float32, "cpu")
    want = ref_cache(rconfigs.get_smoke("rwkv6_1_6b"), 3, jnp.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in want.items()}
    assert cache["state"].dtype == torch.float32
