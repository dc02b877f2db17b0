"""The port's MoE layer against the JAX package's, on the CPU.

The reference runs ``moe_ffn`` under ``shard_map`` on a (data, model)
mesh; the port stacks the ranks' token groups on one device.  At ranks
(1, 1) the two must agree with the default capacity, drops included:
the same tokens dropped (the dropped fraction equal exactly) and y at
the fp32 cross-mesh tolerance of ``tests/test_models.py`` (atol 3e-4,
rtol 3e-3).  At ranks (2, 4) with ``capacity_factor=16`` (nothing
drops) the port must give the reference's single-device result, which
is what ``tests/test_models.py`` asserts of the reference's own 2 × 4
mesh.  At ranks (2, 4) with the default capacity the port must give
what the reference's own ``moe_ffn`` gives on a 2 × 4 mesh, drops
included; that mesh is emulated in this process on one device
(``_vmap_shard_map``: ``jax.shard_map`` replaced by nested ``jax.vmap``
over the mesh's axis names, so every collective runs through its
batching rule), with no fake-device subprocess.  The grouping decisions
(``src/repro/models/moe.py`` lines 98-136) are read off the reference's
own code at full width (``_reference_grouping``): they fix the number
of groups, hence the capacity, hence which tokens drop.
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as rconfigs
from repro.core import scan_api as rsa
from repro.models import moe as rmoe
from repro.models import params as rparams
from repro_torch import configs as tconfigs
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe

ATOL, RTOL = 3e-4, 3e-3
NAME = "qwen2_moe_a2_7b"


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _params(cfg, seed=0):
    """One MoE layer's weights (router, experts, shared experts)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, d in rparams._ffn_defs(cfg, True).items():
        scale = 1.0 if k == "norm2" else 1 / np.sqrt(d.shape[-2]
                                                     if len(d.shape) > 1
                                                     else 1)
        v = rng.standard_normal(d.shape) * scale
        out[k] = (1 + 0.1 * v if k == "norm2" else v).astype(np.float32)
    return out


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _reference(cfg, p, x, block=False):
    mesh = _mesh1()
    fn = rmoe.moe_block if block else rmoe.moe_ffn
    with jax.set_mesh(mesh):
        y, aux = jax.jit(lambda p_, x_: fn(cfg, p_, x_, mesh))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    return np.asarray(y), np.asarray(aux)


def _host_mesh(ranks):
    """A stand-in for a (data, model) ``Mesh``: the reference's
    ``moe_ffn`` reads only ``shape`` and ``axis_names`` and hands it to
    ``jax.shard_map``."""
    return types.SimpleNamespace(shape={"data": ranks[0], "model": ranks[1]},
                                 axis_names=("data", "model"))


def _spec_axes(entry):
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def _vmap_shard_map(f, *, mesh, in_specs, out_specs, check_vma=True):
    """``jax.shard_map`` on one device: each input is cut into its
    ranks' blocks by its PartitionSpec and stacked on one leading axis
    per mesh axis, ``f`` runs under nested ``jax.vmap`` named after
    those axes, and each output is put back together by its spec (a
    replicated output is taken from the rank that writes last, as every
    rank holds the same)."""
    names = tuple(mesh.axis_names)
    sizes = tuple(mesh.shape[a] for a in names)
    ranks = list(itertools.product(*(range(n) for n in sizes)))

    def blocks(entry, coord):
        """(blocks along a dim, this rank's block)"""
        n, i = 1, 0
        for a in _spec_axes(entry):
            j = names.index(a)
            n, i = n * sizes[j], i * sizes[j] + coord[j]
        return n, i

    def dims(spec, ndim):
        return [spec[d] if d < len(spec) else None for d in range(ndim)]

    def local(x, spec, coord):
        idx = []
        for d, entry in enumerate(dims(spec, x.ndim)):
            n, i = blocks(entry, coord)
            m = x.shape[d] // n
            idx.append(slice(i * m, (i + 1) * m))
        return x[tuple(idx)]

    def run(*args):
        stacked = []
        for a, spec in zip(args, in_specs):
            parts = [local(jnp.asarray(a), spec, c) for c in ranks]
            stacked.append(jnp.stack(parts).reshape(sizes + parts[0].shape))
        g = f
        for a in reversed(names):
            g = jax.vmap(g, axis_name=a)
        outs = []
        for o, spec in zip(jax.jit(g)(*stacked), out_specs):
            o = np.asarray(o)
            loc = o.shape[len(sizes):]
            entries = dims(spec, len(loc))
            full = np.zeros([m * blocks(e, ranks[0])[0]
                             for m, e in zip(loc, entries)], o.dtype)
            for c in ranks:
                full[tuple(slice(i * m, (i + 1) * m) for m, (_, i) in zip(
                    loc, (blocks(e, c) for e in entries)))] = o[c]
            outs.append(full)
        return tuple(outs)

    return run


def _reference_on_mesh(cfg, p, x, ranks):
    """The reference's ``moe_ffn`` on a ``ranks`` = (data, model) mesh,
    emulated by ``_vmap_shard_map``."""
    orig = jax.shard_map
    jax.shard_map = _vmap_shard_map
    try:
        y, aux = rmoe.moe_ffn(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), _host_mesh(ranks))
    finally:
        jax.shard_map = orig
    return np.asarray(y), np.asarray(aux)


def _port(cfg, p, x, ranks, block=False, **kw):
    fn = tmoe.moe_block if block else tmoe.moe_ffn
    y, aux = fn(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                torch.from_numpy(x), make_host_mesh(*ranks), **kw)
    return y.numpy(), aux.numpy()


# (B, S): a decode-sized call (weight-stationary grouping) and a
# prefill-sized one (B·S·k > 4096: batch-sharded grouping)
SHAPES = ((4, 16), (2, 1100))


@pytest.mark.parametrize("B,S", SHAPES)
def test_moe_ffn_drops_match_reference(B, S):
    rcfg, tcfg = rconfigs.get_smoke(NAME), tconfigs.get_smoke(NAME)
    p, x = _params(rcfg), _x(rcfg, B, S)
    want, want_aux = _reference(rcfg, p, x)
    got, aux = _port(tcfg, p, x, (1, 1))
    assert want_aux[1] > 0.05  # the default capacity drops tokens
    assert aux[1] == want_aux[1]  # the same (token, slot)s dropped
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(aux, want_aux, atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def reference_cap16():
    cfg = rconfigs.get_smoke(NAME, capacity_factor=16.0)
    p = _params(cfg, seed=2)
    out = {}
    for B, S in SHAPES:
        x = _x(cfg, B, S, seed=3)
        out[(B, S)] = (x, *_reference(cfg, p, x))
    return p, out


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("alg", ["123", "1doubling", "two_op"])
def test_moe_ffn_cross_mesh_matches_single_device(reference_cap16, alg, B, S):
    """Ranks (data 2, model 4): 4 or 8 stacked groups, the offsets and
    totals from one scan_with_total over them under ``alg``."""
    p, cases = reference_cap16
    x, want, want_aux = cases[(B, S)]
    cfg = tconfigs.get_smoke(NAME, capacity_factor=16.0,
                             scan=tsa.ScanSpec(kind="exclusive",
                                               algorithm=alg))
    groups = tmoe.moe_groups(cfg, B, S, make_host_mesh(2, 4)).n_groups
    with tsch.collect_stats() as st:
        got, aux = _port(cfg, p, x, (2, 4))
    pl = tsa.plan(tsa.ScanSpec(kind="scan_total", monoid="add",
                               algorithm=alg), groups,
                  nbytes=4 * tmoe.PD.experts_padded(cfg))
    assert (st.rounds, st.op_applications) == (pl.rounds,
                                               pl.op_applications)
    # nothing drops (the reference's fp32 mean of ones may be off by ulps)
    assert aux[1] == 0.0 and abs(want_aux[1]) < 1e-6
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(aux, want_aux, atol=ATOL, rtol=RTOL)


# (config overrides, (B, S)) at ranks (2, 4) with the default capacity:
# a decode-sized call (weight-stationary), a prefill-sized one split
# over data and model, and the fsdp_sp sequence split
MESH_CASES = [({}, (4, 1)), ({}, (2, 1100)),
              ({"sharding_strategy": "fsdp_sp"}, (2, 1100))]


@pytest.fixture(scope="module")
def reference_2x4():
    """The reference on the emulated 2 × 4 mesh, one run a case.  Its
    scan runs as "native" (one all-gather): an exact integer scan gives
    the same offsets under any algorithm, and ``ppermute``'s batching
    rule takes only whole permutations, which shift rounds are not."""
    out = {}
    for i, (over, (B, S)) in enumerate(MESH_CASES):
        cfg = rconfigs.get_smoke(NAME, scan=rsa.ScanSpec(kind="exclusive",
                                                         algorithm="native"),
                                 **over)
        p, x = _params(cfg, seed=6), _x(cfg, B, S, seed=7 + i)
        out[i] = (p, x, *_reference_on_mesh(cfg, p, x, (2, 4)))
    return out


@pytest.mark.parametrize("case", range(len(MESH_CASES)))
@pytest.mark.parametrize("alg", ["auto", "123", "two_op"])
def test_moe_ffn_drops_match_reference_on_mesh(reference_2x4, alg, case):
    """Ranks (2, 4), default capacity: the groups, the capacity and the
    (token, slot)s dropped are the reference mesh's.  A slot dropped on
    one side and kept on the other moves y by O(1), far past ATOL."""
    over, (B, S) = MESH_CASES[case]
    p, x, want, want_aux = reference_2x4[case]
    cfg = tconfigs.get_smoke(NAME, scan=tsa.ScanSpec(kind="exclusive",
                                                     algorithm=alg), **over)
    got, aux = _port(cfg, p, x, (2, 4))
    if S > 1:  # the prefill-sized calls drop at the default capacity
        assert want_aux[1] > 0.05
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(aux, want_aux, atol=ATOL, rtol=RTOL)


def test_moe_ffn_sequence_parallel_matches_single_device(reference_cap16):
    """fsdp_sp: each model rank dispatches its own sequence shard."""
    p, cases = reference_cap16
    x, want, want_aux = cases[SHAPES[0]]
    cfg = tconfigs.get_smoke(NAME, capacity_factor=16.0,
                             sharding_strategy="fsdp_sp")
    mesh = make_host_mesh(2, 4)
    gr = tmoe.moe_groups(cfg, *x.shape[:2], mesh)
    assert gr.seq_sp and not gr.token_split and gr.n_groups == 4
    got, aux = _port(cfg, p, x, (2, 4))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(aux, want_aux, atol=ATOL, rtol=RTOL)


def test_moe_block_with_shared_experts_matches_reference():
    rcfg, tcfg = rconfigs.get_smoke(NAME), tconfigs.get_smoke(NAME)
    assert rcfg.n_shared_experts
    p, x = _params(rcfg, seed=4), _x(rcfg, 2, 8, seed=5)
    want, want_aux = _reference(rcfg, p, x, block=True)
    got, aux = _port(tcfg, p, x, (1, 1), block=True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(aux, want_aux, atol=ATOL, rtol=RTOL)


def _groups(cfg, B, S, ranks):
    g = tmoe.moe_groups(cfg, B, S, make_host_mesh(*ranks))
    return (g.seq_sp, g.ws, g.token_split, g.n_groups, g.n0,
            tmoe.capacity(cfg, g.n0, cfg.top_k))


class _Decided(Exception):
    pass


def _reference_grouping(cfg, B, S, ranks):
    """The reference's own decisions for a (B, S) call: its ``moe_ffn``
    runs up to ``jax.shard_map``, which a stub replaces to read the local
    function's closure (seq_sp, ws, token_split, n_data, tp) and the
    tokens' PartitionSpec, then stop.  The local function's split
    (``moe.py`` lines 145-158) gives each group's token count and the
    number of groups."""
    seen = {}

    def stub(f, *, mesh, in_specs, out_specs, check_vma=True):
        def run(*args):
            seen.update(zip(f.__code__.co_freevars,
                            (c.cell_contents for c in f.__closure__)))
            seen["x_spec"] = in_specs[0]
            raise _Decided
        return run

    mesh = _host_mesh(ranks)
    orig = jax.shard_map
    jax.shard_map = stub
    try:
        rmoe.moe_ffn(cfg, dict.fromkeys(("router", "moe_gate", "moe_up",
                                         "moe_down")),
                     jax.ShapeDtypeStruct((B, S, cfg.d_model), jnp.float32),
                     mesh)
    except _Decided:
        pass
    finally:
        jax.shard_map = orig
    tp, n_data = seen["tp"], seen["n_data"]
    spec = tuple(seen["x_spec"])
    b_l = B // int(np.prod([mesh.shape[a] for a in _spec_axes(spec[0])]))
    s_l = S // int(np.prod([mesh.shape[a] for a in _spec_axes(spec[1])]))
    split = seen["seq_sp"] or seen["token_split"]
    n0 = b_l * s_l // (tp if seen["token_split"] else 1)
    return (seen["seq_sp"], seen["ws"], seen["token_split"],
            n_data * tp if split else n_data, n0)


# (config overrides, (B, S), ranks) -> (seq_sp, ws, token_split,
# n_groups, n0, cap), read off the reference's moe_ffn for
# Qwen1.5-MoE-A2.7B (top-4 of 60 experts padded to 64, d = 2048)
GROUPING = [
    # prefill, B·S·k = 8192 > 4096: batch over data, tokens over model
    ({}, (4, 512), (2, 4), (False, False, True, 8, 256, 20)),
    # decode: weight-stationary replicates the tokens over data
    ({}, (4, 1), (2, 4), (False, True, True, 4, 1, 8)),
    # one rank: a single group
    ({}, (4, 512), (1, 1), (False, False, True, 1, 2048, 160)),
    ({}, (4, 1), (1, 1), (False, True, True, 1, 4, 8)),
    # B = 1 does not split over 2 data ranks; 1 token not over 4
    ({}, (1, 1), (2, 4), (False, True, False, 1, 1, 8)),
    # without weight-stationary, decode keeps the batch sharding
    ({"moe_weight_stationary": False}, (4, 1), (2, 4),
     (False, False, False, 2, 2, 8)),
    # B = 3 does not split over 2: replicated, then over the model axis
    ({"moe_weight_stationary": False}, (3, 512), (2, 4),
     (False, False, True, 4, 384, 30)),
    # fsdp_sp: each model rank holds a sequence shard
    ({"sharding_strategy": "fsdp_sp"}, (4, 512), (2, 4),
     (True, False, False, 8, 256, 20)),
    ({"sharding_strategy": "fsdp_sp"}, (4, 2), (2, 4),
     (False, True, True, 4, 2, 8)),
]


@pytest.mark.parametrize("over,shape,ranks,want", GROUPING)
def test_grouping_decisions(over, shape, ranks, want):
    cfg = tconfigs.get("qwen2_moe_a2_7b", **over)
    assert _groups(cfg, *shape, ranks) == want
    ref = _reference_grouping(rconfigs.get("qwen2_moe_a2_7b", **over),
                              *shape, ranks)
    assert _groups(cfg, *shape, ranks)[:5] == ref


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.0, 0.3],
                      [0.0, 0.0, 0.5, 0.5, 0.0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = tmoe._top_k(torch.from_numpy(probs), 3)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
