"""The port's sharding layer and the dry run's abstract cell inputs
against the JAX package's, on the CPU and without devices.

The reference's meshes are ``jax.sharding.AbstractMesh``es whose
``devices`` is an empty object array of the grid's shape (all the
reference's rules read of a mesh), so its ``NamedSharding``\\ s give the
per-device shapes of the production meshes (16 × 16, 2 × 16 × 16)
without 512 devices.  Specs are compared with each entry as a tuple of
mesh axes (jax writes a one-axis tuple as its name).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh, Mesh

from repro import configs as rconfigs
from repro.launch import steps as rsteps
from repro.models import params as rparams
from repro.models.model import Model as RModel
from repro.sharding import rules as rrules
from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import params as tparams
from repro_torch.models.model import Model as TModel
from repro_torch.sharding import ctx as tctx
from repro_torch.sharding import rules as trules

ATOL, RTOL = 3e-4, 3e-3
STRATEGIES = ("tp", "fsdp_sp", "decode_ws")
GRIDS = {"1x1": (("data", "model"), (1, 1)),
         "2x4": (("data", "model"), (2, 4)),
         "16x16": (("data", "model"), (16, 16)),
         "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
PRODUCTION = ("16x16", "2x16x16")
MOE = ("qwen2_moe_a2_7b", "granite_moe_3b_a800m", "jamba_1_5_large_398b")


class RefMesh(AbstractMesh):
    """An abstract mesh that answers ``devices`` (the reference's rules
    read its shape)."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, object)


@functools.cache
def meshes(grid: str):
    names, sizes = GRIDS[grid]
    return RefMesh(sizes, names), tmesh.HostMesh(names, sizes)


def norm(spec) -> tuple:
    """A spec as a tuple of axis tuples (None -> ())."""
    out = []
    for e in tuple(spec):
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


def same_sharding(ref, port, shape):
    assert norm(ref.spec) == norm(port.spec)
    assert tuple(ref.shard_shape(tuple(shape))) == \
        port.shard_shape(tuple(shape))


def dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return jnp.dtype(x.dtype).name


# ------------------------------ the tables ------------------------------


def test_rule_tables_match_reference():
    assert trules.DEFAULT_RULES == rrules.DEFAULT_RULES
    assert trules.FSDP_SP_RULES == rrules.FSDP_SP_RULES
    assert trules.DECODE_WS_RULES == rrules.DECODE_WS_RULES
    assert trules.STRATEGIES.keys() == rrules.STRATEGIES.keys()
    for k, rules in trules.STRATEGIES.items():
        assert rules.table == rrules.STRATEGIES[k].table
    assert trules.make_rules(seq=("data",)).table == \
        rrules.make_rules(seq=("data",)).table
    for s in STRATEGIES:
        t = trules.rules_for(tconfigs.get("llama3_8b", sharding_strategy=s))
        r = rrules.rules_for(rconfigs.get("llama3_8b", sharding_strategy=s))
        assert t.table == r.table


LOGICAL = sorted(set(trules.FSDP_SP_RULES)) + ["unknown", None]


@settings(max_examples=150, deadline=None)
@given(grid=st.sampled_from(sorted(GRIDS)),
       logical=st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=4),
       dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 24, 32,
                                      48, 64, 100, 256, 512, 4096]),
                     min_size=4, max_size=4),
       strategy=st.sampled_from(STRATEGIES))
def test_mesh_axes_and_divisible_spec_match_reference(grid, logical, dims,
                                                      strategy):
    rmesh, tmesh_ = meshes(grid)
    logical = tuple(logical)
    rr, tr = rrules.STRATEGIES[strategy], trules.STRATEGIES[strategy]
    rspec, tspec = rr.mesh_axes(logical, rmesh), tr.mesh_axes(logical,
                                                               tmesh_)
    assert norm(rspec) == norm(tspec)
    shape = tuple(dims[:len(logical)])
    assert norm(rrules.divisible_spec(rspec, shape, rmesh)) == \
        norm(trules.divisible_spec(tspec, shape, tmesh_))


def test_sharding_refuses_an_axis_twice_and_places():
    _, m = meshes("2x16x16")
    with pytest.raises(ValueError, match="'model'.*more than one dim"):
        trules.Sharding(m, trules.P(None, ("model",), None,
                                    ("data", "model")))
    with pytest.raises(ValueError, match="not in"):
        trules.Sharding(meshes("16x16")[1], trules.P(("pod",)))
    s = trules.Sharding(m, trules.P(None, ("pod", "data"), None))
    assert s.shard_shape((3, 64, 5)) == (3, 2, 5)
    from torch.distributed.tensor import Replicate, Shard

    assert s.placements() == (Shard(1), Shard(1), Replicate())
    assert trules.Sharding(m, trules.P()).placements() == (Replicate(),) * 3


# ------------------------------ parameters ------------------------------


def _raises_or(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - compared across packages
        return None, e


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", rconfigs.ARCHITECTURES)
def test_param_shardings_match_reference(arch, strategy, grid):
    rmesh, tmesh_ = meshes(grid)
    rcfg = rconfigs.get(arch, sharding_strategy=strategy)
    tcfg = tconfigs.get(arch, sharding_strategy=strategy)
    rules_r, rules_t = rrules.rules_for(rcfg), trules.rules_for(tcfg)
    want, rerr = _raises_or(
        lambda: rparams.param_shardings(rcfg, rmesh, rules_r))
    got, terr = _raises_or(
        lambda: tparams.param_shardings(tcfg, tmesh_, rules_t))
    # fsdp_sp maps "experts" and "embed" both to "model": the expert
    # leaves of the MoE archs are refused by both packages
    assert (rerr is None) == (terr is None), (rerr, terr)
    if rerr is not None:
        assert strategy == "fsdp_sp" and arch in MOE
        assert type(rerr).__name__ == "DuplicateSpecError"
        assert isinstance(terr, ValueError) and "'model'" in str(terr)
        return
    shapes = rparams.abstract_params(rcfg)
    abstract = tparams.abstract_params(tcfg)
    r_leaves = jax.tree.leaves(want)
    t_leaves, _ = _tree.flatten(got)
    r_shapes = jax.tree.leaves(shapes)
    t_abs, _ = _tree.flatten(abstract)
    assert len(r_leaves) == len(t_leaves) == len(t_abs)
    for r, t, rs, ta in zip(r_leaves, t_leaves, r_shapes, t_abs):
        assert tuple(rs.shape) == tuple(ta.shape)
        assert ta.is_meta and dtype_name(ta) == dtype_name(rs)
        same_sharding(r, t, rs.shape)


# ------------------------------ the cells ------------------------------


def test_shapes_and_applicability_match_reference():
    assert tuple(tsteps.SHAPES) == tuple(rsteps.SHAPES)
    for k, s in tsteps.SHAPES.items():
        r = rsteps.SHAPES[k]
        assert (s.name, s.kind, s.seq, s.batch, s.long_context) == \
            (r.name, r.kind, r.seq, r.batch, r.long_context)
    assert tsteps.SUBQUADRATIC_FAMILIES == rsteps.SUBQUADRATIC_FAMILIES
    skips = 0
    for arch in rconfigs.ARCHITECTURES:
        for k in rsteps.SHAPES:
            want = rsteps.applicable(rconfigs.get(arch), rsteps.SHAPES[k])
            got = tsteps.applicable(tconfigs.get(arch), tsteps.SHAPES[k])
            assert got == want
            skips += not got[0]
    assert skips == 9


@pytest.mark.parametrize("model", (1, 2, 4, 16))
def test_kv_dup_and_shardable_match_reference(model):
    rm = RefMesh((1, model), ("data", "model"))
    tm = tmesh.make_host_mesh(1, model)
    for arch in rconfigs.ARCHITECTURES:
        r, t = rconfigs.get(arch), tconfigs.get(arch)
        assert tsteps.kv_dup(t, tm) == rsteps.kv_dup(r, rm)
        assert tsteps.kv_shardable(t, tm) == rsteps.kv_shardable(r, rm)


def test_production_meshes():
    m = tmesh.make_production_mesh()
    assert (m.axis_names, m.sizes, m.size) == (("data", "model"), (16, 16),
                                               256)
    m = tmesh.make_production_mesh(multi_pod=True)
    assert (m.axis_names, m.sizes) == (("pod", "data", "model"),
                                       (2, 16, 16))


def _itemsize(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size()
    return jnp.dtype(x.dtype).itemsize


def _arg_bytes(leaves, shardings) -> int:
    return sum(math.prod(s.shard_shape(tuple(x.shape))) * _itemsize(x)
               for x, s in zip(leaves, shardings))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape", tuple(rsteps.SHAPES))
@pytest.mark.parametrize("arch", rconfigs.ARCHITECTURES)
def test_input_specs_match_reference(arch, shape, strategy):
    rcfg = rconfigs.get(arch, sharding_strategy=strategy)
    tcfg = tconfigs.get(arch, sharding_strategy=strategy)
    ok, _ = rsteps.applicable(rcfg, rsteps.SHAPES[shape])
    assert tsteps.applicable(tcfg, tsteps.SHAPES[shape])[0] == ok
    if not ok:
        return
    for grid in PRODUCTION:
        rmesh, tmesh_ = meshes(grid)
        want, rerr = _raises_or(lambda: rsteps.input_specs(
            rcfg, rsteps.SHAPES[shape], rmesh))
        got, terr = _raises_or(lambda: tsteps.input_specs(
            tcfg, tsteps.SHAPES[shape], tmesh_))
        assert (rerr is None) == (terr is None), (rerr, terr)
        if rerr is not None:
            assert strategy == "fsdp_sp" and arch in MOE
            continue
        (rargs, rsh, rdon), (targs, tsh, tdon) = want, got
        assert tdon == rdon
        r_leaves = jax.tree.leaves(rargs)
        t_leaves, _ = _tree.flatten(targs)
        r_sh = jax.tree.leaves(rsh)
        t_sh, _ = _tree.flatten(tsh)
        assert len(r_leaves) == len(t_leaves) == len(r_sh) == len(t_sh)
        for r, t, rs, ts in zip(r_leaves, t_leaves, r_sh, t_sh):
            assert tuple(r.shape) == tuple(t.shape)
            assert t.is_meta and dtype_name(t) == dtype_name(r)
            same_sharding(rs, ts, r.shape)
        assert _arg_bytes(t_leaves, t_sh) == _arg_bytes(r_leaves, r_sh)


def test_the_ten_fsdp_sp_moe_cells_raise_in_both():
    rmesh, tmesh_ = meshes("16x16")
    raised = []
    for arch in rconfigs.ARCHITECTURES:
        rcfg = rconfigs.get(arch, sharding_strategy="fsdp_sp")
        tcfg = tconfigs.get(arch, sharding_strategy="fsdp_sp")
        for k in rsteps.SHAPES:
            if not rsteps.applicable(rcfg, rsteps.SHAPES[k])[0]:
                continue
            _, rerr = _raises_or(lambda: rsteps.input_specs(
                rcfg, rsteps.SHAPES[k], rmesh))
            _, terr = _raises_or(lambda: tsteps.input_specs(
                tcfg, tsteps.SHAPES[k], tmesh_))
            assert (rerr is None) == (terr is None)
            if terr is not None:
                raised.append((arch, k))
    assert len(raised) == 10
    assert {a for a, _ in raised} == set(MOE)


# ------------------------------ the cache ------------------------------


@pytest.mark.parametrize("dup", (1, 2))
@pytest.mark.parametrize("arch", [a for a in rconfigs.ARCHITECTURES
                                  if not rconfigs.get(a).encoder_only])
def test_abstract_cache_and_axes_match_reference(arch, dup):
    rm = RModel(rconfigs.get(arch), meshes("1x1")[0])
    tm = TModel(tconfigs.get(arch), (1, 1), device="cpu")
    want = rm.abstract_cache(2, 16, dup)
    got = tm.abstract_cache(2, 16, dup)
    r_leaves, t_leaves = jax.tree.leaves(want), _tree.leaves(got)
    assert len(r_leaves) == len(t_leaves)
    for r, t in zip(r_leaves, t_leaves):
        assert tuple(r.shape) == tuple(t.shape)
        assert t.is_meta and dtype_name(t) == dtype_name(r)
    for seq_sharded in (False, True):
        for shardable in (False, True):
            assert tm.cache_logical_axes(seq_sharded, shardable) == \
                rm.cache_logical_axes(seq_sharded, shardable)


def test_serve_step_on_a_duplicated_cache_matches_reference():
    """Smoke llama3 (4 heads, 2 kv heads) serving from a cache that holds
    each kv head twice: prefill, then two decode steps fed the
    reference's tokens, logits within tolerance; the port's cache holds
    the reference's."""
    B, P, G, dup = 2, 10, 3, 2
    rcfg = rconfigs.get_smoke("llama3_8b")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rmodel = RModel(rcfg, mesh)
    params = rmodel.init_params(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(
        1, rcfg.vocab, (B, P)).astype(np.int32)
    want, feed = [], []
    with jax.set_mesh(mesh):
        cache = rmodel.init_cache(B, P + G, kv_dup=dup)
        logits, cache = jax.jit(lambda p, c, t: rmodel.serve_step(
            p, c, t, 0, last_only=True))(params, cache, jnp.asarray(prompts))
        want.append(np.asarray(logits))
        decode = jax.jit(rmodel.decode_step)
        for i in range(G - 1):
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            feed.append(np.asarray(tok))
            logits, cache = decode(params, cache, tok[:, None], P + i)
            want.append(np.asarray(logits))
        want_cache = jax.tree.map(np.asarray, cache)

    tcfg = tconfigs.get_smoke("llama3_8b")
    model = TModel(tcfg, (1, 1), device="cpu")
    tp = model.load_params(tparams.from_reference(
        jax.tree.map(np.asarray, params), tcfg, "cpu"))
    cache = model.init_cache(B, P + G, kv_dup=dup)
    assert cache[0]["k"].shape[3] == tcfg.n_kv_heads * dup
    logits, cache = model.serve_step(tp, cache, torch.from_numpy(prompts), 0,
                                     last_only=True)
    np.testing.assert_allclose(logits.numpy(), want[0], atol=ATOL, rtol=RTOL)
    for i, w in enumerate(want[1:]):
        tok = torch.from_numpy(feed[i][:, None].copy())
        logits, cache = model.decode_step(tp, cache, tok, P + i)
        np.testing.assert_allclose(logits.numpy(), w, atol=ATOL, rtol=RTOL)
    for got, w in zip(_tree.leaves(cache), jax.tree.leaves(want_cache)):
        np.testing.assert_allclose(got.numpy(), w, atol=ATOL, rtol=RTOL)


# ------------------------------ the context ------------------------------


def test_constrain_is_the_identity_and_contexts_nest():
    x = torch.randn(4, 6, 8)
    assert not tctx.active()
    assert tctx.constrain(x, "batch", "seq", "mlp") is x
    outer, inner = meshes("2x4")[1], meshes("16x16")[1]
    with tctx.use_mesh_rules(outer):
        assert tctx.current() == (outer, trules.DEFAULT)
        with tctx.use_mesh_rules(inner, trules.STRATEGIES["fsdp_sp"]):
            assert tctx.current() == (inner, trules.STRATEGIES["fsdp_sp"])
        assert tctx.current() == (outer, trules.DEFAULT)
        recs = []
        with tctx.record_constraints(recs):
            y = tctx.constrain(x, "batch", None, "mlp", site="s")
        assert y is x
        assert recs == [("s", (2, 6, 2), trules.P(("data",), None,
                                                   ("model",)), 4)]
    assert not tctx.active()
    # one rank: nothing resolved, nothing recorded
    recs = []
    with tctx.use_mesh_rules(meshes("1x1")[1]), \
            tctx.record_constraints(recs):
        assert tctx.constrain(x, "batch") is x
    assert recs == []


def test_model_values_unchanged_under_the_rules(monkeypatch):
    """The rule context and the constraints change no value: a smoke
    forward at ranks (2, 4) equals the same forward without them."""
    import contextlib

    import repro_torch.models.model as model_mod

    cfg = tconfigs.get_smoke("qwen2_moe_a2_7b")
    model = TModel(cfg, (2, 4), device="cpu")
    params = model.init_params(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    got, aux = model.forward(params, tokens)
    monkeypatch.setattr(model_mod, "use_mesh_rules",
                        lambda *a, **k: contextlib.nullcontext())
    want, waux = model.forward(params, tokens)
    assert torch.equal(got, want) and torch.equal(aux, waux)
