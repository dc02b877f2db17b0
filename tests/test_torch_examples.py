"""The ported examples (``repro_torch.examples``) on the CPU, and the
deprecated ``collectives`` wrappers, against the JAX package.

The reference's ``examples/quickstart.py`` no longer runs on this tree's
jax (its rolled SPMD ring raises), so the quickstart is held against
what it asserts: the reference planner's plan for every algorithm run
through its ``SimulatorExecutor``, whose outputs and counts the port's
must equal.  The legacy wrappers are held against the reference's own
``collectives.exscan`` / ``inclusive_scan`` / ``allreduce``, with the
reference's ``scan`` routed to its ``SimulatorExecutor`` (its wrappers
otherwise need a bound mesh axis): the same warning, the same spec, the
same result.  The MoE example at ranks (1, 1) on the reference's
weights is held against the reference's ``Model.forward`` at the fp32
cross-mesh tolerance of ``tests/test_models.py`` (atol 3e-4, rtol
3e-3), its ``dropped`` term included; the context-parallel example
against the reference's sequential ``ssm_scan_chunked`` at 2e-4
(``tests/test_context_parallel.py``).
"""

import dataclasses
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro import configs as rconfigs
from repro.core import collectives as r_coll
from repro.core import scan_api as r_sa
from repro.core import schedule as r_sch
from repro.core.scan_api import ScanSpec as RSpec
from repro.models import params as rparams_lib
from repro.models.mamba import ssm_scan_chunked as ref_scan
from repro.models.model import Model as RModel
from repro_torch import configs as tconfigs
from repro_torch.benchmarks.ssm_context_parallel import inputs as ssm_inputs
from repro_torch.core import collectives as t_coll
from repro_torch.core.schedule import StackedExecutor
from repro_torch.examples import context_parallel_ssm, moe_dispatch_exscan, \
    quickstart, train_smoke
from repro_torch.models import params as tparams

ATOL, RTOL = 3e-4, 3e-3
CP_TOL = 2e-4
CPU = StackedExecutor("cpu")


def _ref_exscan(x, alg):
    """The reference's plan for ``alg`` on ``x``, run by its simulator:
    (output, rounds, ⊕, all-gathers, the planned algorithm)."""
    spec = RSpec(kind="exclusive", monoid="add", algorithm=alg,
                 axis_name="ranks")
    pl = r_sa.plan(spec, p=len(x), nbytes=x[0].nbytes)
    with r_sch.collect_stats() as st:
        out = pl.execute(x, executor=r_sch.SimulatorExecutor())
    return np.asarray(out), st.rounds, st.op_applications, st.allgathers, \
        pl.algorithm


def test_quickstart_matches_reference(capsys):
    got = quickstart.run("cpu")
    text = capsys.readouterr().out
    x = quickstart.payload()
    want_algs = r_sa.algorithms("exclusive") + ("auto",)
    assert tuple(k for k in got if k != "legacy") == want_algs
    for alg in want_algs:
        out, rounds, ops, gathers, planned = _ref_exscan(x, alg)
        g = got[alg]
        assert np.array_equal(g["out"], out)
        assert (g["rounds"], g["ops"], g["allgathers"], g["planned"]) == \
            (rounds, ops, gathers, planned)
    assert np.array_equal(got["legacy"], got["123"]["out"])
    for p in (36, 256, 512):
        assert f"p={p:4d}: 123-doubling {r_coll.q_123(p)} rounds" in text


def test_quickstart_main_runs_on_the_cpu():
    assert quickstart.main(["--device", "cpu"]) == 0


@pytest.fixture
def reference_scan_on_simulator(monkeypatch):
    """The reference's ``collectives.scan`` routed to its simulator; the
    specs it was handed are recorded."""
    specs = []

    def scan(x, spec):
        specs.append(spec)
        pl = r_sa.plan(spec, p=len(x), nbytes=np.asarray(x[0]).nbytes)
        return np.asarray(pl.execute(x, executor=r_sch.SimulatorExecutor()))

    monkeypatch.setattr(r_coll, "scan", scan)
    return specs


@pytest.mark.parametrize("name,args", [
    ("exscan", ("ranks", "add", "123")),
    ("exscan", ("ranks", "xor", "two_op")),
    ("exscan", ("ranks", "max", "auto")),
    ("inclusive_scan", ("ranks", "add")),
    ("allreduce", ("ranks", "add")),
    ("allreduce", ("ranks", "min")),
])
def test_legacy_wrappers_match_reference(reference_scan_on_simulator,
                                         monkeypatch, name, args):
    import torch

    port_specs = []
    real_scan = t_coll.scan

    def scan(x, spec, **kw):
        port_specs.append(spec)
        return real_scan(x, spec, **kw)

    monkeypatch.setattr(t_coll, "scan", scan)
    x = np.random.default_rng(3).integers(0, 1 << 20, (8, 5)) \
        .astype(np.int64)
    with warnings.catch_warnings(record=True) as caught_ref:
        warnings.simplefilter("always")
        want = getattr(r_coll, name)(x, *args)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = getattr(t_coll, name)(torch.from_numpy(x), *args,
                                    executor=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    msg = [str(w.message) for w in caught
           if issubclass(w.category, DeprecationWarning)]
    msg_ref = [str(w.message) for w in caught_ref
               if issubclass(w.category, DeprecationWarning)]
    assert msg == msg_ref and len(msg) == 1
    ref_spec, spec = reference_scan_on_simulator[-1], port_specs[-1]
    assert (spec.kind, spec.monoid.name, spec.algorithm, spec.axis_name) \
        == (ref_spec.kind, ref_spec.monoid.name, ref_spec.algorithm,
            ref_spec.axis_name) == (
            {"exscan": "exclusive", "inclusive_scan": "inclusive",
             "allreduce": "allreduce"}[name], args[1],
            args[2] if name == "exscan" else
            {"inclusive_scan": "hillis_steele",
             "allreduce": "butterfly"}[name], "ranks")


def test_theory_reexports_match_reference():
    for name in ("q_123", "rounds_1doubling", "rounds_two_op",
                 "rounds_halving", "rounds_quartering",
                 "rounds_reduce_scatter"):
        assert [getattr(t_coll, name)(p) for p in range(2, 70)] == \
            [getattr(r_coll, name)(p) for p in range(2, 70)]
    assert t_coll.ALGORITHMS == r_coll.ALGORITHMS


def test_context_parallel_example_matches_reference():
    shape = (1, 1024, 32)
    got = context_parallel_ssm.run("cpu", shape=shape, reps=1,
                                   verbose=False)
    a, b = (jnp.asarray(v) for v in ssm_inputs(0, shape))
    want, _ = ref_scan(a, b, jnp.zeros((1, 32)))
    for alg, r in got.items():
        np.testing.assert_allclose(r["h"].numpy(), np.asarray(want),
                                   rtol=CP_TOL, atol=CP_TOL)
        assert r["max_err"] <= CP_TOL and r["rounds"] > 0


def test_moe_example_matches_reference_forward():
    """Ranks (1, 1) on the reference's weights: logits and the aux terms
    (load balance, dropped summed over the MoE layers) as the
    reference's forward gives them."""
    name = moe_dispatch_exscan.ARCH
    rcfg = rconfigs.get_smoke(name)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    model = RModel(rcfg, mesh)
    rparams = model.init_params(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, 256, (2, 16)) \
        .astype(np.int32)
    with jax.set_mesh(mesh):
        want, want_aux = jax.jit(model.forward)(rparams, jnp.asarray(tokens))
    tree = tparams.from_reference(jax.tree.map(np.asarray, rparams),
                                  tconfigs.get_smoke(name), "cpu")
    got = moe_dispatch_exscan.run("cpu", tokens_shape=(2, 16),
                                  algs=("auto", "123"), ranks=(1, 1),
                                  params=tree, verbose=False)
    for lg, aux in got.values():
        np.testing.assert_allclose(lg, np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(aux, np.asarray(want_aux), atol=ATOL,
                                   rtol=RTOL)


def test_moe_example_on_the_mesh(capsys):
    """Ranks (2, 4), every algorithm: the example's own check (logits
    within 1e-4 of auto's) and its printed terms."""
    got = moe_dispatch_exscan.run("cpu", tokens_shape=(4, 32))
    text = capsys.readouterr().out
    assert tuple(got) == moe_dispatch_exscan.ALGS
    assert text.count("dropped=") == len(moe_dispatch_exscan.ALGS)
    assert "all algorithms produce the same MoE outputs" in text


def test_train_smoke_resume_equals_unbroken_run(tmp_path):
    cfg = tconfigs.get_smoke("llama3_8b")
    kw = dict(seq=32, batch=2, ckpt_every=2, verbose=False)
    full = train_smoke.train_smoke(cfg, 6, str(tmp_path / "a"), "cpu", **kw)
    assert full["start"] == 0 and len(full["losses"]) == 6
    assert all(np.isfinite(full["losses"]))
    # break the run after step 4: drop what it saved later
    shutil.rmtree(tmp_path / "a" / "step_00000006")
    resumed = train_smoke.train_smoke(cfg, 6, str(tmp_path / "a"), "cpu",
                                      **kw)
    assert resumed["start"] == 4
    assert resumed["losses"] == full["losses"][4:]


def test_train_smoke_config_is_the_reference_cut():
    cfg = train_smoke.config()
    ref = dataclasses.replace(
        rconfigs.get("llama3-8b"), n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=1536, vocab=8192, dtype="float32")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab, cfg.dtype) == (8, 512, 8, 4, 1536, 8192,
                                                "float32")
    assert tparams.count_params(cfg) == rparams_lib.count_params(ref) \
        == 33_563_136
