"""The ported benchmark CLIs (``repro_torch.benchmarks``) on the CPU,
against the JAX package's ``benchmarks/``.

- ``round_counts`` and ``plan_table`` (under ``dist_bench
  .REFERENCE_PROFILE``, the reference's tier constants as numbers) give
  the reference's ``run(...)`` rows, row for row: integers and decisions
  exactly, floats within 1e-9 relative.  The reference's modules are
  called in this process; both execute their checks on the CPU.
- ``autotune_bench``'s drift scenario gives the reference's installs,
  refits and plans dropped.
- exscan_table1's modeled rows, under the reference's three constants
  written as numbers, equal its ``modeled_us``; its measured rows carry
  the reference's names and numpy's outputs.
- The MoE and SSM benches' outputs equal the reference's model forward
  (ranks (1, 1), its weights; atol 3e-4, rtol 3e-3, ``tests/test_models
  .py``) and sequential scan (2e-4, ``tests/test_context_parallel.py``).
- Each ported CLI's ``--check`` passes with ``--device cpu``, and
  ``run.py`` prints the CSV of its five modules.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro import configs as rconfigs
from repro.core import scan_api as r_sa
from repro.models.mamba import ssm_scan_chunked as ref_scan
from repro.models.model import Model as RModel
from repro_torch import configs as tconfigs
from repro_torch.benchmarks import autotune_bench, exec_bench, \
    exscan_table1, moe_dispatch, plan_table, round_counts, serve_bench, \
    ssm_context_parallel
from repro_torch.benchmarks import run as run_harness
from repro_torch.benchmarks.dist_bench import REFERENCE_PROFILE
from repro_torch.core import scan_api as t_sa
from repro_torch.core.scan_api import CostModel
from repro_torch.models import params as tparams

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL = 3e-4, 3e-3
CP_TOL = 2e-4


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_rows(got, want):
    assert [k for k, _, _ in got] == [k for k, _, _ in want]
    for (k, v, note), (_, w, wnote) in zip(got, want):
        assert note == wnote, k
        if isinstance(w, float):
            assert v == pytest.approx(w, rel=1e-9, abs=0), k
        else:
            assert v == w, k


@pytest.fixture
def clean_caches():
    t_sa.plan_cache_clear()
    r_sa.plan_cache_clear()
    yield
    t_sa.plan_cache_clear()
    r_sa.plan_cache_clear()


def test_round_counts_rows_match_reference(clean_caches):
    want = _reference("round_counts").run([], check=True)
    got = round_counts.run([], check=True, device="cpu")
    _same_rows(got, want)


def test_plan_table_rows_match_reference_under_its_constants(clean_caches):
    want = _reference("plan_table").run([], check=True)
    got = plan_table.run([], check=True, profile=REFERENCE_PROFILE,
                         device="cpu")
    _same_rows(got, want)


def test_plan_table_default_is_the_stacked_tier(clean_caches):
    rows = {k: v for k, v, _ in plan_table.run([], device="cpu")}
    assert rows["winner_map/stacked/new_alg_cells"] >= 1
    assert rows["winner_map_modeled/stacked/new_alg_cells"] >= 1
    pins = {k for k in rows if k.startswith("pin/")}
    assert pins and all(rows[k] == "123" for k in pins)
    assert not any("/ici/" in k or "/dci/" in k for k in rows)


def test_autotune_bench_matches_reference(clean_caches):
    want = _reference("autotune_bench").run_scenario(drift=True)
    got = autotune_bench.run_scenario(drift=True)
    for key in ("installs", "refits", "plans_dropped", "pinned_cell",
                "converged_at", "detect_executions", "reservoirs"):
        assert got[key] == want[key], key
    assert [(r["execution"], r["plans_dropped"]) for r in got["install_log"]] \
        == [(r["execution"], r["plans_dropped"])
            for r in want["install_log"]]
    assert got["walltime_ratio"] == pytest.approx(want["walltime_ratio"],
                                                  rel=1e-9)
    assert autotune_bench.check([got, autotune_bench.run_scenario(
        drift=False)]) == []


@pytest.mark.parametrize("p", exscan_table1.MODELED_PS)
def test_exscan_modeled_rows_match_reference(p):
    ref = _reference("exscan_table1")
    cm = CostModel(alpha=1e-6, beta=1.0 / 50e9, gamma=2.0 / 819e9)
    assert (ref.ALPHA, ref.B_LINK, ref.B_HBM) == (1e-6, 50e9, 819e9)
    for m in ref.EMS:
        for alg in ref.ALGS:
            assert exscan_table1.modeled_us(alg, p, m, cm) == pytest.approx(
                ref.modeled_us(alg, p, m), rel=1e-12, abs=0)


def test_exscan_table1_rows_are_the_reference_cells():
    ref = _reference("exscan_table1")
    assert (exscan_table1.ALGS, exscan_table1.EMS) == (ref.ALGS, ref.EMS)
    rows = exscan_table1.run([], device="cpu")  # raises unless numpy's
    measured = [k for k, _, note in rows if note == "us_wallclock_cpu"]
    assert measured == [f"exscan_measured_p8/{alg}/m{m}"
                        for m in ref.EMS for alg in ref.ALGS]
    modeled = [k for k, _, note in rows
               if note == "us_abg_model_stacked"]
    assert modeled == [f"exscan_modeled_p{p}/{alg}/m{m}"
                       for p in (36, 256, 512) for m in ref.EMS
                       for alg in ref.ALGS]
    assert all(v > 0 for _, v, _ in rows)


def test_exscan_measured_outputs_are_numpy():
    import torch

    from repro_torch.core.scan_api import ScanSpec, scan
    from repro_torch.core.schedule import StackedExecutor

    x = np.arange(8 * 10, dtype=np.int64).reshape(8, 10)
    want = exscan_table1.xor_exscan(x)
    assert np.array_equal(want[3], x[0] ^ x[1] ^ x[2])
    for alg in exscan_table1.ALGS:
        got = scan(torch.from_numpy(x), ScanSpec(
            kind="exclusive", monoid="xor", algorithm=alg),
            executor=StackedExecutor("cpu"))
        assert np.array_equal(got.numpy(), want)


def test_moe_dispatch_forward_matches_reference():
    name = moe_dispatch.ARCH
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    ref = RModel(rconfigs.get_smoke(name), mesh)
    rparams = ref.init_params(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, tconfigs.get_smoke(name).vocab, moe_dispatch.TOKENS) \
        .astype(np.int32)
    with jax.set_mesh(mesh):
        want, want_aux = jax.jit(ref.forward)(rparams, jnp.asarray(tokens))
    tree = tparams.from_reference(jax.tree.map(np.asarray, rparams),
                                  tconfigs.get_smoke(name), "cpu")
    us, logits, aux = moe_dispatch.forward("auto", tokens, "cpu",
                                           ranks=(1, 1), params=tree, reps=1)
    assert us > 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("alg", ssm_context_parallel.ALGS)
def test_ssm_prefill_matches_reference(alg):
    shape = (1, 512, 64)
    a, b = ssm_context_parallel.inputs(0, shape)
    us, h = ssm_context_parallel.prefill(alg, a, b, "cpu", reps=1)
    want, _ = ref_scan(jnp.asarray(a), jnp.asarray(b), jnp.zeros((1, 64)))
    assert us > 0 and h.shape == shape
    np.testing.assert_allclose(h.numpy(), np.asarray(want), rtol=CP_TOL,
                               atol=CP_TOL)


@pytest.mark.parametrize("module,argv", [
    (round_counts, ["--check"]),
    (plan_table, ["--check", "--verbose"]),
    (autotune_bench, ["--check"]),
    (exec_bench, ["--check", "--ps", "8,64"]),
    (serve_bench, ["--check", "--rates", "5000"]),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_check_passes_on_the_cpu(module, argv, tmp_path, capsys,
                                 clean_caches):
    out = tmp_path / "bench.json"
    assert module.main(["--device", "cpu", *argv, "--json", str(out)]) == 0
    import json

    meta = json.loads(out.read_text())["meta"]
    assert meta["device"] == "cpu" and "card" not in meta
    assert "FAIL" not in capsys.readouterr().out


def test_exec_bench_counts_are_the_irs():
    rows = exec_bench.schedule_rows(8, "cpu", reps=1) + \
        exec_bench.fused_rows("cpu", reps=1)
    assert exec_bench.check(rows) == []
    by = {(r["algorithm"], r["mode"]): r for r in rows}
    ring_f, ring_b = by[("ring", "fused")], by[("ring", "baseline")]
    assert ring_b["hbm_passes"] >= exec_bench.MIN_FUSED_PASS_WIN * \
        ring_f["hbm_passes"]
    assert all(r["round_kernel_launches"] == 0 for r in rows)  # no card
    assert {r["algorithm"] for r in rows if r["mode"] == "stacked"} == \
        set(exec_bench.ALGS)


def test_run_harness_csv(capsys, clean_caches, monkeypatch, tmp_path):
    # no dry-run JSON: no roofline rows (test_torch_dryrun reads one)
    monkeypatch.setattr(run_harness, "DRYRUN_JSON",
                        str(tmp_path / "absent.json"))
    assert run_harness.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    i = lines.index("name,value,derived")
    names = [ln.split(",", 1)[0] for ln in lines[i + 1:]]
    want = [k for k, _, _ in round_counts.run([], device="cpu")] + \
        [k for k, _, _ in plan_table.run([], device="cpu")]
    want += [f"exscan_measured_p8/{alg}/m{m}" for m in exscan_table1.EMS
             for alg in exscan_table1.ALGS]
    want += [f"exscan_modeled_p{p}/{alg}/m{m}"
             for p in exscan_table1.MODELED_PS for m in exscan_table1.EMS
             for alg in exscan_table1.ALGS]
    want += [f"moe_forward_p8/{alg}" for alg in moe_dispatch.ALGS]
    want += [f"cp_ssm_prefill_p8/{alg}"
             for alg in ssm_context_parallel.ALGS]
    assert names == want
    assert not any(n.startswith("roofline/") for n in names)


def test_run_harness_fails_when_a_module_fails(monkeypatch, capsys):
    def boom(rows, device):
        raise RuntimeError("module failed")

    monkeypatch.setattr(run_harness, "modules",
                        lambda: [("round_counts", round_counts.run),
                                 ("boom", boom)])
    assert run_harness.main(["--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert "# BENCH FAILED: boom" in captured.err
    assert "rounds/two_op/p4," in captured.out


# ---------------------------------------------------------------------------
# the benches across a worker pool (gloo on the CPU)
# ---------------------------------------------------------------------------


def test_ssm_pool_rows_are_the_stacked_runs():
    rows = ssm_context_parallel.run_pool(2, 4, "gloo", "cpu", reps=1,
                                         shape=(1, 512, 64))
    assert [r["name"] for r in rows] == [
        f"cp_ssm_prefill_p8/{alg}/procs2x4/gloo"
        for alg in ssm_context_parallel.ALGS]
    for r in rows:
        assert ssm_context_parallel.pool_ok(r), r
        assert r["us"] > 0 and r["stacked_us"] > 0 and r["messages"] > 0


def test_moe_dispatch_pool_check_cli(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(moe_dispatch, "ALGS", ("auto", "two_op"))
    out = tmp_path / "moe.json"
    assert moe_dispatch.main(["--device", "cpu", "--nprocs", "4",
                              "--p-intra", "2", "--check", "--json",
                              str(out)]) == 0
    import json

    body = json.loads(out.read_text())
    names = [r["name"] for r in body["pool_rows"]]
    assert names == ["moe_dispatch_p8/auto/procs4x2/gloo",
                     "moe_dispatch_p8/two_op/procs4x2/gloo"]
    assert all(r["identical"] and r["staged_copies"] == 0
               for r in body["pool_rows"])
    assert "DRIFT" not in capsys.readouterr().out


def test_pool_benches_refuse_another_p():
    with pytest.raises(ValueError, match="p = 8"):
        ssm_context_parallel.run_pool(3, 2, "gloo", "cpu")
    with pytest.raises(ValueError, match="p = 8"):
        moe_dispatch.run_pool(2, 2, "gloo", "cpu")


def test_pool_gate_wants_no_staging_under_nccl():
    row = {"identical": True, "backend": "nccl", "staged_copies": 0}
    assert ssm_context_parallel.pool_ok(row)
    assert not ssm_context_parallel.pool_ok(dict(row, staged_copies=2))
    assert not ssm_context_parallel.pool_ok(dict(row, identical=False))
    assert ssm_context_parallel.pool_ok(dict(row, backend="gloo",
                                             staged_copies=2))


def test_dist_bench_nccl_needs_a_card_a_process():
    from repro_torch.benchmarks import dist_bench

    with pytest.raises(ValueError, match="3 processes, 0 cards"):
        dist_bench.main(["--device", "cpu", "--backend", "nccl",
                         "--json", ""])


def test_nccl_calibration_fingerprint_names_backend_and_cards():
    from repro_torch.core import tune

    assert tune.dist_fingerprint(4, 2, "cuda", "nccl", 4) == \
        "dist-cuda-nccl-cards4-procs4x2"
    assert tune.dist_fingerprint(8, 1, "cuda") == "dist-cuda-procs8x1"
    assert tune.dist_fingerprint(4, 2, "cuda", "gloo", 1) == \
        "dist-cuda-procs4x2"
