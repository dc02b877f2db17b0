"""The cross-process ("dci") half of ``repro_torch.core.tune`` against the
JAX package's ``repro.core.tune``, on a pool of gloo processes on the
CPU: the fingerprints and the sweep's cases are the reference's, the
sweep's features are the reference's ``schedule_features`` for the same
cases, ``calibrate_dist`` builds the tiers and routing stated in its
docstring, ``AutoTuner.observe_dist`` reads a real pool result, and the
CLI's ``--dist`` writes a profile (``--dist-intra 0`` is refused by the
pool; ``tests/test_torch_blocks.py`` runs ``--dist-intra 2``).  The
card's dci tier is calibrated by ``chip_smoke.py``'s
``autotune`` phase and ``tests/test_torch_cuda_autotune.py``.
"""

import json
import os

import numpy as np
import pytest

from repro.core import scan_api as r_sa
from repro.core import tune as r_tune
from repro.launch import mesh as r_mesh
from repro_torch.core import autotune as t_at
from repro_torch.core import scan_api as t_sa
from repro_torch.core import tune as t_tune
from repro_torch.dist import WorkerPool
from repro_torch.launch import mesh as t_mesh

P = 3
MS = (8192, 131_072)  # two of DIST_MS, for the test's time


@pytest.fixture(scope="module")
def pool():
    with WorkerPool(P, backend="gloo", device="cpu", timeout=60) as pl:
        yield pl


@pytest.fixture(scope="module")
def sweep(pool):
    return t_tune.calibration_sweep_dist(pool, ms=MS, repeats=1)


@pytest.mark.parametrize("nprocs,ranks,platform",
                         [(2, 1, "cpu"), (8, 1, "cuda"), (36, 4, "cpu"),
                          (4, 2, "cuda")])
def test_dist_fingerprint_matches_reference(nprocs, ranks, platform):
    assert t_tune.dist_fingerprint(nprocs, ranks, platform) == \
        r_tune.dist_fingerprint(nprocs, ranks, platform)
    assert t_tune.dist_fingerprint(nprocs, ranks) == \
        r_tune.dist_fingerprint(nprocs, ranks)


@pytest.mark.parametrize("p", (2, 3, 8, 36))
def test_sweep_cases_match_reference(p):
    assert t_tune.DIST_MS == r_tune.DIST_MS
    assert t_tune.HOP_SIZES == r_tune.HOP_SIZES
    assert t_tune._sweep_cases((p,), t_tune.DIST_MS) == \
        r_tune._sweep_cases((p,), r_tune.DIST_MS)


def test_pool_reports_its_topology(pool):
    assert (pool.nprocs, pool.p, pool.p_intra, pool.platform) == \
        (P, P, 1, "cpu")


def test_sweep_features_match_reference(sweep):
    cases = r_tune._sweep_cases((P,), MS)
    assert len(sweep) == len(cases)
    for s, (kind, name, p, m, S) in zip(sweep, cases):
        sched = r_sa.get_algorithm(kind, name).schedule(p, S)
        want = r_tune.schedule_features(sched, m, 1.0, commutative=True)
        assert (s.tier, s.kind, s.algorithm, s.p, s.nbytes, s.segments,
                s.clock) == ("dci", kind, name, P, m, S, "dist")
        assert (s.hops, s.serial_bytes, s.op_bytes) == want
        assert s.seconds > 0


def test_fit_of_the_sweep(sweep):
    cm, resid = t_tune.fit_tier(sweep)
    rcm, rresid = r_tune.fit_tier([r_tune.Sample(**vars(s)) for s in sweep])
    assert min(cm.alpha, cm.beta, cm.gamma) >= 0
    np.testing.assert_allclose([cm.alpha, cm.beta, cm.gamma, resid],
                               [rcm.alpha, rcm.beta, rcm.gamma, rresid],
                               rtol=1e-9, atol=1e-300)


def test_measure_hops(pool):
    rows = t_tune.measure_hops(pool, sizes=(8, 8192), repeats=3)
    assert [r["nbytes"] for r in rows] == [8, 8192]
    assert all(r["seconds"] > 0 for r in rows)


def test_calibrate_dist_tiers_and_routing(pool):
    prof = t_tune.calibrate_dist(pool, ms=(8192,), repeats=1)
    assert [n for n, _ in prof.tiers] == ["dci", "stacked"]
    assert prof.model("stacked") == t_mesh.DEFAULT_PROFILE.model("stacked")
    assert prof.default_tier == "stacked"
    assert prof.axis_tiers == (("proc", "dci"),)
    assert prof.tier_for_axis("proc") == "dci"
    assert prof.tier_for_axis(None) == "stacked"
    assert prof.mesh_fingerprint == "dist-cpu-procs3x1"
    assert [t for t, _ in prof.residuals] == ["dci"]
    assert prof.source == "calibrated"
    # under the JAX package's profile carried across, the reference's
    # layout: the local tier is "ici", "pod" and "proc" route to "dci"
    base = t_sa.CostProfile.from_json(r_mesh.DEFAULT_PROFILE.to_json())
    prof = t_tune.calibrate_dist(pool, ms=(8192,), repeats=1, base=base)
    assert [n for n, _ in prof.tiers] == ["dci", "ici"]
    assert prof.default_tier == "ici"
    assert prof.model("ici") == base.model("ici")
    assert prof.axis_tiers == (("pod", "dci"), ("proc", "dci"))


def test_observe_dist_over_a_pool_run(pool):
    tuner = t_at.AutoTuner(t_mesh.DEFAULT_PROFILE, install=False)
    pl = t_sa.plan(t_sa.ScanSpec(kind="exclusive", monoid="add",
                                 algorithm="123"), P, nbytes=8192)
    x = np.random.default_rng(0).integers(0, 1 << 30, (P, 1024))
    res = pool.run(pl.schedule(), x, repeats=3)
    np.testing.assert_array_equal(res.outputs[1:], np.cumsum(x, 0)[:-1])
    rep = tuner.observe_dist(res, pl.schedule(), 8192)
    (s,) = tuner.reservoir("dci")
    assert s.seconds == float(np.median(res.seconds)) > 0
    assert (s.algorithm, s.p, s.nbytes) == ("dist", P, 8192)
    assert (s.hops, s.serial_bytes, s.op_bytes) == t_tune.schedule_features(
        pl.schedule(), 8192, 1.0, commutative=True)
    assert len(rep.rank_seconds) == P
    assert rep.median > 0
    assert tuner.reservoir_sizes() == {"dci": 1}


def test_cli_dist_writes_a_profile(tmp_path, capsys):
    rc = t_tune.main(["--dist", "2", "--device", "cpu", "--out",
                      str(tmp_path)])
    assert rc == 0
    path = t_tune.profile_path("dist-cpu-procs2x1", str(tmp_path))
    assert os.path.exists(path)
    with open(path) as f:
        prof = t_sa.CostProfile.from_json(json.load(f))
    assert [n for n, _ in prof.tiers] == ["dci", "stacked"]
    out = capsys.readouterr().out
    assert "clock=dist" in out and f"wrote {path}" in out


def test_cli_dist_intra_is_refused(tmp_path):
    # --dist-intra 2 runs a block pool and writes its profile
    # (tests/test_torch_blocks.py); fewer than one rank a process is
    # refused before any process starts
    with pytest.raises(ValueError, match="p_intra"):
        t_tune.main(["--dist", "2", "--dist-intra", "0", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)
