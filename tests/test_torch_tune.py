"""Calibration of the "stacked" tier against the JAX package's.

``repro_torch.core.tune`` is held against ``repro.core.tune``: NNLS
equal to 1e-12 relative on random systems, ``schedule_features`` equal
(floats of integer counts: exact) for every registered algorithm, and
the simulated calibration sweep equal sample for sample.  The fit, the
profile store (a profile written by either package loads in the other),
``launch.mesh``'s resolution order, and the walltime clock's refusal to
run without a card are checked on the CPU.  The walltime clock on the
card is tested in ``test_torch_cuda_scan_kernels.py``, which the card's
machine imports without jax.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.core import scan_api as rsa
from repro.core import tune as rtune
from repro_torch.core import benchmeta
from repro_torch.core import scan_api as tsa
from repro_torch.core import tune
from repro_torch.core.scan_api import (
    PROFILE_SCHEMA_VERSION, CostModel, CostProfile, ScanSpec, plan)
from repro_torch.launch import mesh as mesh_lib

PS = (2, 3, 5, 8, 17)
MS = (0, 8, 512, 8192, 1_048_576 + 8)


def _profile(alpha=2e-6, beta=4e-11, gamma=5e-12, tier="stacked", **kw):
    return CostProfile(
        tiers=((tier, CostModel(alpha=alpha, beta=beta, gamma=gamma,
                                source="calibrated")),),
        source="calibrated", default_tier=tier, **kw)


def _store_file(tmp_path, fingerprint, text: str) -> str:
    path = tune.profile_path(fingerprint, str(tmp_path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


# ---------------------------------------------------------------------------
# Against the reference: NNLS, features, the simulated sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_nnls_matches_reference(seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((30, 3 + seed % 3))
    b = A @ rng.standard_normal(A.shape[1])  # some coordinates clamp
    got, want = tune.nnls(A, b), rtune.nnls(A, b)
    assert (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("kind", tsa.KINDS)
def test_schedule_features_match_reference(kind):
    for name in tsa.algorithms(kind):
        segs = tune.RING_SEGMENTS if name == "ring" else (1,)
        for p in PS:
            for S in segs:
                ts = tsa.get_algorithm(kind, name).schedule(p, S)
                rs = rsa.get_algorithm(kind, name).schedule(p, S)
                for m in MS:
                    for comm in (False, True):
                        for passes in (False, True):
                            got = tune.schedule_features(
                                ts, m, 2.0, commutative=comm,
                                passes=passes)
                            want = rtune.schedule_features(
                                rs, m, 2.0, commutative=comm,
                                passes=passes)
                            assert got == want, (kind, name, p, S, m)


def test_simulated_sweep_equals_reference_sample_for_sample():
    truth = CostModel(alpha=3e-6, beta=1.0 / 40e9, gamma=2e-12)
    rtruth = rsa.CostModel(alpha=truth.alpha, beta=truth.beta,
                           gamma=truth.gamma)
    ps, ms = (2, 3, 5, 8), (512, 8192)
    got = tune.calibration_sweep("stacked", truth, ps=ps, ms=ms)
    want = rtune.calibration_sweep("stacked", rtruth, ps=ps, ms=ms)
    assert len(got) == len(want) == len(tune._sweep_cases(ps, ms))
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------


def test_fit_recovers_known_constants_p2_to_17():
    truth = CostModel(alpha=3.7e-6, beta=1.0 / 31e9, gamma=4.4e-12)
    samples = tune.calibration_sweep(
        "stacked", truth, ps=tuple(range(2, 18)), ms=(512, 8192, 131_072))
    fitted, resid = tune.fit_tier(samples)
    assert fitted.source == "calibrated"
    assert fitted.alpha == pytest.approx(truth.alpha, rel=0.05)
    assert fitted.beta == pytest.approx(truth.beta, rel=0.05)
    assert fitted.gamma == pytest.approx(truth.gamma, rel=0.05)
    assert resid < 0.05


def test_calibrated_profile_keeps_small_m_on_123():
    # auto's small-m decision under the port's own defaults, then under
    # a profile fitted from them: both keep the paper's 123
    for m in (8, 64):
        assert plan(ScanSpec(algorithm="auto"), p=36,
                    nbytes=m).algorithm == "123"
    prof = tune.calibrate(simulate=True, ps=(2, 3, 4, 8, 9, 16, 17),
                          ms=(512, 8192, 131_072))
    assert prof.source == "calibrated"
    assert prof.mesh_fingerprint == "simulated-default"
    assert [n for n, _ in prof.tiers] == ["stacked"]
    assert dict(prof.residuals)["stacked"] < 0.05
    for m in (8, 64):
        pl = plan(ScanSpec(algorithm="auto"), p=36, nbytes=m,
                  cost_model=prof.model("stacked"))
        assert pl.algorithm == "123", (m, pl.algorithm)
        assert pl.cost_model_source == "calibrated"


def test_provenance_record():
    prof = _profile(mesh_fingerprint="cuda-card-a2xb4",
                    residuals=(("stacked", 0.01),))
    assert prof.provenance() == {
        "source": "calibrated", "fingerprint": prof.fingerprint(),
        "mesh_fingerprint": "cuda-card-a2xb4",
        "fit_residuals": {"stacked": 0.01}}
    assert mesh_lib.DEFAULT_PROFILE.provenance("grid")[
        "mesh_fingerprint"] == "grid"


# ---------------------------------------------------------------------------
# The profile store
# ---------------------------------------------------------------------------


def test_profile_json_roundtrip(tmp_path):
    prof = _profile(mesh_fingerprint="cpu-test-data4",
                    residuals=(("stacked", 1.5e-9),))
    path = tune.save_profile(prof, str(tmp_path))
    assert path.endswith("profile_cpu-test-data4.json")
    loaded = tune.load_profile("cpu-test-data4", str(tmp_path))
    assert loaded == prof and loaded.fingerprint() == prof.fingerprint()
    assert tune.load_profile("other-grid", str(tmp_path)) is None
    assert tune.latest_profile(str(tmp_path)) == prof


def test_profile_schema_version_gate(tmp_path):
    path = tune.save_profile(_profile(mesh_fingerprint="m"), str(tmp_path))
    obj = json.load(open(path))
    obj["schema_version"] = PROFILE_SCHEMA_VERSION + 1
    with open(path, "w") as f:
        json.dump(obj, f)
    with pytest.raises(ValueError):
        CostProfile.from_json(obj)
    assert tune.load_profile("m", str(tmp_path)) is None


@pytest.mark.parametrize("text", [
    "{not json at all", "", '{"schema_version": 1}',
    '{"schema_version": 1, "tiers": "oops"}',
    '{"schema_version": 1, "tiers": [["stacked", 3]]}',
    '{"schema_version": "one", "tiers": {}}',
], ids=["syntax", "empty", "missing", "tiers-str", "model-int",
        "version-str"])
def test_load_profile_corrupted_store_returns_none(tmp_path, text):
    _store_file(tmp_path, "broken", text)
    assert tune.load_profile("broken", str(tmp_path)) is None


def test_truncated_profile_and_latest_skips_broken(tmp_path):
    path = tune.save_profile(_profile(mesh_fingerprint="trunc"),
                             str(tmp_path))
    body = open(path).read()
    with open(path, "w") as f:
        f.write(body[:len(body) // 2])
    assert tune.load_profile("trunc", str(tmp_path)) is None
    good = _profile(mesh_fingerprint="good")
    tune.save_profile(good, str(tmp_path))
    bad = _store_file(tmp_path, "newer-but-broken", "{garbage")
    future = time.time() + 60
    os.utime(bad, (future, future))
    assert tune.latest_profile(str(tmp_path)) == good


def test_profiles_carry_across_packages(tmp_path):
    mine = _profile(alpha=1.1e-4, mesh_fingerprint="cuda-card-n1",
                    residuals=(("stacked", 0.2),))
    theirs = rtune.load_profile_file(tune.save_profile(mine,
                                                       str(tmp_path)))
    assert theirs.to_json() == mine.to_json()
    ref = rsa.CostProfile(
        tiers=(("dci", rsa.CostModel(alpha=1e-5, source="calibrated")),
               ("ici", rsa.CostModel(alpha=1e-6, gamma_pass=3e-13,
                                     source="calibrated"))),
        source="calibrated", mesh_fingerprint="tpu-v5e",
        axis_tiers=(("pod", "dci"),), default_tier="ici",
        residuals=(("dci", 0.1), ("ici", 0.02)))
    back = tune.load_profile_file(rtune.save_profile(ref,
                                                     str(tmp_path / "r")))
    assert back.to_json() == ref.to_json()
    assert back.fingerprint() == ref.fingerprint()


def test_resolve_profile_order(tmp_path):
    d = str(tmp_path)
    grid = (("pod", 2), ("data", 4))
    fp = mesh_lib.mesh_fingerprint(grid, "cpu")
    assert fp == "cpu-cpu-pod2xdata4"
    assert mesh_lib.resolve_profile(grid, d, device="cpu") is \
        mesh_lib.DEFAULT_PROFILE
    _store_file(tmp_path, fp, "{garbage")  # broken: still the default
    assert mesh_lib.resolve_profile(grid, d, device="cpu") is \
        mesh_lib.DEFAULT_PROFILE
    sim = _profile(mesh_fingerprint="simulated-default")
    tune.save_profile(sim, d)
    assert mesh_lib.resolve_profile(grid, d, device="cpu") == sim
    exact = _profile(alpha=9e-6, mesh_fingerprint=fp)
    tune.save_profile(exact, d)
    assert mesh_lib.resolve_profile(grid, d, device="cpu") == exact
    assert mesh_lib.resolve_profile(fingerprint="nope", directory=d) == sim
    try:
        assert mesh_lib.use_calibrated_profile(grid, d, "cpu") == exact
        assert mesh_lib.current_profile() == exact
    finally:
        mesh_lib.install_profile(None)
    assert mesh_lib.current_profile() is mesh_lib.DEFAULT_PROFILE


def test_cli_simulate_writes_profile(tmp_path, capsys):
    rc = tune.main(["--simulate", "--out", str(tmp_path), "--ps", "2,3,8",
                    "--ms", "512,8192"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "stacked: alpha=" in out and "truth alpha=" in out
    prof = tune.load_profile("simulated-default", str(tmp_path))
    assert prof is not None and prof.source == "calibrated"


# ---------------------------------------------------------------------------
# The card: the walltime clock never falls back to the CPU
# ---------------------------------------------------------------------------


def test_walltime_clock_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sched = tsa.get_algorithm("exclusive", "123").schedule(4)
    with pytest.raises(RuntimeError):
        tune.measure_schedule_walltime(sched, 64)
    with pytest.raises(RuntimeError):
        tune.calibrate(simulate=False, ps=(4,), ms=(64,))
    with pytest.raises(RuntimeError):
        tune.local_device_fingerprint()
    with pytest.raises(RuntimeError):
        mesh_lib.mesh_fingerprint((("x", 4),))
    assert benchmeta.worker_platform() == "cpu"


def test_bench_metadata_and_host_twins():
    meta = benchmeta.bench_metadata()
    assert meta["meta_schema_version"] == 1
    assert set(meta) == {"meta_schema_version", "git_sha", "timestamp_utc",
                         "platform"}
    lengths = np.array([3, 1, 4, 1, 5])
    assert tsa.host_exscan(lengths).tolist() == [0, 3, 4, 8, 9]
    a, b = tsa.host_fused_exscan([lengths, np.ones((5, 2), np.int64)])
    assert a.tolist() == [0, 3, 4, 8, 9]
    assert b[:, 1].tolist() == [0, 1, 2, 3, 4]

