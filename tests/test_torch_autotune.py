"""Online autotuning (``repro_torch.core.autotune``) against the JAX
package's ``repro.core.autotune``.

Every case of ``tests/test_autotune.py`` runs on both packages (the
port's under the JAX package's default profile carried across through
``to_json``/``from_json``, its executor ``StackedExecutor("cpu")``).
Then the port is held against the reference directly: one stream of
samples gives the same refit decisions (drift, residuals and fitted
constants within 1e-9 relative), the straggler reports are equal,
``replan_hierarchical`` picks the same factoring and algorithm at the
same cost (1e-12 relative), an install drops as many plans as the
reference's for the same plan calls, ``benchmarks/autotune_bench.py``'s
scenario reaches the same outcomes under the simulated clock, and the
service's samples carry the reference's features batch for batch.
"""

import dataclasses
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from repro.core import autotune as r_at
from repro.core import monoid as r_monoid
from repro.core import scan_api as r_sa
from repro.core import schedule as r_sch
from repro.core import tune as r_tune
from repro.dist.launcher import DistResult as RDistResult
from repro.launch import mesh as r_mesh
from repro.serve import Bucket as RBucket
from repro.serve import ScanService as RScanService
from repro_torch.benchmarks import autotune_bench as t_bench
from repro_torch.core import autotune as t_at
from repro_torch.core import monoid as t_monoid
from repro_torch.core import scan_api as t_sa
from repro_torch.core import schedule as t_sch
from repro_torch.core import tune as t_tune
from repro_torch.dist.launcher import DistResult as TDistResult
from repro_torch.launch import mesh as t_mesh
from repro_torch.serve import Bucket as TBucket
from repro_torch.serve import ScanService as TScanService

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_BASE = r_mesh.DEFAULT_PROFILE
PORT_BASE = t_sa.CostProfile.from_json(REF_BASE.to_json())
CELLS = [(p, m) for p in (4, 8) for m in (512, 8192, 262_144)]


def _stats_of_reference(sched, x, monoid):
    with r_sch.collect_stats() as st:
        r_sch.SimulatorExecutor().execute(sched, x, monoid)
    return st


def _stats_of_port(sched, x, monoid):
    with t_sch.collect_stats() as st:
        t_sch.StackedExecutor("cpu").execute(sched, torch.from_numpy(x),
                                             monoid)
    return st


PKGS = {
    "jax": types.SimpleNamespace(
        at=r_at, sa=r_sa, sch=r_sch, tune=r_tune, mesh=r_mesh,
        monoid=r_monoid, BASE=REF_BASE, DistResult=RDistResult,
        run_stats=_stats_of_reference,
        service=lambda p, buckets, **kw: RScanService(p, buckets, **kw),
        Bucket=RBucket),
    "torch": types.SimpleNamespace(
        at=t_at, sa=t_sa, sch=t_sch, tune=t_tune, mesh=t_mesh,
        monoid=t_monoid, BASE=PORT_BASE, DistResult=TDistResult,
        run_stats=_stats_of_port,
        service=lambda p, buckets, **kw: TScanService(
            p, buckets, executor=t_sch.StackedExecutor("cpu"), **kw),
        Bucket=TBucket),
}


@pytest.fixture(params=sorted(PKGS))
def pk(request):
    return PKGS[request.param]


@pytest.fixture
def clean_globals():
    """Both packages' installed profile and plan cache, restored."""
    prev = (r_mesh.install_profile(None), t_mesh.install_profile(None))
    r_sa.plan_cache_clear()
    t_sa.plan_cache_clear()
    try:
        yield
    finally:
        r_mesh.install_profile(prev[0])
        t_mesh.install_profile(prev[1])
        r_sa.plan_cache_clear()
        t_sa.plan_cache_clear()


def _scale(cm, *, alpha=1.0, beta=1.0, gamma=1.0):
    return dataclasses.replace(cm, alpha=cm.alpha * alpha,
                               beta=cm.beta * beta,
                               gamma=cm.gamma * gamma)


def _feed(pk, tuner, truth, *, tier="ici", cells=CELLS, repeat=2):
    """``repeat`` passes over ``cells``: plans under the base profile,
    seconds priced under ``truth`` on the executed schedule's features
    (linear in the regressors, so NNLS recovers ``truth`` exactly)."""
    spec = pk.sa.ScanSpec(kind="exclusive", monoid="add")
    for _ in range(repeat):
        for p, m in cells:
            pl = pk.sa.plan(spec, p, nbytes=m, cost_model=pk.BASE)
            sched = pl.schedule()
            h, w, ob = pk.tune.schedule_features(sched, m,
                                                 commutative=True)
            seconds = truth.cost(hops=int(h), serial_bytes=w, ops=0,
                                 payload_bytes=0, op_bytes=ob)
            tuner.record(sched, m, seconds, tier=tier,
                         algorithm=pl.algorithm)


# ---------------------------------------------------------------------------
# tests/test_autotune.py's cases, on both packages
# ---------------------------------------------------------------------------


def test_relative_drift_metric(pk):
    cm = pk.BASE.model("ici")
    assert pk.at.relative_drift(cm, cm) == 0.0
    assert pk.at.relative_drift(cm, _scale(cm, alpha=4.0)) == \
        pytest.approx(0.75)
    assert pk.at.relative_drift(_scale(cm, alpha=4.0), cm) == \
        pytest.approx(0.75)
    zero = pk.sa.CostModel(alpha=0.0, beta=0.0, gamma=0.0)
    assert pk.at.relative_drift(zero, cm) == 1.0
    assert pk.at.relative_drift(zero, zero) == 0.0
    assert 0.0 <= pk.at.relative_drift(cm, _scale(cm, beta=1e6)) <= 1.0


def test_reservoir_is_bounded_sliding_window(pk):
    tuner = pk.at.AutoTuner(pk.BASE, capacity=4, install=False)
    for i in range(10):
        tuner.add_sample(pk.tune.Sample(
            tier="ici", kind="exclusive", algorithm="t", p=4,
            nbytes=64, segments=1, hops=2, serial_bytes=128.0,
            op_bytes=64.0, seconds=float(i), clock="online"))
    res = tuner.reservoir("ici")
    assert len(res) == 4
    assert [s.seconds for s in res] == [6.0, 7.0, 8.0, 9.0]
    assert tuner.executions == 10
    assert tuner.reservoir_sizes() == {"ici": 4}
    with pytest.raises(ValueError, match="capacity"):
        pk.at.AutoTuner(pk.BASE, capacity=0)


def test_refit_cadence_and_empty_reservoirs(pk):
    tuner = pk.at.AutoTuner(pk.BASE, refit_every=5, install=False)
    assert tuner.maybe_refit().reason == "not_due"
    res = tuner.maybe_refit(force=True)
    assert (res.installed, res.reason) == (False, "no_samples")
    tuner2 = pk.at.AutoTuner(pk.BASE, install=False,
                             gate=pk.at.DriftGate(min_samples=12))
    _feed(pk, tuner2, pk.BASE.model("ici"), cells=CELLS[:3], repeat=1)
    assert tuner2.maybe_refit(force=True).reason == "no_samples"


def test_stable_constants_never_install(pk):
    tuner = pk.at.AutoTuner(pk.BASE, capacity=12, install=False,
                            gate=pk.at.DriftGate(drift=0.3, min_samples=12))
    _feed(pk, tuner, pk.BASE.model("ici"))
    res = tuner.maybe_refit(force=True)
    assert (res.installed, res.reason) == (False, "stable")
    assert dict(res.drift)["ici"] < 0.3
    assert dict(res.residuals)["ici"] < 1e-6
    assert tuner.installs == 0 and tuner.refits == 1
    assert tuner.history[-1] is res


def test_drift_past_gate_installs_refit_and_notifies(pk):
    tuner = pk.at.AutoTuner(pk.BASE, capacity=12, install=False,
                            gate=pk.at.DriftGate(drift=0.3, min_samples=12))
    seen = []
    tuner.subscribe(seen.append)
    shifted = _scale(pk.BASE.model("ici"), alpha=4.0)
    _feed(pk, tuner, shifted)
    res = tuner.maybe_refit(force=True)
    assert (res.installed, res.reason) == (True, "installed")
    assert dict(res.drift)["ici"] == pytest.approx(0.75)
    fit = tuner.profile.model("ici")
    assert fit.alpha == pytest.approx(shifted.alpha, rel=1e-6)
    assert fit.beta == pytest.approx(shifted.beta, rel=1e-6)
    assert tuner.profile.source == "calibrated"
    assert tuner.profile.mesh_fingerprint == "online"
    assert tuner.profile.model("dci") == pk.BASE.model("dci")
    assert seen == [tuner.profile] and tuner.installs == 1
    assert pk.mesh.current_profile() is not tuner.profile


def test_noisy_fit_is_rejected(pk):
    tuner = pk.at.AutoTuner(pk.BASE, capacity=12, install=False,
                            gate=pk.at.DriftGate(max_residual=0.25,
                                                 min_samples=12))
    _feed(pk, tuner, _scale(pk.BASE.model("ici"), alpha=100.0, beta=100.0),
          cells=CELLS, repeat=1)
    _feed(pk, tuner, pk.BASE.model("ici"), cells=CELLS, repeat=1)
    res = tuner.maybe_refit(force=True)
    assert (res.installed, res.reason) == (False, "noisy")
    assert dict(res.residuals)["ici"] > 0.25
    assert tuner.installs == 0


def test_unknown_tier_is_always_news(pk):
    tuner = pk.at.AutoTuner(pk.BASE, capacity=12, install=False,
                            gate=pk.at.DriftGate(drift=0.5, min_samples=12))
    _feed(pk, tuner, pk.BASE.model("ici"), tier="pcie")
    res = tuner.maybe_refit(force=True)
    assert res.installed and dict(res.drift)["pcie"] == 1.0
    assert tuner.profile.model("pcie").alpha > 0
    assert [n for n, _ in tuner.profile.tiers[:2]] == \
        [n for n, _ in pk.BASE.tiers]


def test_record_rejects_foreign_stats_recording(pk):
    tuner = pk.at.AutoTuner(pk.BASE, install=False)
    pl = pk.sa.plan(pk.sa.ScanSpec(kind="exclusive", monoid="add"), 8,
                    nbytes=64, cost_model=pk.BASE)
    sched = pl.schedule()
    x = np.arange(8 * 8, dtype=np.int64).reshape(8, 8)
    st = pk.run_stats(sched, x, pk.monoid.ADD)
    s = tuner.record(sched, 64, 1e-5, stats=st)
    assert s is not None and len(tuner.reservoir("ici")) == 1
    wrong = pk.sch.CollectiveStats()
    wrong.rounds = sched.rounds + 1
    assert tuner.record(sched, 64, 1e-5, stats=wrong) is None
    assert len(tuner.reservoir("ici")) == 1
    if pk.at is t_at:
        assert tuner.rejected == 1
    with pytest.raises(ValueError, match="payload sizes"):
        tuner.record([sched, sched], [64], 1e-5)


def test_install_flushes_plan_cache_and_sets_global_profile(
        pk, clean_globals):
    with pk.sa.use_cost_model(pk.mesh.axis_cost_model):
        spec = pk.sa.ScanSpec(kind="exclusive", monoid="add")
        for m in (64, 4096, 262_144):
            pk.sa.plan(spec.over("pod"), 8, nbytes=m)
    cached = pk.sa.plan_cache_info()["size"]
    assert cached >= 3
    tuner = pk.at.AutoTuner(pk.BASE, install=True)
    shifted = dataclasses.replace(pk.BASE, tiers=tuple(
        (n, _scale(cm, alpha=4.0)) for n, cm in pk.BASE.tiers))
    dropped = tuner.install(shifted)
    assert dropped == cached
    assert pk.sa.plan_cache_info()["size"] == 0
    assert pk.mesh.current_profile() is shifted
    assert tuner.plans_dropped == cached and tuner.installs == 1


def test_straggler_detector_ewma_and_report(pk):
    det = pk.at.StragglerDetector(threshold=1.5, smoothing=1.0)
    rep = det.report()
    assert not rep.straggling and rep.inflation == 1.0
    rep = det.observe([1.0, 1.0, 1.0, 1.0])
    assert not rep.straggling and rep.slow_ranks == ()
    rep = det.observe([1.0, 1.0, 1.0, 3.0])
    assert rep.slow_ranks == (3,)
    assert rep.inflation == pytest.approx(3.0)
    assert rep.median == pytest.approx(1.0)
    det.reset()
    assert det.report().rank_seconds == ()
    det = pk.at.StragglerDetector(threshold=2.0, smoothing=0.25)
    det.observe([1.0, 1.0, 1.0, 1.0])
    rep = det.observe([1.0, 1.0, 1.0, 4.0])
    assert not rep.straggling
    for _ in range(8):
        rep = det.observe([1.0, 1.0, 1.0, 4.0])
    assert rep.slow_ranks == (3,)
    with pytest.raises(ValueError, match="threshold"):
        pk.at.StragglerDetector(threshold=1.0)
    with pytest.raises(ValueError, match="smoothing"):
        pk.at.StragglerDetector(smoothing=0.0)


def test_straggler_adjusted_profile_inflates_only_dci_alpha(pk):
    det = pk.at.StragglerDetector(threshold=1.5, smoothing=1.0)
    rep = det.observe([1.0, 1.0, 2.5, 1.0])
    adj = pk.at.straggler_adjusted_profile(pk.BASE, rep)
    assert adj.model("dci").alpha == pytest.approx(
        pk.BASE.model("dci").alpha * 2.5)
    assert adj.model("dci").beta == pk.BASE.model("dci").beta
    assert adj.model("ici") == pk.BASE.model("ici")
    calm = det.observe([1.0, 1.0, 1.0, 1.0])
    for _ in range(8):
        calm = det.observe([1.0, 1.0, 1.0, 1.0])
    assert pk.at.straggler_adjusted_profile(pk.BASE, calm) is pk.BASE


def test_replan_hierarchical_searches_factorings(pk):
    spec = pk.sa.ScanSpec(kind="exclusive", monoid="add")
    best = pk.at.replan_hierarchical(spec, 12, nbytes=262_144,
                                     cost_model=pk.BASE)
    assert best.p == 12
    for p_inter, p_intra in ((2, 6), (3, 4), (4, 3), (6, 2)):
        pinned = pk.sa.plan_hierarchical(
            spec, p_inter=p_inter, p_intra=p_intra, nbytes=262_144,
            cost_model=pk.BASE)
        assert best.cost <= pinned.cost, (p_inter, p_intra)
    flat = pk.at.replan_hierarchical(spec, 7, nbytes=4096,
                                     cost_model=pk.BASE)
    assert flat.p == 7 and not flat.algorithm.startswith("composite(")
    with pytest.raises(ValueError, match="p >= 1"):
        pk.at.replan_hierarchical(spec, 0, nbytes=64)


def test_replan_hierarchical_straggler_pressure(pk):
    spec = pk.sa.ScanSpec(kind="exclusive", monoid="add")
    det = pk.at.StragglerDetector(threshold=1.5, smoothing=1.0)
    rep = det.observe([1.0] * 11 + [50.0])
    calm_plan = pk.at.replan_hierarchical(spec, 12, nbytes=262_144,
                                          cost_model=pk.BASE)
    slow_plan = pk.at.replan_hierarchical(spec, 12, nbytes=262_144,
                                          cost_model=pk.BASE, report=rep)
    assert slow_plan.p == calm_plan.p == 12
    assert slow_plan.cost >= calm_plan.cost


def test_observe_dist_feeds_reservoir_and_stragglers(pk):
    tuner = pk.at.AutoTuner(pk.BASE, install=False, straggler_threshold=1.5)
    pl = pk.sa.plan(pk.sa.ScanSpec(kind="exclusive", monoid="add"), 4,
                    nbytes=64, cost_model=pk.BASE)
    res = pk.DistResult(
        outputs=None, seconds=[1e-3, 1.1e-3], stats=None, transport={},
        rank_seconds=[[1.0, 1.0, 1.0, 3.0], [1.0, 1.0, 1.0, 3.0]])
    rep = tuner.observe_dist(res, pl.schedule(), 64)
    assert len(tuner.reservoir("dci")) == 1
    assert tuner.reservoir("dci")[0].seconds == \
        pytest.approx(np.median(res.seconds))
    assert rep.slow_ranks == (3,)
    bare = pk.DistResult(outputs=None, seconds=[1e-3], stats=None,
                         transport={})
    rep = tuner.observe_dist(bare, pl.schedule(), 64)
    assert len(tuner.reservoir("dci")) == 2
    assert rep.slow_ranks == (3,)


def test_service_attach_autotuner_feeds_and_rewarm_on_install(
        pk, clean_globals):
    tuner = pk.at.AutoTuner(pk.BASE, capacity=12, refit_every=1000,
                            install=False,
                            gate=pk.at.DriftGate(drift=0.3, min_samples=12))
    svc = pk.service(8, [pk.Bucket(kind="exclusive", monoid="add", shape=(),
                                   dtype=np.int32)],
                     max_batch=4, cost_model=pk.BASE)
    svc.attach_autotuner(tuner)
    assert svc._autotune_tier == pk.BASE.tier_for_axis(None)
    svc.warmup()
    rng = np.random.default_rng(0)
    for _ in range(3):
        for _ in range(4):
            svc.submit(rng.integers(0, 9, size=(8,)).astype(np.int32))
        svc.drain()
    assert tuner.executions == 3
    assert svc.post_warmup_compiles == 0
    shifted = dataclasses.replace(pk.BASE, tiers=tuple(
        (n, _scale(cm, alpha=4.0)) for n, cm in pk.BASE.tiers))
    tuner.install(shifted)
    assert svc.cost_model is shifted
    for _ in range(4):
        svc.submit(rng.integers(0, 9, size=(8,)).astype(np.int32))
    svc.drain()
    assert svc.post_warmup_compiles == 0


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------


def _rel_close(a, b, rel):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


def _same_pairs(got, want, rel):
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert _rel_close(g, w, rel), (got, want)


def _sample_stream(seed=0):
    """Reference samples under three regimes: the base constants, dci
    and ici α × 4 (drift), then seconds with ±60 % noise (noisy)."""
    rng = np.random.default_rng(seed)
    spec = r_sa.ScanSpec(kind="exclusive", monoid="add")
    shifted = dataclasses.replace(REF_BASE, tiers=tuple(
        (n, _scale(cm, alpha=4.0)) for n, cm in REF_BASE.tiers))
    out = []
    for i in range(180):
        truth = REF_BASE if i < 60 else shifted
        tier = "dci" if i % 3 == 0 else "ici"
        p = int(rng.choice((4, 8, 12, 16)))
        m = int(rng.choice((512, 8192, 262_144, 1_048_576)))
        pl = r_sa.plan(spec, p, nbytes=m, cost_model=REF_BASE)
        h, w, ob = r_tune.schedule_features(pl.schedule(), m,
                                            commutative=True)
        seconds = truth.model(tier).cost(hops=int(h), serial_bytes=w,
                                         ops=0, payload_bytes=0,
                                         op_bytes=ob)
        if i >= 130:
            seconds *= 1.0 + 0.6 * (2 * rng.random() - 1)
        out.append(r_tune.Sample(
            tier=tier, kind="exclusive", algorithm=pl.algorithm, p=p,
            nbytes=m, segments=pl.segments, hops=h, serial_bytes=w,
            op_bytes=ob, seconds=seconds, clock="online"))
    return out


def test_refit_decisions_match_reference():
    kw = dict(capacity=24, refit_every=12, install=False,
              mesh_fingerprint="stream")
    ref = r_at.AutoTuner(REF_BASE, gate=r_at.DriftGate(drift=0.3), **kw)
    port = t_at.AutoTuner(PORT_BASE, gate=t_at.DriftGate(drift=0.3), **kw)
    assert ref.maybe_refit(force=True).reason == \
        port.maybe_refit(force=True).reason == "no_samples"
    for s in _sample_stream():
        ref.add_sample(s)
        port.add_sample(t_tune.Sample(**dataclasses.asdict(s)))
        r, t = ref.maybe_refit(), port.maybe_refit()
        assert (t.installed, t.reason, t.plans_dropped) == \
            (r.installed, r.reason, r.plans_dropped)
        _same_pairs(t.drift, r.drift, 1e-9)
        _same_pairs(t.residuals, r.residuals, 1e-9)
        if r.installed:
            assert [n for n, _ in t.profile.tiers] == \
                [n for n, _ in r.profile.tiers]
            for (_, tc), (_, rc) in zip(t.profile.tiers, r.profile.tiers):
                for f in ("alpha", "beta", "gamma"):
                    assert _rel_close(getattr(tc, f), getattr(rc, f), 1e-9)
            _same_pairs(t.profile.residuals, r.profile.residuals, 1e-9)
    reasons = {r.reason for r in ref.history}
    assert {"no_samples", "not_due", "installed", "noisy",
            "stable"} <= reasons, reasons
    assert (port.refits, port.installs) == (ref.refits, ref.installs)


@pytest.mark.parametrize("smoothing", (1.0, 0.5, 0.25))
def test_straggler_reports_match_reference(smoothing):
    rng = np.random.default_rng(int(smoothing * 100))
    ref = r_at.StragglerDetector(threshold=1.5, smoothing=smoothing)
    port = t_at.StragglerDetector(threshold=1.5, smoothing=smoothing)
    for i in range(40):
        secs = rng.uniform(1.0, 1.2, 8)
        if i >= 10:
            secs[5] *= 3.0
        r, t = ref.observe(secs.tolist()), port.observe(secs.tolist())
        assert (t.rank_seconds, t.median, t.slow_ranks, t.inflation,
                t.straggling) == (r.rank_seconds, r.median, r.slow_ranks,
                                  r.inflation, r.straggling)


def _factoring(pl):
    return (pl.algorithm, pl.p, pl.spec.axis_name,
            tuple((sp.algorithm, sp.p, sp.spec.axis_name)
                  for sp in pl.sub_plans))


@pytest.mark.parametrize("straggling", (False, True),
                         ids=("calm", "straggler"))
@pytest.mark.parametrize("p", (4, 8, 12, 16, 36))
def test_replan_hierarchical_matches_reference(p, straggling):
    rep = {}
    if straggling:
        secs = [1.0] * (p - 1) + [50.0]
        rep = {"r": r_at.StragglerDetector(smoothing=1.0).observe(secs),
               "t": t_at.StragglerDetector(smoothing=1.0).observe(secs)}
        assert rep["t"].inflation == rep["r"].inflation == 50.0
    for m in (8, 8192, 262_144, 1_048_576):
        r = r_at.replan_hierarchical(
            r_sa.ScanSpec(kind="exclusive", monoid="add"), p, nbytes=m,
            cost_model=REF_BASE, report=rep.get("r"))
        t = t_at.replan_hierarchical(
            t_sa.ScanSpec(kind="exclusive", monoid="add"), p, nbytes=m,
            cost_model=PORT_BASE, report=rep.get("t"))
        assert _factoring(t) == _factoring(r), (p, m)
        assert _rel_close(t.cost, r.cost, 1e-12), (p, m, t.cost, r.cost)
        # every two-level factoring it searched prices alike too
        r_prof, t_prof = REF_BASE, PORT_BASE
        if straggling:
            r_prof = r_at.straggler_adjusted_profile(REF_BASE, rep["r"])
            t_prof = t_at.straggler_adjusted_profile(PORT_BASE, rep["t"])
        for p_inter, p_intra in t_at._factorings(p):
            if 1 in (p_inter, p_intra):
                continue
            r = r_sa.plan_hierarchical(
                r_sa.ScanSpec(kind="exclusive", monoid="add"),
                p_inter=p_inter, p_intra=p_intra, nbytes=m,
                cost_model=r_prof)
            t = t_sa.plan_hierarchical(
                t_sa.ScanSpec(kind="exclusive", monoid="add"),
                p_inter=p_inter, p_intra=p_intra, nbytes=m,
                cost_model=t_prof)
            assert _factoring(t) == _factoring(r), (p_inter, p_intra, m)
            assert _rel_close(t.cost, r.cost, 1e-12)


def test_straggler_pricing_needs_a_dci_tier():
    rep = t_at.StragglerDetector(smoothing=1.0).observe([1.0, 1.0, 9.0])
    spec = t_sa.ScanSpec(kind="exclusive", monoid="add")
    # the port's default profile has one tier, "stacked": as the
    # reference under a profile without "dci", pricing a straggler raises
    with pytest.raises(KeyError, match="dci"):
        t_at.straggler_adjusted_profile(t_mesh.DEFAULT_PROFILE, rep)
    with pytest.raises(KeyError, match="dci"):
        t_at.replan_hierarchical(spec, 12, nbytes=64,
                                 cost_model=t_mesh.DEFAULT_PROFILE,
                                 report=rep)
    assert t_at.AutoTuner(t_mesh.DEFAULT_PROFILE, install=False).record(
        t_sa.plan(spec, 4, nbytes=64).schedule(), 64, 1e-5).tier == "stacked"


def _plan_calls(sa, mesh, base):
    """One fixed sequence of plan calls, priced through the launch
    layer's per-axis resolver under ``base`` installed."""
    mesh.install_profile(base)
    with sa.use_cost_model(mesh.axis_cost_model):
        for axis in (None, "pod"):
            for kind in ("exclusive", "scan_total"):
                spec = sa.ScanSpec(kind=kind, monoid="add")
                for p in (4, 8, 12):
                    for m in (64, 4096, 262_144):
                        sa.plan(spec.over(axis), p, nbytes=m)
                        sa.plan(spec.over(axis), p, nbytes=m)  # a hit
        sa.plan_hierarchical(sa.ScanSpec(kind="exclusive", monoid="add"),
                             p_inter=2, p_intra=4, nbytes=8192)
        sa.plan_fused([sa.ScanSpec(kind="exclusive", monoid="add")] * 3, 8,
                      [64] * 3)


def test_install_drops_the_reference_count(clean_globals):
    _plan_calls(r_sa, r_mesh, REF_BASE)
    _plan_calls(t_sa, t_mesh, PORT_BASE)
    cached = r_sa.plan_cache_info()["size"]
    assert t_sa.plan_cache_info()["size"] == cached > 0
    r_drop = r_at.AutoTuner(REF_BASE).install(dataclasses.replace(
        REF_BASE, mesh_fingerprint="x"))
    t_drop = t_at.AutoTuner(PORT_BASE).install(dataclasses.replace(
        PORT_BASE, mesh_fingerprint="x"))
    assert t_drop == r_drop == cached
    assert t_sa.plan_cache_info()["size"] == 0


# -- benchmarks/autotune_bench.py's scenario under the simulated clock, ------
# -- against the port's repro_torch.benchmarks.autotune_bench ---------------


def _bench():
    spec = importlib.util.spec_from_file_location(
        "autotune_bench", ROOT / "benchmarks" / "autotune_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("drift", (True, False), ids=("drift", "stable"))
def test_autotune_bench_scenario_matches_reference(drift, clean_globals):
    b = _bench()
    try:
        want = b.run_scenario(drift=drift)
    finally:
        r_sa.plan_cache_clear()
    got = t_bench.run_scenario(drift=drift, base=PORT_BASE)
    assert got["installs"] == want["installs"]
    assert got["refits"] == want["refits"]
    assert got["plans_dropped"] == want["plans_dropped"]
    for g, w in zip(got["install_log"], want["install_log"]):
        assert (g["execution"], g["plans_dropped"]) == \
            (w["execution"], w["plans_dropped"])
        for key in ("drift", "residuals"):
            assert g[key].keys() == w[key].keys()
            for tier in g[key]:
                assert _rel_close(g[key][tier], w[key][tier], 1e-9) or \
                    abs(g[key][tier] - w[key][tier]) < 1e-12
    if drift:
        assert got["installs"] >= 1 and got["plans_dropped"] > 0
        assert (got["pinned_cell"]["pre"], got["pinned_cell"]["post"]) == \
            (b.PIN_PRE, b.PIN_POST) == (want["pinned_cell"]["pre"],
                                        want["pinned_cell"]["post"])
        assert 1.0 - 1e-9 <= got["walltime_ratio"] <= \
            1.0 + b.WALLTIME_TOLERANCE
        assert _rel_close(got["walltime_ratio"], want["walltime_ratio"],
                          1e-9)
    else:
        assert got["installs"] == 0 and got["refits"] >= 1


def test_service_samples_match_reference(clean_globals):
    """The same submissions through both services, with a tuner each:
    every batch lands one sample, with the reference's features."""
    tuners, services = {}, {}
    for name, pk in PKGS.items():
        tuners[name] = pk.at.AutoTuner(pk.BASE, refit_every=1000,
                                       install=False)
        services[name] = pk.service(
            8, [pk.Bucket(kind="exclusive", monoid="add", shape=(),
                          dtype=np.int32),
                pk.Bucket(kind="scan_total", monoid="add", shape=(3,),
                          dtype=np.int32)],
            max_batch=4, cost_model=pk.BASE)
        services[name].attach_autotuner(tuners[name])
        services[name].warmup()
    rng = np.random.default_rng(7)
    batches = 0
    for k_ex, k_tot in ((1, 0), (3, 2), (4, 4), (2, 1), (6, 0)):
        xs = [rng.integers(0, 99, size=(8,)).astype(np.int32)
              for _ in range(k_ex)]
        ts = [rng.integers(0, 99, size=(8, 3)).astype(np.int32)
              for _ in range(k_tot)]
        for svc in services.values():
            for x in xs:
                svc.submit(x)
            for x in ts:
                svc.submit(x, kind="scan_total")
            svc.drain()
        batches += -(-k_ex // 4) + -(-k_tot // 4)
    fields = ("tier", "kind", "algorithm", "p", "nbytes", "segments",
              "hops", "serial_bytes", "op_bytes", "clock")
    got = [tuple(getattr(s, f) for f in fields)
           for t in tuners["torch"]._reservoirs.values() for s in t]
    want = [tuple(getattr(s, f) for f in fields)
            for t in tuners["jax"]._reservoirs.values() for s in t]
    assert got == want and len(got) == batches
    assert tuners["torch"].executions == batches
    assert tuners["torch"].rejected == 0
    assert all(s.seconds > 0 for t in tuners["torch"]._reservoirs.values()
               for s in t)
    assert services["torch"].post_warmup_compiles == 0
