"""Online self-tuning: streaming cost-profile refits with drift gates.

The planner's α/β/γ constants decide which exscan algorithm runs: a
stale profile picks the wrong one across the mid-m winner map, and the
crossovers move whenever the fabric does.  :mod:`repro_torch.core.tune`
fits those constants offline; this module closes the loop online, as
the JAX package's ``core/autotune.py`` does:

    execute ──▶ collect_stats ──▶ reservoir ──▶ NNLS refit
                                                     │
            re-warmup ◀── cache invalidate ◀── drift gate ◀─┘
                                 │
                              install

Every real execution (a :class:`~repro_torch.serve.service.ScanService`
batch, a ``train.py`` probe, a :class:`~repro_torch.dist.WorkerPool`
run) feeds one :class:`~repro_torch.core.tune.Sample` (the IR's
features, priced as the planner prices them, and the measured seconds)
into a bounded per-tier reservoir.  Every ``refit_every`` executions the
controller re-runs the NNLS fit (:func:`tune.fit_tier`) and installs a
recalibrated :class:`~repro_torch.core.scan_api.CostProfile` only when
the fitted constants drift past a gate relative to the installed
profile AND the fit residual is under a quality gate.  The plan cache
keys on resolved constants, so an install changes every key; the
controller flushes the stale generation with ``plan_cache_resize()``,
whose return value is the count of plans the install dropped.
Subscribers (the serve layer) re-warm on an install.

On the dist tier, per-rank timings of a
:class:`~repro_torch.dist.WorkerPool` run feed a
:class:`StragglerDetector`: a rank persistently slower than the median
inflates the "dci" α (a synchronous round ends when its slowest rank
does), and :func:`replan_hierarchical` re-searches the p_inter ×
p_intra factorings under the inflated pricing.

Where the port differs from the JAX package:

* :meth:`AutoTuner.probe` runs on the CUDA card by default
  (``StackedExecutor()``), makes its payload on the executor's device
  outside the timed window, runs a schedule once untimed the first time
  it meets it (kernel loads and builds stay out of the fit), and ends
  its timed window with a synchronise of the device.
* :meth:`AutoTuner.record`'s ``tier=None`` means the profile's default
  tier ("stacked" under the port's default profile, "ici" under the JAX
  package's carried across).
* :attr:`AutoTuner.rejected` counts the recordings refused as foreign.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import monoid as monoid_lib
from repro_torch.core import scan_api
from repro_torch.core import schedule as schedule_lib
from repro_torch.core import tune
from repro_torch.core.scan_api import CostModel, CostProfile


# ---------------------------------------------------------------------------
# Drift gate + refit outcome
# ---------------------------------------------------------------------------


def relative_drift(old: CostModel, new: CostModel) -> float:
    """Symmetric relative change of the pricing constants, in [0, 1]:
    ``max over {α, β, γ} of |new − old| / max(|new|, |old|)`` (0/0
    counts as no drift).  A 4× shift scores 0.75."""
    drift = 0.0
    for a, b in ((old.alpha, new.alpha), (old.beta, new.beta),
                 (old.gamma, new.gamma)):
        denom = max(abs(a), abs(b))
        if denom > 0.0:
            drift = max(drift, abs(a - b) / denom)
    return drift


@dataclasses.dataclass(frozen=True)
class DriftGate:
    """When does a refit replace the installed profile?

    drift: minimum :func:`relative_drift` of any refitted tier against
      the installed profile (0.5 ≈ a 2× constant change).
    max_residual: the largest relative-RMS fit residual a tier may carry
      and still be trusted.
    min_samples: per-tier sample floor before fitting at all.
    """

    drift: float = 0.5
    max_residual: float = 0.25
    min_samples: int = 12


@dataclasses.dataclass(frozen=True)
class RefitResult:
    """One ``maybe_refit`` outcome (``AutoTuner.history`` keeps them).

    ``reason``: "installed", "stable" (fit fine, drift under the gate),
    "noisy" (residual over the gate), "no_samples" (no tier met the
    floor) or "not_due" (cadence not reached).  ``plans_dropped`` is the
    stale-plan count the install flushed (0 unless installed)."""

    installed: bool
    reason: str
    profile: CostProfile | None = None
    drift: tuple = ()  # ((tier, relative_drift), ...)
    residuals: tuple = ()  # ((tier, fit_residual), ...)
    plans_dropped: int = 0


# ---------------------------------------------------------------------------
# Straggler detection (dist tier)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StragglerReport:
    """Per-rank timing summary.  ``inflation`` is max smoothed per-rank
    seconds / median when some rank straggles, else 1.0."""

    rank_seconds: tuple
    median: float
    slow_ranks: tuple
    inflation: float

    @property
    def straggling(self) -> bool:
        return bool(self.slow_ranks)


class StragglerDetector:
    """EWMA per-rank execution times → :class:`StragglerReport`.

    A rank straggles when its smoothed time exceeds ``threshold ×`` the
    median of all smoothed times; the EWMA keeps one transient pause
    from flagging a rank while persistent slowness accumulates."""

    def __init__(self, *, threshold: float = 1.5, smoothing: float = 0.5):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        if not 0.0 < smoothing <= 1.0:
            raise ValueError(f"smoothing must be in (0, 1], "
                             f"got {smoothing}")
        self.threshold = float(threshold)
        self.smoothing = float(smoothing)
        self._ewma: dict[int, float] = {}

    def observe(self, rank_seconds) -> StragglerReport:
        """Fold one execution's per-rank seconds (global-rank order)
        into the smoothed state and report."""
        for rank, sec in enumerate(rank_seconds):
            prev = self._ewma.get(rank)
            self._ewma[rank] = float(sec) if prev is None else \
                (1 - self.smoothing) * prev + self.smoothing * float(sec)
        return self.report()

    def report(self) -> StragglerReport:
        if not self._ewma:
            return StragglerReport(rank_seconds=(), median=0.0,
                                   slow_ranks=(), inflation=1.0)
        ranks = sorted(self._ewma)
        secs = tuple(self._ewma[r] for r in ranks)
        med = float(np.median(secs))
        if med <= 0.0:
            return StragglerReport(rank_seconds=secs, median=med,
                                   slow_ranks=(), inflation=1.0)
        slow = tuple(r for r, s in zip(ranks, secs)
                     if s > self.threshold * med)
        inflation = max(1.0, max(secs) / med) if slow else 1.0
        return StragglerReport(rank_seconds=secs, median=med,
                               slow_ranks=slow, inflation=inflation)

    def reset(self):
        self._ewma.clear()


def straggler_adjusted_profile(profile: CostProfile,
                               report: StragglerReport, *,
                               tier: str = "dci") -> CostProfile:
    """``profile`` with ``tier``'s α inflated by ``report.inflation``
    (β and γ unchanged).  A profile without ``tier`` raises ``KeyError``
    when the report straggles."""
    if report.inflation <= 1.0:
        return profile
    cm = profile.model(tier)
    inflated = dataclasses.replace(cm, alpha=cm.alpha * report.inflation)
    tiers = tuple((name, inflated if name == tier else m)
                  for name, m in profile.tiers)
    return dataclasses.replace(profile, tiers=tiers)


def _factorings(p: int) -> list[tuple[int, int]]:
    return [(d, p // d) for d in range(1, p + 1) if p % d == 0]


def replan_hierarchical(spec, p: int, *, nbytes: int,
                        cost_model=None,
                        report: StragglerReport | None = None,
                        inter_axis: str = "proc",
                        intra_axis: str = "local"):
    """The cheapest :class:`~repro_torch.core.scan_api.ScanPlan` over
    every p_inter × p_intra factoring of ``p`` under (optionally
    straggler-inflated) pricing; the default pricing is the installed
    profile.  Single-level factorings (p_inter == 1 or p_intra == 1)
    are the flat plans over one axis and compete on equal terms."""
    if p < 1:
        raise ValueError(f"need p >= 1, got {p}")
    cm = cost_model
    if cm is None:
        from repro_torch.launch import mesh as mesh_lib  # lazy: no cycle

        cm = mesh_lib.current_profile()
    if report is not None and isinstance(cm, CostProfile):
        cm = straggler_adjusted_profile(cm, report)
    best = None
    for p_inter, p_intra in _factorings(p):
        if 1 in (p_inter, p_intra):
            axis = intra_axis if p_inter == 1 else inter_axis
            if isinstance(cm, CostProfile) and p_intra == 1 \
                    and inter_axis not in dict(cm.axis_tiers):
                prof = dataclasses.replace(
                    cm, axis_tiers=cm.axis_tiers + ((inter_axis,
                                                     "dci"),))
            else:
                prof = cm
            pl = scan_api.plan(spec.over(axis), p, nbytes=nbytes,
                               cost_model=prof)
        else:
            pl = scan_api.plan_hierarchical(
                spec, p_inter=p_inter, p_intra=p_intra, nbytes=nbytes,
                cost_model=cm, inter_axis=inter_axis,
                intra_axis=intra_axis)
        if best is None or pl.cost < best.cost:
            best = pl
    return best


# ---------------------------------------------------------------------------
# The streaming controller
# ---------------------------------------------------------------------------


class AutoTuner:
    """Streaming calibration controller: reservoirs → refit → gate →
    install → invalidate.

    Args:
      base: the profile the controller starts from and measures drift
        against (default: the installed launch-layer profile).  Its
        axis routing and default tier carry through every refit.
      gate: the :class:`DriftGate` thresholds.
      capacity: per-tier reservoir bound (a sliding window).
      refit_every: executions between ``maybe_refit`` attempts.
      install: when False the controller refits and gates but never
        touches the global profile or the plan cache (observe-only).
      straggler_threshold: slow-rank multiple for the dist tier's
        :class:`StragglerDetector`.
      mesh_fingerprint: the fingerprint of every refitted profile.
    """

    def __init__(self, base: CostProfile | None = None, *,
                 gate: DriftGate | None = None, capacity: int = 128,
                 refit_every: int = 16, install: bool = True,
                 straggler_threshold: float = 1.5,
                 mesh_fingerprint: str = "online"):
        if capacity < 1:
            raise ValueError(f"need capacity >= 1, got {capacity}")
        if refit_every < 1:
            raise ValueError(f"need refit_every >= 1, "
                             f"got {refit_every}")
        if base is None:
            from repro_torch.launch import mesh as mesh_lib  # lazy

            base = mesh_lib.current_profile()
        self.profile = base
        self.gate = gate or DriftGate()
        self.capacity = int(capacity)
        self.refit_every = int(refit_every)
        self.install_enabled = bool(install)
        self.mesh_fingerprint = mesh_fingerprint
        self.stragglers = StragglerDetector(
            threshold=straggler_threshold)
        self._reservoirs: dict[str, deque] = {}
        self._since_refit = 0
        self._subscribers: list = []
        self._warm: set = set()  # (schedule, monoid, shape, device) probed
        self.executions = 0
        self.rejected = 0
        self.refits = 0
        self.installs = 0
        self.plans_dropped = 0
        self.history: list[RefitResult] = []

    # -- sample intake -------------------------------------------------

    def reservoir(self, tier: str) -> deque:
        res = self._reservoirs.get(tier)
        if res is None:
            res = self._reservoirs[tier] = deque(maxlen=self.capacity)
        return res

    def reservoir_sizes(self) -> dict:
        return {t: len(r) for t, r in self._reservoirs.items()}

    def add_sample(self, sample: "tune.Sample"):
        """Feed one featurised sample row."""
        self.reservoir(sample.tier).append(sample)
        self.executions += 1
        self._since_refit += 1

    def record(self, sched_or_scheds, nbytes, seconds: float, *,
               tier: str | None = None, monoid="add",
               stats: "schedule_lib.CollectiveStats | None" = None,
               algorithm: str = "online", kind: str = "exclusive"):
        """Turn one measured execution into a reservoir sample.

        ``sched_or_scheds`` is the executed schedule, or the list a
        serial batch ran back to back with one payload size each; the
        features (:func:`tune.schedule_features`) are summed over them
        against the one measured ``seconds``.  A ``stats`` recording
        (``collect_stats()`` of this execution) whose rounds or ⊕ count
        differ from the IR's is refused (returns None) rather than
        poisoning the fit.  ``tier=None`` is the profile's default."""
        scheds = sched_or_scheds if isinstance(sched_or_scheds,
                                               (list, tuple)) \
            else [sched_or_scheds]
        sizes = nbytes if isinstance(nbytes, (list, tuple)) \
            else [nbytes] * len(scheds)
        if len(sizes) != len(scheds):
            raise ValueError(f"{len(scheds)} schedules but "
                             f"{len(sizes)} payload sizes")
        mono = monoid_lib.get(monoid)
        op_cost = getattr(mono, "op_cost", 1.0)
        hops = wire = op_bytes = 0.0
        rounds = ops = 0
        for sched, m in zip(scheds, sizes):
            h, w, ob = tune.schedule_features(
                sched, int(m), op_cost, commutative=mono.commutative)
            hops += h
            wire += w
            op_bytes += ob
            rounds += sched.rounds
            ops += sched.op_count(mono.commutative)
        if stats is not None and (stats.rounds != rounds
                                  or stats.op_applications != ops):
            self.rejected += 1
            return None  # a foreign recording: do not poison the fit
        sample = tune.Sample(
            tier=tier or self.profile.default_tier, kind=kind,
            algorithm=algorithm, p=scheds[0].p, nbytes=int(sum(sizes)),
            segments=max(s.n_segments for s in scheds),
            hops=hops, serial_bytes=wire, op_bytes=op_bytes,
            seconds=float(seconds), clock="online")
        self.add_sample(sample)
        return sample

    def observe_dist(self, result, sched, nbytes, *, monoid="add",
                     tier: str = "dci") -> StragglerReport:
        """Fold one :class:`~repro_torch.dist.DistResult` into the
        controller: the median of its repeats' walltimes becomes a
        ``tier`` sample, and its per-rank seconds (median over repeats;
        p entries, a block pool's ranks each their process's) feed the
        straggler detector."""
        self.record(sched, nbytes,
                    float(np.median(result.seconds)), tier=tier,
                    monoid=monoid, algorithm="dist", kind="exclusive")
        rank_seconds = getattr(result, "rank_seconds", None)
        if rank_seconds:
            per_rank = np.median(np.asarray(rank_seconds,
                                            dtype=np.float64), axis=0)
            return self.stragglers.observe(per_rank.tolist())
        return self.stragglers.report()

    def probe(self, spec, p, nbytes: int, *, executor=None,
              tier: str | None = None, agree=None):
        """Plan and time one standalone execution (the training step's
        scans run inside it, so the loop times the planned schedule
        beside it).  ``executor`` defaults to ``StackedExecutor()`` on
        the CUDA card; an ``SPMDExecutor`` (one rank a process) runs it
        over ``spec``'s axis of its mesh, each process its rank's row.
        The payload is made on its device before the clock starts, the
        first meeting with a schedule runs it once untimed, and the
        clock stops after a synchronise.  ``agree(seconds)``, where
        given, makes the seconds recorded the same on every process (the
        slowest's), so their reservoirs, refits and installs stay alike.
        Returns the executed plan."""
        pl = scan_api.plan(spec, p, nbytes=nbytes,
                           cost_model=self.profile)
        mono = monoid_lib.get(spec.monoid)
        if executor is None:
            executor = schedule_lib.StackedExecutor()
        rng = np.random.default_rng(self.executions)
        x = torch.from_numpy(
            rng.integers(0, 1 << 30, size=(pl.p, max(1, nbytes // 8)))
            .astype(np.int64)).to(executor.device)
        sched = run = pl.schedule()
        if isinstance(executor, schedule_lib.SPMDExecutor):
            x = x[executor.position(spec.axis_name)]
            if executor.mesh is not None:
                run = schedule_lib.on_mesh(sched, spec.axes, executor.mesh)
        key = (sched, mono.name, tuple(x.shape), str(executor.device))
        if key not in self._warm:
            executor.execute(run, x, mono)
            self._warm.add(key)
        device_lib.synchronize(executor.device)
        t0 = time.perf_counter()
        executor.execute(run, x, mono)
        device_lib.synchronize(executor.device)
        seconds = time.perf_counter() - t0
        if agree is not None:
            seconds = agree(seconds)
        self.record(sched, nbytes, seconds,
                    tier=tier or self.profile.tier_for_axis(
                        spec.axis_name),
                    monoid=spec.monoid, algorithm=pl.algorithm,
                    kind=spec.kind)
        return pl

    # -- refit + gate + install ----------------------------------------

    def subscribe(self, fn):
        """Register ``fn(profile)`` to run after every install."""
        self._subscribers.append(fn)
        return fn

    def maybe_refit(self, *, force: bool = False) -> RefitResult:
        """Refit when due; install only past the drift gate.  ``force``
        skips the cadence only; the gates always apply."""
        if not force and self._since_refit < self.refit_every:
            return self._log(RefitResult(installed=False,
                                         reason="not_due"))
        self._since_refit = 0
        fits: dict[str, tuple[CostModel, float]] = {}
        for tier, res in self._reservoirs.items():
            if len(res) >= self.gate.min_samples:
                fits[tier] = tune.fit_tier(list(res))
        if not fits:
            return self._log(RefitResult(installed=False,
                                         reason="no_samples"))
        self.refits += 1
        known = dict(self.profile.tiers)
        drift = tuple(sorted(
            (tier, relative_drift(known[tier], cm)
             if tier in known else 1.0)  # a new tier is always news
            for tier, (cm, _) in fits.items()))
        residuals = tuple(sorted((tier, resid)
                                 for tier, (_, resid) in fits.items()))
        worst_resid = max(r for _, r in residuals)
        if worst_resid > self.gate.max_residual:
            return self._log(RefitResult(
                installed=False, reason="noisy", drift=drift,
                residuals=residuals))
        if max(d for _, d in drift) < self.gate.drift:
            return self._log(RefitResult(
                installed=False, reason="stable", drift=drift,
                residuals=residuals))
        profile = self._build_profile(fits)
        dropped = self.install(profile)
        return self._log(RefitResult(
            installed=True, reason="installed", profile=profile,
            drift=drift, residuals=residuals, plans_dropped=dropped))

    def _build_profile(self, fits: dict) -> CostProfile:
        tiers = tuple(
            (name, fits[name][0] if name in fits else cm)
            for name, cm in self.profile.tiers)
        known = {name for name, _ in tiers}
        tiers += tuple(sorted(
            (name, cm) for name, (cm, _) in fits.items()
            if name not in known))
        residuals = dict(self.profile.residuals)
        residuals.update({t: r for t, (_, r) in fits.items()})
        return CostProfile(
            tiers=tiers, source="calibrated",
            mesh_fingerprint=self.mesh_fingerprint,
            axis_tiers=self.profile.axis_tiers,
            default_tier=self.profile.default_tier,
            residuals=tuple(sorted(residuals.items())))

    def install(self, profile: CostProfile) -> int:
        """Make ``profile`` the pricing everywhere at once: install it in
        the launch layer (every plan-cache key changes), flush the cache
        with ``plan_cache_resize`` and notify subscribers.  Returns the
        dropped-plan count (0 in observe-only mode)."""
        self.profile = profile
        dropped = 0
        if self.install_enabled:
            from repro_torch.launch import mesh as mesh_lib  # lazy

            mesh_lib.install_profile(profile)
            dropped = scan_api.plan_cache_resize(
                scan_api.plan_cache_info()["maxsize"]
                or scan_api.PLAN_CACHE_MAXSIZE)
        self.installs += 1
        self.plans_dropped += dropped
        for fn in self._subscribers:
            fn(profile)
        return dropped

    def _log(self, result: RefitResult) -> RefitResult:
        self.history.append(result)
        return result
