"""Cost-model calibration of the "stacked" tier: measure, fit, persist.

The paper's empirical point is that *measured* crossovers decide which
exscan algorithm wins on a machine.  This module turns the planner's
default α/β/γ into a calibrated, provenance-carrying
:class:`~repro_torch.core.scan_api.CostProfile`, as the JAX package's
``core/tune.py`` does for its mesh:

  1. **Measure** every registered algorithm's schedule over a
     (p × payload-bytes) sweep, on one of two clocks:

       * ``walltime`` — :class:`~repro_torch.core.schedule
         .StackedExecutor` on the CUDA card, the host clock around a
         call that ends in a synchronise (:func:`measure_schedule_walltime`);
       * ``simulated`` — the schedule run by ``StackedExecutor("cpu")``
         under ``collect_stats()``, seconds priced from the *measured*
         hop/byte/⊕ counts under a ground-truth cost model
         (:func:`measure_schedule_simulated`): device-free and
         reproducible, so the fit is testable on the CPU.

  2. **Fit** α, β, γ ≥ 0 by non-negative least squares (:func:`nnls`)
     of the seconds against the IR's features (:func:`fit_tier`).

  3. **Persist** profiles as JSON keyed by fingerprint, in the JAX
     package's schema (:func:`save_profile`, :func:`load_profile`);
     ``launch.mesh.resolve_profile`` prefers a stored profile.

On the card::

    PYTHONPATH=src python -m repro_torch.core.tune
    # times the sweep, fits the "stacked" tier, writes
    # tune/profiles/torch/profile_<card fingerprint>.json

and device-free: ``python -m repro_torch.core.tune --simulate``.

The cross-process "dci" tier (:func:`calibrate_dist`) is fitted from
schedules timed across a :class:`~repro_torch.dist.WorkerPool`, one
rank a process (gloo; on one card every message is staged through
pinned host memory)::

    PYTHONPATH=src python -m repro_torch.core.tune --dist 8
    # writes tune/profiles/torch/profile_dist-cuda-procs8x1.json
    PYTHONPATH=src python -m repro_torch.core.tune --dist 4 --backend nccl
    # one process a card: the cross-card tier, written to
    # tune/profiles/torch/profile_dist-cuda-nccl-cards4-procs4x1.json

Neither installs the profile it fits.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import time

import numpy as np
import torch

from repro_torch.core import monoid as monoid_lib
from repro_torch.core import scan_api
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.scan_api import CostModel, CostProfile

# The JAX package's default sweep: p values straddle powers of two (the
# 123/two_op boundary cases) and m spans the α- to β-dominated regimes.
# Payload sizes are multiples of 512 bytes, so every power-of-two S ≤ 64
# divides the int64 element count (measured bytes == ceil(m/S)).
DEFAULT_PS = (2, 3, 4, 5, 7, 8, 9, 12, 16, 17)
DEFAULT_MS = (512, 8192, 131_072, 1_048_576)
RING_SEGMENTS = (1, 8, 64)

# The port's own store, beside the JAX package's tune/profiles, so that a
# profile of that package's tiers never resolves for the card.
DEFAULT_PROFILE_DIR = os.path.join("tune", "profiles", "torch")


# ---------------------------------------------------------------------------
# Non-negative least squares (Lawson–Hanson active set)
# ---------------------------------------------------------------------------


def nnls(A, b, *, max_iter: int | None = None,
         tol: float = 1e-12) -> np.ndarray:
    """Solve ``min ||Ax - b||`` subject to ``x >= 0``.

    The Lawson–Hanson active-set method, for the fit's few unknowns."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    n = A.shape[1]
    if max_iter is None:
        max_iter = 3 * n + 30
    x = np.zeros(n)
    passive = np.zeros(n, dtype=bool)
    w = A.T @ (b - A @ x)
    for _ in range(max_iter):
        if passive.all() or w[~passive].max(initial=-np.inf) <= tol:
            break
        j = int(np.argmax(np.where(passive, -np.inf, w)))
        passive[j] = True
        while True:
            z = np.zeros(n)
            cols = np.flatnonzero(passive)
            sol, *_ = np.linalg.lstsq(A[:, cols], b, rcond=None)
            z[cols] = sol
            if (z[cols] > tol).all():
                x = z
                break
            # step toward z until the first passive coordinate hits 0
            neg = cols[z[cols] <= tol]
            alpha = min(x[k] / (x[k] - z[k]) for k in neg
                        if x[k] != z[k])
            x = x + alpha * (z - x)
            passive &= x > tol
            if not passive.any():
                x = np.zeros(n)
                break
        w = A.T @ (b - A @ x)
    return np.maximum(x, 0.0)


# ---------------------------------------------------------------------------
# Features: the IR-derived regressors the fit prices seconds against
# ---------------------------------------------------------------------------


def schedule_features(sched: "schedule_lib.Schedule", nbytes: int,
                      op_cost: float = 1.0, *,
                      commutative: bool = False,
                      passes: bool = False) -> tuple:
    """(latency_hops, serial_bytes, op_bytes) counted off the IR, by the
    planner's pricing conventions: all-gathers cost p−1 hops and p·m
    wire bytes, a pipelined-ring round carries ⌈m/S⌉ bytes, the γ
    regressor is the ⊕ byte law times the monoid's op cost, with the
    commutative combine-order elision.  ``passes=True`` appends
    ``pass_bytes``, the round kernels' HBM-pass byte law, which a
    nonzero ``CostModel.gamma_pass`` prices."""
    p = sched.p
    hops = 0.0
    wire = 0.0
    for st in sched.steps:
        if st.is_round:
            hops += 1
            wire += schedule_lib.step_wire_bytes(st, nbytes,
                                                 sched.n_segments)
        elif st.kind in ("allgather", "bcast"):
            hops += p - 1
            wire += p * nbytes
    op_bytes = schedule_lib.op_wire_bytes(sched, nbytes,
                                          commutative) * op_cost
    if passes:
        pass_bytes = schedule_lib.pass_wire_bytes(sched, nbytes,
                                                  commutative)
        return hops, wire, op_bytes, pass_bytes
    return hops, wire, op_bytes


@dataclasses.dataclass(frozen=True)
class Sample:
    """One timed schedule execution: features + the clock reading."""

    tier: str
    kind: str
    algorithm: str
    p: int
    nbytes: int
    segments: int
    hops: float
    serial_bytes: float
    op_bytes: float
    seconds: float
    clock: str  # "simulated" | "walltime"


def _witness(p: int, nbytes: int, seed: int = 0) -> np.ndarray:
    if nbytes % 8:
        raise ValueError(f"payload bytes must be a multiple of 8 "
                         f"(int64 add witness), got {nbytes}")
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 30,
                        size=(p, nbytes // 8)).astype(np.int64)


def measure_schedule_simulated(
        sched: "schedule_lib.Schedule", nbytes: int,
        truth: CostModel, *, monoid="add",
        seed: int = 0) -> tuple[float, tuple[float, float, float]]:
    """Run ``sched`` with ``StackedExecutor("cpu")`` and read the
    simulated clock: ``truth`` priced on the *measured* hop/byte/⊕
    counts of the run.  Returns ``(seconds, measured_features)``; any
    drift between the IR and the run shows up as fit residual."""
    m = monoid_lib.get(monoid)
    x = _witness(sched.p, nbytes, seed)
    with schedule_lib.collect_stats() as st:
        schedule_lib.StackedExecutor("cpu").execute(sched, x, m)
    seg = max((s.seg or sched.n_segments for s in sched.steps
               if s.kind == "seg_shift"), default=1)
    hops = st.rounds + (sched.p - 1) * st.allgathers
    wire = sum(st.bytes_per_round) + st.allgathers * sched.p * nbytes
    # measured ⊕ counts × the IR's per-⊕ byte law (verify_plan holds
    # the executor to op_count ⊕ a step)
    op_bytes = schedule_lib.op_wire_bytes(
        sched, nbytes, m.commutative) * m.op_cost
    seconds = truth.cost(
        hops=hops, serial_bytes=wire, ops=st.op_applications,
        payload_bytes=-(-nbytes // seg), op_cost=m.op_cost,
        op_bytes=op_bytes)
    return seconds, (float(hops), float(wire), float(op_bytes))


def measure_schedule_walltime(
        sched: "schedule_lib.Schedule", nbytes: int, *, monoid="add",
        repeats: int = 5, seed: int = 0) -> float:
    """Median seconds of ``repeats`` runs of ``sched`` by
    ``StackedExecutor`` on the CUDA card, after one warm-up run: the
    host clock around ``execute`` plus ``torch.cuda.synchronize``, so
    the host's issue cost of each round is in it, as in the scan
    latency the planner serves.  Raises when no card is present."""
    ex = schedule_lib.StackedExecutor()  # the card, or raise
    m = monoid_lib.get(monoid)
    x = torch.from_numpy(_witness(sched.p, nbytes, seed)).to(ex.device)
    ex.execute(sched, x, m)
    torch.cuda.synchronize(ex.device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        ex.execute(sched, x, m)
        torch.cuda.synchronize(ex.device)
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def _sweep_cases(ps, ms):
    """(kind, algorithm, p, m, segments) cells of one tier's sweep:
    every registered exclusive algorithm (the ring at several pinned
    segment counts) plus the allreduce butterfly for feature spread."""
    cases = []
    for p in ps:
        for m in ms:
            for name in scan_api.algorithms("exclusive"):
                algo = scan_api.get_algorithm("exclusive", name)
                if algo.segmentable:
                    elems = max(1, m // 8)
                    ss = sorted({min(S, elems) for S in RING_SEGMENTS})
                    cases.extend(("exclusive", name, p, m, S)
                                 for S in ss)
                else:
                    cases.append(("exclusive", name, p, m, 1))
            for name in scan_api.algorithms("allreduce"):
                cases.append(("allreduce", name, p, m, 1))
    return cases


def calibration_sweep(tier: str, truth: CostModel, *,
                      ps=DEFAULT_PS, ms=DEFAULT_MS,
                      clock: str = "simulated", monoid="add",
                      repeats: int = 5) -> list[Sample]:
    """Time every registered algorithm's schedule over the (p × m)
    sweep on one tier; returns the fit's :class:`Sample` rows.
    ``repeats`` is the walltime clock's."""
    mono = monoid_lib.get(monoid)
    samples = []
    for kind, name, p, m, S in _sweep_cases(ps, ms):
        sched = scan_api.get_algorithm(kind, name).schedule(p, S)
        feats = schedule_features(sched, m, mono.op_cost,
                                  commutative=mono.commutative)
        if clock == "simulated":
            seconds, measured = measure_schedule_simulated(
                sched, m, truth, monoid=monoid)
        elif clock == "walltime":
            seconds, measured = measure_schedule_walltime(
                sched, m, monoid=monoid, repeats=repeats), feats
        else:
            raise ValueError(f"unknown clock {clock!r}")
        samples.append(Sample(
            tier=tier, kind=kind, algorithm=name, p=p, nbytes=m,
            segments=S, hops=measured[0], serial_bytes=measured[1],
            op_bytes=measured[2], seconds=seconds, clock=clock))
    return samples


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------


def fit_tier(samples: list[Sample]) -> tuple[CostModel, float]:
    """Fit one tier's (α, β, γ) by NNLS of seconds against the
    hop/byte/⊕-byte features; returns the calibrated kernel and the
    relative RMS residual."""
    if not samples:
        raise ValueError("fit_tier needs at least one sample")
    A = np.array([[s.hops, s.serial_bytes, s.op_bytes]
                  for s in samples], dtype=np.float64)
    b = np.array([s.seconds for s in samples], dtype=np.float64)
    # column scaling: hops ~ 1e1 while byte columns reach 1e7
    scale = np.linalg.norm(A, axis=0)
    scale[scale == 0] = 1.0
    x = nnls(A / scale, b) / scale
    resid = float(np.linalg.norm(A @ x - b)
                  / max(np.linalg.norm(b), 1e-300))
    return CostModel(alpha=float(x[0]), beta=float(x[1]),
                     gamma=float(x[2]), source="calibrated"), resid


def fit_profile(samples_by_tier: dict, *, mesh_fingerprint: str,
                axis_tiers=(), default_tier: str = "stacked"
                ) -> CostProfile:
    """Fit every tier and assemble the calibrated :class:`CostProfile`
    with its per-tier relative-RMS residuals."""
    tiers, residuals = [], []
    for tier in sorted(samples_by_tier):
        cm, resid = fit_tier(samples_by_tier[tier])
        tiers.append((tier, cm))
        residuals.append((tier, resid))
    return CostProfile(
        tiers=tuple(tiers), source="calibrated",
        mesh_fingerprint=mesh_fingerprint,
        axis_tiers=tuple(axis_tiers), default_tier=default_tier,
        residuals=tuple(residuals))


def calibrate(*, simulate: bool = True, truth: CostProfile | None = None,
              ps=DEFAULT_PS, ms=DEFAULT_MS,
              mesh_fingerprint: str | None = None, monoid="add",
              repeats: int = 5) -> CostProfile:
    """Sweep, fit, and return the :class:`CostProfile`.

    ``simulate=True`` reads the simulated clock under ``truth`` (default:
    the port's ``launch.mesh.DEFAULT_PROFILE``), one sweep per tier.
    ``simulate=False`` times the sweep on the CUDA card (the ranks of
    every p stack on the one card) and fits its samples into every tier
    of ``truth``, the "stacked" one by default."""
    if truth is None:
        from repro_torch.launch import mesh as mesh_lib  # lazy: no cycle

        truth = mesh_lib.DEFAULT_PROFILE
    if simulate:
        samples = {tier: calibration_sweep(
            tier, cm, ps=ps, ms=ms, clock="simulated", monoid=monoid)
            for tier, cm in truth.tiers}
        fp = mesh_fingerprint or "simulated-default"
    else:
        local = calibration_sweep(
            truth.default_tier, truth.model(truth.default_tier),
            ps=ps, ms=ms, clock="walltime", monoid=monoid,
            repeats=repeats)
        samples = {tier: [dataclasses.replace(s, tier=tier)
                          for s in local]
                   for tier, _ in truth.tiers}
        fp = mesh_fingerprint or local_device_fingerprint()
    return fit_profile(samples, mesh_fingerprint=fp,
                       axis_tiers=truth.axis_tiers,
                       default_tier=truth.default_tier)


def local_device_fingerprint() -> str:
    """The card's name and the card count, sanitised (raises when no
    card is present)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present to fingerprint")
    return _sanitize(f"cuda-{torch.cuda.get_device_name(0)}"
                     f"-n{torch.cuda.device_count()}")


# ---------------------------------------------------------------------------
# Cross-process ("dci" tier) calibration through the worker pool
# ---------------------------------------------------------------------------

DIST_MS = (8192, 131_072, 1_048_576)
HOP_SIZES = (8, 8192, 131_072, 1_048_576)


def dist_fingerprint(nprocs: int, ranks_per_proc: int,
                     platform: str = "cpu", backend: str = "gloo",
                     cards: int = 1) -> str:
    """Profile-store key of a multi-process topology on ``platform``
    ("cuda" or "cpu"), distinct from every single-process fingerprint;
    the cross-card tier (``nccl``, one process a card) names its backend
    and card count."""
    if backend == "nccl":
        return _sanitize(f"dist-{platform}-nccl-cards{cards}-procs{nprocs}"
                         f"x{ranks_per_proc}")
    return _sanitize(f"dist-{platform}-procs{nprocs}x{ranks_per_proc}")


def measure_schedule_dist(pool, sched: "schedule_lib.Schedule",
                          nbytes: int, *, monoid="add",
                          repeats: int = 3, seed: int = 0) -> float:
    """Median walltime of ``sched`` run across ``pool``'s processes
    (:class:`repro_torch.dist.WorkerPool`; each repeat the slowest
    rank's seconds): the clock of real inter-process hops."""
    x = _witness(sched.p, nbytes, seed)
    res = pool.run(sched, x, monoid=monoid, collect=False,
                   repeats=repeats)
    return float(np.median(res.seconds))


def measure_hops(pool, *, sizes=HOP_SIZES, repeats: int = 10) -> list:
    """One-way hop seconds between processes 0 and 1 over a payload-size
    sweep (``pool.measure_hop``): rows of ``{"nbytes", "seconds"}``, the
    raw latency evidence of the "dci" tier."""
    return [{"nbytes": int(n),
             "seconds": pool.measure_hop(int(n), repeats=repeats)}
            for n in sizes]


def calibration_sweep_dist(pool, *, ms=DIST_MS, monoid="add",
                           repeats: int = 3,
                           tier: str = "dci") -> list[Sample]:
    """Time every registered exclusive algorithm (and the allreduce
    butterfly) across the pool at its p = nprocs·p_intra ranks (over a
    block pool a round mixes rows that stay in a process with rows that
    cross); the rows feed :func:`fit_tier` for the cross-process
    tier."""
    mono = monoid_lib.get(monoid)
    op_cost = getattr(mono, "op_cost", 1.0)
    samples = []
    for kind, name, _, m, S in _sweep_cases((pool.p,), ms):
        sched = scan_api.get_algorithm(kind, name).schedule(pool.p, S)
        feats = schedule_features(sched, m, op_cost,
                                  commutative=mono.commutative)
        seconds = measure_schedule_dist(pool, sched, m, monoid=monoid,
                                        repeats=repeats)
        samples.append(Sample(
            tier=tier, kind=kind, algorithm=name, p=pool.p, nbytes=m,
            segments=S, hops=feats[0], serial_bytes=feats[1],
            op_bytes=feats[2], seconds=seconds, clock="dist"))
    return samples


def calibrate_dist(pool=None, *, nprocs: int = 2,
                   ranks_per_proc: int = 1, ms=DIST_MS, monoid="add",
                   repeats: int = 3, base: CostProfile | None = None,
                   device=None, backend: str = "gloo") -> CostProfile:
    """Fit the "dci" tier from schedules timed across worker processes.

    Without ``pool`` one is made of ``nprocs`` processes of
    ``ranks_per_proc`` ranks each on ``device`` (the card by default)
    over ``backend`` and closed after.  The local
    tier is ``base``'s default tier (default: the port's profile, whose
    one tier is "stacked"), carried over under its own name as the
    default tier, since a process's rounds never cross the pool.  The
    fingerprint names the pool's platform and topology
    (:func:`dist_fingerprint`; under nccl also its backend and card
    count), and ``axis_tiers`` routes the "proc" axis to the fitted
    tier.  Nothing is installed: the caller stores or installs it."""
    if base is None:
        from repro_torch.launch import mesh as mesh_lib  # lazy: no cycle

        base = mesh_lib.DEFAULT_PROFILE
    own_pool = pool is None
    if own_pool:
        from repro_torch.dist.launcher import WorkerPool

        pool = WorkerPool(nprocs, backend=backend, device=device,
                          p_intra=ranks_per_proc)
    try:
        samples = calibration_sweep_dist(pool, ms=ms, monoid=monoid,
                                         repeats=repeats)
        dci, resid = fit_tier(samples)
        fp = dist_fingerprint(pool.nprocs, pool.p_intra, pool.platform,
                              pool.backend, pool.cards)
    finally:
        if own_pool:
            pool.close()
    local = base.default_tier
    routing = dict(base.axis_tiers)
    routing["proc"] = "dci"
    return CostProfile(
        tiers=(("dci", dci), (local, base.model(local))),
        source="calibrated", mesh_fingerprint=fp,
        axis_tiers=tuple(sorted(routing.items())), default_tier=local,
        residuals=(("dci", resid),))


# ---------------------------------------------------------------------------
# Profile store: JSON keyed by fingerprint, schema-versioned
# ---------------------------------------------------------------------------


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "-", name).strip("-") or "default"


def profile_dir(directory: str | None = None) -> str:
    return directory or os.environ.get("REPRO_TORCH_PROFILE_DIR",
                                       DEFAULT_PROFILE_DIR)


def profile_path(mesh_fingerprint: str,
                 directory: str | None = None) -> str:
    return os.path.join(profile_dir(directory),
                        f"profile_{_sanitize(mesh_fingerprint)}.json")


def save_profile(profile: CostProfile,
                 directory: str | None = None) -> str:
    """Persist ``profile`` under its fingerprint (write, then rename)."""
    path = profile_path(profile.mesh_fingerprint or "default", directory)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(profile.to_json(), f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_profile_file(path: str) -> CostProfile:
    with open(path) as f:
        return CostProfile.from_json(json.load(f))


# What a corrupted, truncated or wrong-shaped profile file can raise
# while parsing (JSONDecodeError is a ValueError); a broken store entry
# degrades to the defaults, it never stops planning.
_LOAD_ERRORS = (ValueError, KeyError, TypeError, AttributeError,
                OSError)


def load_profile(mesh_fingerprint: str,
                 directory: str | None = None) -> CostProfile | None:
    """The stored profile for a fingerprint, or None when missing,
    unreadable, corrupted, or of another schema version."""
    path = profile_path(mesh_fingerprint, directory)
    if not os.path.exists(path):
        return None
    try:
        return load_profile_file(path)
    except _LOAD_ERRORS:
        return None


def latest_profile(directory: str | None = None) -> CostProfile | None:
    """The most recently written readable profile in the store, or
    None."""
    d = profile_dir(directory)
    if not os.path.isdir(d):
        return None
    paths = sorted(
        (os.path.join(d, f) for f in os.listdir(d)
         if f.startswith("profile_") and f.endswith(".json")),
        key=os.path.getmtime, reverse=True)
    for path in paths:
        try:
            return load_profile_file(path)
        except _LOAD_ERRORS:
            continue
    return None


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_ints(text: str) -> tuple[int, ...]:
    return tuple(int(t) for t in text.split(",") if t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Calibrate the scan planner's cost profile from "
                    "measured schedule timings on the CUDA card.")
    ap.add_argument("--simulate", action="store_true",
                    help="device-free simulated clock; omit to time the "
                         "card")
    ap.add_argument("--out", default=None,
                    help=f"profile store directory (default "
                         f"{DEFAULT_PROFILE_DIR!r} or "
                         f"$REPRO_TORCH_PROFILE_DIR)")
    ap.add_argument("--fingerprint", default=None,
                    help="fingerprint key to persist under")
    ap.add_argument("--ps", type=_parse_ints, default=DEFAULT_PS,
                    help="comma-separated rank counts to sweep")
    ap.add_argument("--ms", type=_parse_ints, default=DEFAULT_MS,
                    help="comma-separated payload bytes to sweep")
    ap.add_argument("--max-residual", type=float, default=0.05,
                    help="fail if any tier's relative fit residual "
                         "exceeds this")
    ap.add_argument("--dist", type=int, default=0, metavar="NPROCS",
                    help="fit the 'dci' tier from schedules timed across "
                         "NPROCS worker processes instead of the local "
                         "sweep")
    ap.add_argument("--dist-intra", type=int, default=1,
                    help="ranks per worker process for --dist (the "
                         "fingerprint's dist-<platform>-procs<N>x<P>)")
    ap.add_argument("--device", default=None,
                    help="the pool's device for --dist (default: the "
                         "card; 'cpu' for the host)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the pool's backend for --dist (gloo: several "
                         "ranks on one card need it; nccl: one process a "
                         "card, the cross-card tier, under the fingerprint "
                         "dist-cuda-nccl-cards<N>-procs<N>x<P>)")
    args = ap.parse_args(argv)

    from repro_torch.launch import mesh as mesh_lib

    if args.dist:
        profile = calibrate_dist(nprocs=args.dist,
                                 ranks_per_proc=args.dist_intra,
                                 device=args.device, backend=args.backend)
        residuals = dict(profile.residuals)
        print(f"calibrated profile (clock=dist, "
              f"mesh={profile.mesh_fingerprint}, "
              f"fingerprint={profile.fingerprint()}):")
        for tier, cm in profile.tiers:
            print(f"  {tier}: alpha={cm.alpha:.3e} beta={cm.beta:.3e} "
                  f"gamma={cm.gamma:.3e} "
                  f"residual={residuals.get(tier, 0.0):.3e}")
        path = save_profile(profile, args.out)
        print(f"wrote {path}")
        # no residual gate, as in the JAX package: inter-process timings
        # carry overheads the linear model takes as noise
        return 0
    truth = mesh_lib.DEFAULT_PROFILE
    profile = calibrate(simulate=args.simulate, truth=truth,
                        ps=args.ps, ms=args.ms,
                        mesh_fingerprint=args.fingerprint)
    residuals = dict(profile.residuals)
    print(f"calibrated profile (clock="
          f"{'simulated' if args.simulate else 'walltime'}, "
          f"mesh={profile.mesh_fingerprint}, "
          f"fingerprint={profile.fingerprint()}):")
    for tier, cm in profile.tiers:
        line = (f"  {tier}: alpha={cm.alpha:.3e} beta={cm.beta:.3e} "
                f"gamma={cm.gamma:.3e} "
                f"residual={residuals.get(tier, 0.0):.3e}")
        if args.simulate:
            t = truth.model(tier)
            line += (f"  (truth alpha={t.alpha:.3e} beta={t.beta:.3e} "
                     f"gamma={t.gamma:.3e})")
        print(line)
    path = save_profile(profile, args.out)
    print(f"wrote {path}")
    worst = max(residuals.values(), default=0.0)
    if worst > args.max_residual:
        print(f"FAIL: fit residual {worst:.3e} exceeds "
              f"--max-residual {args.max_residual}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
