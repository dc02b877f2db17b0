"""Online self-tuning bench: drift detection, gated installs, no thrash.

The scenario the controller exists for: a service is executing scans
under a calibrated profile when the fabric shifts — here, the "dci"
tier's per-round latency α jumps 4× mid-run (a degraded link, a
throttled NIC).  Every plan priced under the stale constants is now
wrong in exactly the paper's regime: the mid-m winner map moves.

The bench streams a fixed cycle of (tier, p, m) executions through a
:class:`repro_torch.core.autotune.AutoTuner` under a **deterministic
simulated clock**: each execution plans under the *installed* profile
(the controller's view), then its executed schedule is priced under the
*true* constants of the moment (the fabric's view), so a stale profile
pays simulated seconds for its wrong choices.  Its base profile is
``dist_bench.REFERENCE_PROFILE`` (the JAX package's "ici"/"dci"
constants as numbers): the pinned dci cell is defined by them.  The
seconds are the model's, no time of the card's; the scenario launches
no kernel, and ``--device`` is only recorded.

Gated claims (``--check``), the JAX package's
``benchmarks/autotune_bench.py`` gate for gate:

  * the controller detects the drift and installs a refitted profile
    within the detection budget, with fit residual under the gate;
  * the install drops stale plan-cache entries (count > 0);
  * the pinned (p, m) winner cell flips from the pre-drift to the
    post-drift algorithm through the *installed* profile;
  * total simulated time after convergence is within 5% of an oracle
    planner that had the true constants from the start;
  * a stable-constants control run installs NOTHING (no thrash).

    PYTHONPATH=src python -m repro_torch.benchmarks.autotune_bench
        [--device cpu] [--check] [--json [PATH]]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.benchmarks.dist_bench import REFERENCE_PROFILE

DEFAULT_JSON = "BENCH_torch_autotune.json"

# -- scenario pins ----------------------------------------------------------

DRIFT_FACTOR = 4.0  # the dci α shift the fabric undergoes mid-run
DRIFT_AT = 96  # execution index at which the true constants shift
N_EXECUTIONS = 240
CAPACITY = 24  # per-tier reservoir bound (sliding window)
REFIT_EVERY = 12  # one workload cycle between refit attempts
GATE_DRIFT = 0.3  # install at >= ~1.4x constant change
GATE_RESIDUAL = 0.25
MIN_SAMPLES = 12
DETECT_BUDGET = 6 * CAPACITY  # executions allowed from drift to install
WALLTIME_TOLERANCE = 0.05  # post-convergence vs oracle

# The pinned winner cell: dci tier, p=8, m=256 KiB.  Under the base
# profile's dci pricing the block-halving exscan wins (bandwidth-lean); under
# 4x α the round count dominates and two_op takes it.
PIN_P, PIN_M = 8, 262_144
PIN_PRE, PIN_POST = "halving", "two_op"

# Workload cycle: dci and ici cells interleaved, m spanning the
# α-dominated to β-dominated regimes so the NNLS sees feature spread.
_DCI_CELLS = [("pod", p, m) for p in (4, 8)
              for m in (512, 8192, 262_144)]
_ICI_CELLS = [(None, p, m) for p in (4, 8)
              for m in (512, 8192, 262_144)]
CELLS = [c for pair in zip(_DCI_CELLS, _ICI_CELLS) for c in pair]


def _shift_dci_alpha(profile, factor: float):
    return dataclasses.replace(profile, tiers=tuple(
        (n, dataclasses.replace(cm, alpha=cm.alpha * factor)
         if n == "dci" else cm)
        for n, cm in profile.tiers))


def _sim_seconds(sched, nbytes: int, cm) -> float:
    """The simulated clock: the TRUE constants priced on the executed
    schedule's exact features (the regressors the fit consumes, so
    calibration data from a known fabric recovers it exactly)."""
    from repro_torch.core import tune

    hops, wire, op_bytes = tune.schedule_features(
        sched, nbytes, commutative=True)
    return cm.cost(hops=int(hops), serial_bytes=wire, ops=0,
                   payload_bytes=0, op_bytes=op_bytes)


def run_scenario(*, drift: bool, base=REFERENCE_PROFILE) -> dict:
    """Stream the workload through the controller; ``drift`` selects
    the shifting-fabric scenario against the stable-constants control.
    ``base`` is installed for the run and the previous profile put back
    after it."""
    from repro_torch.core import scan_api
    from repro_torch.core.autotune import AutoTuner, DriftGate
    from repro_torch.launch import mesh as mesh_lib

    truth_pre = base
    truth_post = _shift_dci_alpha(base, DRIFT_FACTOR) if drift else base
    spec = scan_api.ScanSpec(kind="exclusive", monoid="add")

    prev = mesh_lib.install_profile(base)
    scan_api.plan_cache_clear()
    tuner = AutoTuner(
        base,
        gate=DriftGate(drift=GATE_DRIFT, max_residual=GATE_RESIDUAL,
                       min_samples=MIN_SAMPLES),
        capacity=CAPACITY, refit_every=REFIT_EVERY,
        mesh_fingerprint="autotune-bench")
    installs: list[dict] = []
    controller_seconds: list[float] = []
    oracle_seconds: list[float] = []
    try:
        with scan_api.use_cost_model(mesh_lib.axis_cost_model):
            pin_pre = scan_api.plan(
                spec.over("pod"), PIN_P, nbytes=PIN_M).algorithm
            for i in range(N_EXECUTIONS):
                truth = truth_pre if i < DRIFT_AT else truth_post
                axis, p, m = CELLS[i % len(CELLS)]
                tier = "dci" if axis == "pod" else "ici"
                # the controller's view: plan under the installed
                # profile; the fabric's view: pay true seconds for it
                pl = scan_api.plan(spec.over(axis), p, nbytes=m)
                seconds = _sim_seconds(pl.schedule(), m,
                                       truth.model(tier))
                controller_seconds.append(seconds)
                opl = scan_api.plan(spec.over(axis), p, nbytes=m,
                                    cost_model=truth)
                oracle_seconds.append(_sim_seconds(opl.schedule(), m,
                                                   truth.model(tier)))
                tuner.record(pl.schedule(), m, seconds, tier=tier,
                             algorithm=pl.algorithm)
                res = tuner.maybe_refit()
                if res.installed:
                    installs.append({
                        "execution": i,
                        "drift": dict(res.drift),
                        "residuals": dict(res.residuals),
                        "plans_dropped": res.plans_dropped,
                    })
            pin_post = scan_api.plan(
                spec.over("pod"), PIN_P, nbytes=PIN_M).algorithm
    finally:
        mesh_lib.install_profile(prev)
        scan_api.plan_cache_clear()

    converge = installs[-1]["execution"] if installs else None
    row = {
        "scenario": "drift" if drift else "stable",
        "executions": N_EXECUTIONS,
        "drift_at": DRIFT_AT if drift else None,
        "installs": len(installs),
        "install_log": installs,
        "refits": tuner.refits,
        "plans_dropped": tuner.plans_dropped,
        "reservoirs": tuner.reservoir_sizes(),
        "pinned_cell": {"tier": "dci", "p": PIN_P, "nbytes": PIN_M,
                        "pre": pin_pre, "post": pin_post},
        "converged_at": converge,
    }
    if drift:
        row["detect_executions"] = (converge - DRIFT_AT
                                    if converge is not None else None)
        if converge is not None:
            post = slice(converge + 1, None)
            ctrl = sum(controller_seconds[post])
            orac = sum(oracle_seconds[post])
            row["post_convergence_seconds"] = ctrl
            row["oracle_seconds"] = orac
            row["walltime_ratio"] = ctrl / orac if orac else None
            fit_dci = tuner.profile.model("dci")
            truth_dci = truth_post.model("dci")
            row["fitted_dci_alpha"] = fit_dci.alpha
            row["truth_dci_alpha"] = truth_dci.alpha
            row["final_residual"] = max(
                dict(installs[-1]["residuals"]).values())
    return row


def check(rows: list[dict]) -> list[str]:
    by = {r["scenario"]: r for r in rows}
    drift, stable = by.get("drift"), by.get("stable")
    failures = []
    if drift is None or stable is None:
        return ["missing scenario rows"]
    if not drift["installs"]:
        failures.append("drift scenario installed no refit")
        return failures
    if drift["detect_executions"] is None or \
            drift["detect_executions"] > DETECT_BUDGET:
        failures.append(
            f"drift detected in {drift['detect_executions']} "
            f"executions, budget {DETECT_BUDGET}")
    if drift["final_residual"] > GATE_RESIDUAL:
        failures.append(
            f"converged fit residual {drift['final_residual']:.3e} "
            f"over the {GATE_RESIDUAL} gate")
    if drift["plans_dropped"] <= 0:
        failures.append("install dropped no stale plan-cache entries")
    pin = drift["pinned_cell"]
    if (pin["pre"], pin["post"]) != (PIN_PRE, PIN_POST):
        failures.append(
            f"pinned winner cell (p={PIN_P}, m={PIN_M}) went "
            f"{pin['pre']} -> {pin['post']}, expected "
            f"{PIN_PRE} -> {PIN_POST}")
    ratio = drift.get("walltime_ratio")
    if ratio is None or not (1.0 - 1e-9) <= ratio \
            <= 1.0 + WALLTIME_TOLERANCE:
        failures.append(
            f"post-convergence walltime {ratio} vs oracle, "
            f"tolerance {WALLTIME_TOLERANCE}")
    if stable["installs"] != 0:
        failures.append(
            f"stable control run installed {stable['installs']} "
            f"profiles (thrash)")
    if stable["refits"] < 1:
        failures.append("stable control run never attempted a refit")
    return failures


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero when any gated claim fails")
    common.add_json_arg(ap, DEFAULT_JSON)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    rows = [run_scenario(drift=True), run_scenario(drift=False)]
    for r in rows:
        line = (f"{r['scenario']}: installs={r['installs']} "
                f"refits={r['refits']} "
                f"plans_dropped={r['plans_dropped']}")
        if r["scenario"] == "drift":
            line += (f" detect={r['detect_executions']}ex "
                     f"ratio={r.get('walltime_ratio'):.4f} "
                     f"pin={r['pinned_cell']['pre']}->"
                     f"{r['pinned_cell']['post']}")
        print(line)
    if args.json:
        common.write_json(args.json, "torch_autotune_bench", dev,
                          drift_factor=DRIFT_FACTOR,
                          detect_budget=DETECT_BUDGET,
                          walltime_tolerance=WALLTIME_TOLERANCE,
                          clock="simulated", rows=rows)
    if args.check:
        failures = check(rows)
        if failures:
            for msg in failures:
                print(f"AUTOTUNE FAIL: {msg}")
            return 1
        print("autotune gates OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
