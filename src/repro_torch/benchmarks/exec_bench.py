"""Execution-engine benchmark: kernel launches, HBM passes, the simulated
clock and the wall time of every exclusive algorithm's schedule.

For each registered exclusive algorithm at p ∈ {8, 64, 256}, on int64
add payloads of 256 elements a rank (2 KiB), run by
:class:`~repro_torch.core.schedule.StackedExecutor` on ``--device`` (the
card by default), this emits:

  * ``kernel_launches`` / ``hbm_passes`` from ``collect_stats()``, which
    must equal the IR's ``Schedule.kernel_launches`` /
    ``kernel_passes``; on the card, also the round kernels' own launch
    counters over the same call;
  * ``simulated_seconds``: the deterministic simulated clock of
    :func:`repro_torch.core.tune.measure_schedule_simulated` under the
    port's default "stacked" pricing (device-free, reproducible);
  * the wall time: the minimum of 5 synchronised calls after one
    untimed one;
  * ``max_drift`` of the output against numpy.

At p = 64 the fused round path is measured against its per-round
baseline: the pinned S = 8 segmented ring and the fused_doubling
scan_total under ``StackedExecutor(fused=True)`` and ``(fused=False)``,
with the launch and pass counts against the IR's prediction and the
drift between the two modes and against numpy.

``--check`` is the JAX package's fused-kernel gate
(``benchmarks/exec_bench.py``, ``_check_pallas``), unloosened: the fused
path pays at least ``MIN_FUSED_PASS_WIN``× fewer HBM passes than the
baseline on the p = 64 S = 8 ring, launches fewer kernels on the p = 64
scan_total, matches the IR's counts exactly and drifts zero bits; and
every algorithm's row counts what its IR predicts and equals numpy.

The JAX package's ``trace_eqns`` and ``compile_seconds`` rows and its
``TRACE_EQ_BUDGET`` and ``MIN_ROLLED_WIN`` gates measure how JAX traces
and compiles the SPMD program (a rolled ``lax.scan`` round table against
one trace site a round).  The port traces and compiles nothing, so it
has no such rows and no stand-in for them; and since one process holds
every rank, it needs no worker subprocess a p.

    PYTHONPATH=src python -m repro_torch.benchmarks.exec_bench
        [--device cpu] [--ps 8,64,256] [--check] [--json [PATH]]
"""

from __future__ import annotations

import argparse

import numpy as np

DEFAULT_JSON = "BENCH_torch_exec.json"
PS = (8, 64, 256)
ALGS = ("123", "1doubling", "two_op", "native", "ring",
        "halving", "quartering", "reduce_scatter")
PAYLOAD_ELEMS = 256  # int64 -> 2 KiB per rank
FUSED_P = 64  # fused-vs-baseline cell
FUSED_RING_S = 8  # pinned ring segment count for the pass-count gate
MIN_FUSED_PASS_WIN = 2.0  # baseline/fused HBM-pass floor
REPS = 5
ROUND_KERNELS = ("combine", "exchange", "scan_reduce")


def _payload(p: int) -> np.ndarray:
    return np.arange(p * PAYLOAD_ELEMS, dtype=np.int64).reshape(
        p, PAYLOAD_ELEMS)


def _numpy_ref(kind: str, x: np.ndarray):
    pre = np.zeros_like(x)
    pre[1:] = np.cumsum(x[:-1], axis=0)
    if kind == "scan_total":
        return pre, np.broadcast_to(x.sum(axis=0), x.shape)
    return pre


def _drift(got, want) -> int:
    from repro_torch import _tree
    from repro_torch import device as device_lib

    return max(int(np.max(np.abs(device_lib.leaf_to_numpy(g) - w)))
               if w.size else 0
               for g, w in zip(_tree.leaves(got), _tree.leaves(want)))


def _round_launches() -> int:
    from repro_torch.kernels import scan_engine as se

    return sum(se.KERNELS[k].launches for k in ROUND_KERNELS)


def measure(pl, ex, x: np.ndarray, mode: str, *, reps: int = REPS) -> dict:
    """One plan on one executor: the row of counts, times and drift
    (its ``output`` is the first call's result, for cross-mode checks)."""
    import torch

    from repro_torch.benchmarks.common import timed
    from repro_torch.core import monoid as monoid_lib
    from repro_torch.core import schedule as schedule_lib

    m = monoid_lib.ADD
    sched = pl.schedule()
    xt = torch.from_numpy(x).to(ex.device)
    before = _round_launches()
    with schedule_lib.collect_stats() as st:
        out = ex.execute(sched, xt, m)
    counted = _round_launches() - before
    _, ts = timed(lambda: ex.execute(sched, xt, m), ex.device, reps)
    fused = ex.fused
    return {
        "p": pl.p, "algorithm": pl.algorithm, "mode": mode,
        "segments": pl.segments, "rounds": pl.rounds,
        "payload_bytes": x[0].nbytes, "device": str(ex.device),
        "kernel_launches": st.kernel_launches,
        "hbm_passes": st.hbm_passes,
        "round_kernel_launches": counted,
        "predicted_launches": sched.kernel_launches(m.commutative,
                                                    fused=fused),
        "predicted_passes": sched.kernel_passes(m.commutative,
                                                fused=fused),
        "plan_kernel_passes": pl.kernel_passes,
        "wall_seconds": min(ts),
        "max_drift": _drift(out, _numpy_ref(pl.spec.kind, x)),
        "output": out,
    }


def schedule_rows(p: int, device, *, reps: int = REPS) -> list[dict]:
    """Every algorithm of ``ALGS`` at ``p`` on the fused executor, with
    the simulated clock beside the wall time."""
    from repro_torch.core import tune
    from repro_torch.core.scan_api import ScanSpec, plan
    from repro_torch.core.schedule import StackedExecutor
    from repro_torch.launch import mesh as mesh_lib

    x = _payload(p)
    nbytes = x[0].nbytes
    truth = mesh_lib.DEFAULT_PROFILE.model("stacked")
    ex = StackedExecutor(device)
    rows = []
    for alg in ALGS:
        pl = plan(ScanSpec(kind="exclusive", algorithm=alg), p=p,
                  nbytes=nbytes)
        row = measure(pl, ex, x, "stacked", reps=reps)
        row["simulated_seconds"], _ = tune.measure_schedule_simulated(
            pl.schedule(), nbytes, truth)
        del row["output"]
        rows.append(row)
    return rows


def fused_rows(device, *, p: int = FUSED_P, reps: int = REPS) -> list[dict]:
    """The fused-against-baseline cells: the pinned S = 8 ring and the
    fused_doubling scan_total, each under both executor modes, with the
    drift between the modes."""
    from repro_torch import device as device_lib
    from repro_torch.core.scan_api import ScanSpec, plan
    from repro_torch.core.schedule import StackedExecutor

    x = _payload(p)
    nbytes = x[0].nbytes
    cases = (
        plan(ScanSpec(kind="exclusive", algorithm="ring",
                      segments=FUSED_RING_S), p=p, nbytes=nbytes),
        plan(ScanSpec(kind="scan_total", algorithm="fused_doubling"),
             p=p, nbytes=nbytes),
    )
    rows = []
    for pl in cases:
        fused = measure(pl, StackedExecutor(device, fused=True), x,
                        "fused", reps=reps)
        base = measure(pl, StackedExecutor(device, fused=False), x,
                       "baseline", reps=reps)
        between = _drift(fused.pop("output"),
                         device_lib.to_numpy(base.pop("output")))
        fused["drift_between_modes"] = base["drift_between_modes"] = \
            between
        rows += [fused, base]
    return rows


def check(rows: list[dict]) -> list[str]:
    """The gates (module docstring)."""
    failures = []
    for r in rows:
        tag = f"p={r['p']} {r['algorithm']} {r['mode']}"
        if r["kernel_launches"] != r["predicted_launches"] \
                or r["hbm_passes"] != r["predicted_passes"]:
            failures.append(
                f"{tag}: measured kernel stats "
                f"({r['kernel_launches']}L/{r['hbm_passes']}P) != IR "
                f"prediction ({r['predicted_launches']}L/"
                f"{r['predicted_passes']}P)")
        on_card = r["device"].startswith("cuda")
        if r["round_kernel_launches"] != (r["predicted_launches"]
                                          if on_card else 0):
            failures.append(
                f"{tag}: {r['round_kernel_launches']} round-kernel "
                f"launches counted, IR {r['predicted_launches']}")
        if r["max_drift"] != 0 or r.get("drift_between_modes", 0) != 0:
            failures.append(
                f"{tag}: nonzero drift {r['max_drift']} vs numpy, "
                f"{r.get('drift_between_modes')} between modes")
    by = {(r["p"], r["algorithm"], r["mode"]): r for r in rows}
    cells = {(alg, mode): by.get((FUSED_P, alg, mode))
             for alg in ("ring", "fused_doubling")
             for mode in ("fused", "baseline")}
    missing = sorted(k for k, v in cells.items() if v is None)
    if missing:
        return failures + [f"missing p={FUSED_P} fused rows: {missing}"]
    ring_f, ring_b = cells[("ring", "fused")], cells[("ring", "baseline")]
    win = ring_b["hbm_passes"] / max(ring_f["hbm_passes"], 1)
    if win < MIN_FUSED_PASS_WIN:
        failures.append(
            f"fused ring pass win {win:.2f}x below the "
            f"{MIN_FUSED_PASS_WIN}x floor "
            f"({ring_b['hbm_passes']} -> {ring_f['hbm_passes']})")
    st_f = cells[("fused_doubling", "fused")]
    st_b = cells[("fused_doubling", "baseline")]
    if st_f["kernel_launches"] >= st_b["kernel_launches"]:
        failures.append(
            f"fused scan_total launches {st_f['kernel_launches']} not "
            f"below baseline {st_b['kernel_launches']}")
    return failures


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    ap.add_argument("--ps", type=lambda s: tuple(
        int(t) for t in s.split(",") if t), default=PS,
        help="comma-separated rank counts (default 8,64,256)")
    ap.add_argument("--check", action="store_true",
                    help="fail unless the fused path beats its baseline "
                         f"(>= {MIN_FUSED_PASS_WIN}x fewer ring HBM "
                         "passes, fewer scan_total launches), every "
                         "count equals the IR's and nothing drifts")
    common.add_json_arg(ap, DEFAULT_JSON)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    rows = []
    for p in args.ps:
        rows.extend(schedule_rows(p, dev))
    rows.extend(fused_rows(dev))
    unit = common.wallclock_unit(dev)
    for r in rows:
        key = f"exec/{r['algorithm']}/{r['mode']}/p{r['p']}"
        print(f"{key}/kernel_launches,{r['kernel_launches']},"
              f"round_kernel_launches")
        print(f"{key}/hbm_passes,{r['hbm_passes']},payload_sweeps")
        print(f"{key}/wall_us,{r['wall_seconds'] * 1e6:.2f},{unit}")
        if "simulated_seconds" in r:
            print(f"{key}/simulated_us,{r['simulated_seconds'] * 1e6:.2f},"
                  f"default_stacked_clock")
        print(f"{key}/max_drift,{r['max_drift']},bits_vs_numpy")
    if args.json:
        common.write_json(args.json, "torch_exec_bench", dev,
                          min_fused_pass_win=MIN_FUSED_PASS_WIN, rows=rows)
    if args.check:
        failures = check(rows)
        if failures:
            print("exec-bench gate failed: " + "; ".join(failures))
            return 1
        print("exec-bench gate OK (fused kernel win, IR counts, no drift)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
