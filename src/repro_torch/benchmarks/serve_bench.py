"""Scan-service benchmark: fused-batching round win and p50/p99 against
the request rate.

Drives :class:`repro_torch.serve.ScanService` at P = 8 ranks on
``--device`` (the card by default) with the two real request classes
(MoE dispatch scan_totals, their counts made by the ``moe_routing``
kernel, and compression-offset scalar exscans, from
``repro_torch.serve.workloads``) in two phases:

  * **burst**: every request submitted at once, drained, each answer
    against numpy.  This is the deterministic cell the gate reads:
    occupancy is maximal, so the fused-round win (serial-equivalent
    rounds / executed rounds) is a property of the schedules, not of
    the machine's speed.
  * **rate sweep**: open-loop Poisson arrivals at each swept rate under
    the service's virtual clock (execution seconds are measured on the
    device, after a synchronise, and pushed onto the clock), reporting
    queue depth, batch occupancy and p50/p99 latency *from nominal
    arrival time*: the bench keeps its own arrival map to charge
    queueing delay.

After warm-up one request of each class is served unmeasured, so the
kernels' first launches stay out of every phase.  The buckets, burst,
rates and gate are the JAX package's ``benchmarks/serve_bench.py``.

``--check`` is the serving gate: zero post-warmup plan compiles across
ALL phases, a burst-phase fused round win of at least
``MIN_FUSED_ROUND_WIN``× over serving the same requests serially, and
every burst answer equal to numpy's.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench
        [--device cpu] [--rates R,R,...] [--seed N] [--check]
        [--json [PATH]]
"""

from __future__ import annotations

import argparse

import numpy as np

DEFAULT_JSON = "BENCH_torch_serve.json"
P = 8
MOE_ARCH = "qwen2_moe_a2_7b"
MAX_BATCH = 8
N_BURST = 48
RATES = (500.0, 5000.0, 50000.0)  # req/s: under / near / over capacity
N_PER_RATE = 200
MOE_POOL = 8  # distinct MoE payloads cycled through
MIN_FUSED_ROUND_WIN = 2.0


def make_service_and_traffic(device, seed: int = 0):
    """The service on ``device``, warmed up and served one request of
    each class, and its traffic: ``(svc, traffic, rng, warm)``."""
    from repro_torch import configs
    from repro_torch.core.schedule import StackedExecutor
    from repro_torch.serve import ScanService, workloads

    cfg = configs.get_smoke(MOE_ARCH)
    rng = np.random.default_rng(seed)
    buckets = [workloads.moe_bucket(cfg), workloads.compression_bucket()]
    svc = ScanService(P, buckets, max_batch=MAX_BATCH,
                      max_queue=4 * MAX_BATCH * len(buckets),
                      executor=StackedExecutor(device))
    moe_pool = [workloads.moe_dispatch_payload(cfg, P, rng, n_tokens=32,
                                               device=device)
                for _ in range(MOE_POOL)]
    comp_pool = workloads.compression_offset_payloads(
        P, [100, 2_000, 50, 7, 65_536], 0.01, rng=rng, thresholded=True)

    def traffic(n):
        """n (kind, payload) pairs, MoE and compression interleaved."""
        out = []
        for i in range(n):
            if rng.random() < 0.5:
                out.append(("scan_total", moe_pool[i % len(moe_pool)]))
            else:
                out.append(("exclusive", comp_pool[i % len(comp_pool)]))
        return out

    warm = svc.warmup()
    # the kernels' first launches, outside every measured phase
    svc.submit(moe_pool[0], kind="scan_total")
    svc.submit(comp_pool[0], kind="exclusive")
    svc.drain()
    return svc, traffic, rng, warm


def _phase_row(svc, phase: str, extra: dict) -> dict:
    row = {"phase": phase, "p": P, "max_batch": MAX_BATCH,
           "post_warmup_compiles": svc.post_warmup_compiles}
    row.update(svc.metrics.snapshot())
    row.update(extra)
    return row


def _wrong(req, payload) -> int:
    """1 where a finished request's answer differs from numpy's."""
    from repro_torch import device as device_lib

    x = np.asarray(payload)
    pre = np.zeros_like(x)
    pre[1:] = np.cumsum(x[:-1], axis=0, dtype=x.dtype)
    if req.bucket.kind == "scan_total":
        got = [device_lib.leaf_to_numpy(t) for t in req.result]
        want = [pre, np.broadcast_to(x.sum(axis=0, dtype=x.dtype),
                                     x.shape)]
    else:
        got, want = [device_lib.leaf_to_numpy(req.result)], [pre]
    return int(not all(np.array_equal(g, w) for g, w in zip(got, want)))


def run_burst(svc, traffic) -> dict:
    svc.reset_metrics()
    items = traffic(N_BURST)
    reqs = [svc.submit(payload, kind=kind, now=svc.now)
            for kind, payload in items]
    svc.drain()
    wrong = sum(_wrong(r, payload) for r, (_, payload) in zip(reqs, items)
                if r.status == "done")
    return _phase_row(svc, "burst", {"n": N_BURST, "rate": None,
                                     "wrong": wrong})


def run_rate(svc, traffic, rng, rate: float) -> dict:
    from repro_torch.serve import AdmissionError, workloads
    from repro_torch.serve.metrics import percentile

    svc.reset_metrics()
    arrivals = workloads.poisson_arrivals(rng, rate, N_PER_RATE)
    arrivals += svc.now  # the clock is monotone across phases
    items = traffic(N_PER_RATE)
    arrival_of: dict[int, float] = {}
    finalized = []
    i = 0
    while i < N_PER_RATE or svc.depth:
        now = svc.now
        if svc.depth == 0 and i < N_PER_RATE and arrivals[i] > now:
            now = float(arrivals[i])  # idle: jump to the next arrival
        while i < N_PER_RATE and arrivals[i] <= now:
            kind, payload = items[i]
            try:
                req = svc.submit(payload, kind=kind, now=now)
                arrival_of[req.rid] = float(arrivals[i])
            except AdmissionError:
                pass  # overload backpressure; counted in metrics
            i += 1
        finalized.extend(svc.tick(now))
    lat = [r.t_done - arrival_of[r.rid] for r in finalized
           if r.status == "done"]
    return _phase_row(svc, "rate", {
        "n": N_PER_RATE, "rate": rate,
        "arrival_latency_p50_s": percentile(lat, 50),
        "arrival_latency_p99_s": percentile(lat, 99),
    })


def check(rows: list[dict]) -> list[str]:
    """The CI serving gate (burst determinism + warmup contract)."""
    failures = []
    burst = next((r for r in rows if r["phase"] == "burst"), None)
    if burst is None:
        return ["no burst row"]
    if burst["wrong"]:
        failures.append(f"burst: {burst['wrong']} answers differ from "
                        f"numpy's")
    if burst["completed"] != burst["n"]:
        failures.append(
            f"burst completed {burst['completed']}/{burst['n']}")
    win = burst["fused_round_win"]
    if not win >= MIN_FUSED_ROUND_WIN:
        failures.append(
            f"burst fused round win {win:.2f}x below the "
            f"{MIN_FUSED_ROUND_WIN}x floor "
            f"({burst['rounds_serial_equiv']} serial-equiv rounds -> "
            f"{burst['rounds_executed']} executed)")
    compiles = rows[-1]["post_warmup_compiles"]
    if compiles != 0:
        failures.append(
            f"{compiles} plan compiles after warmup (the warmup "
            f"contract requires 0 across every phase)")
    return failures


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    ap.add_argument("--rates", type=lambda s: tuple(
        float(t) for t in s.split(",") if t), default=RATES,
        help="comma-separated request rates in req/s "
             f"(default {','.join(str(r) for r in RATES)})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="fail unless the burst phase wins >= "
                         f"{MIN_FUSED_ROUND_WIN}x rounds over serial, "
                         "its answers are numpy's and zero plans compile "
                         "after warmup")
    common.add_json_arg(ap, DEFAULT_JSON)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    svc, traffic, rng, warm = make_service_and_traffic(dev, args.seed)
    print(f"warmup: {warm['fused_plans_primed']} fused plans over "
          f"{warm['buckets']} buckets "
          f"({warm['cache']['misses']} cache entries built)")

    rows = [run_burst(svc, traffic)]
    for rate in args.rates:
        rows.append(run_rate(svc, traffic, rng, rate))

    for r in rows:
        key = f"serve/{r['phase']}" + (
            f"/rate{r['rate']:g}" if r["rate"] else "")
        print(f"{key}/completed,{r['completed']},requests")
        print(f"{key}/occupancy,{r['mean_occupancy']:.2f},"
              f"requests_per_batch")
        print(f"{key}/fused_round_win,{r['fused_round_win']:.2f},"
              f"serial_over_fused_rounds")
        if r["phase"] == "rate":
            print(f"{key}/p50_ms,{r['arrival_latency_p50_s']*1e3:.3f},"
                  f"from_arrival_{dev.type}")
            print(f"{key}/p99_ms,{r['arrival_latency_p99_s']*1e3:.3f},"
                  f"from_arrival_{dev.type}")
            print(f"{key}/timed_out,{r['timed_out']},requests")
            print(f"{key}/rejected,"
                  f"{r['rejected_overload']},overload_backpressure")
    print(f"post-warmup plan compiles: {rows[-1]['post_warmup_compiles']}")

    if args.json:
        common.write_json(args.json, "torch_serve_bench", dev, p=P,
                          max_batch=MAX_BATCH,
                          min_fused_round_win=MIN_FUSED_ROUND_WIN,
                          rows=rows)
    if args.check:
        failures = check(rows)
        if failures:
            print("serving gate failed: " + "; ".join(failures))
            return 1
        print("serving gate OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
