"""Drive the PyTorch port's exclusive-scan path on one NVIDIA card.

Run from the repository root, on a machine with an H100:

    python3 chip_smoke.py

It builds the round kernels from ``src/repro_torch/kernels/csrc`` and
prints one JSON line per phase:

  build    compile the round kernels (nvcc, sm_90a) and load them
  kernels  every round-kernel instance against its plain PyTorch version
           (bit for bit) at a ragged size and at the sizes the main path
           gives it; kernel, plain and library times on the card (CUDA
           events over calls queued behind a sleep, so the host's issue
           time is not in them) beside the least time the card's HBM
           allows, and the kernel's time per call as Python issues it
  table1   ``plan(...).execute(x)`` and ``scan(x, spec)`` over p = 512
           ranks for the paper's algorithms at m in {1, 100, 10 000,
           100 000} int64 under MPI_BXOR, plus a pinned ring, scan_total
           and affine runs; each output against numpy, each stats count
           against the plan, and the kernels' launch counters against the
           IR's ``kernel_launches``; wall times (median, min, max), the
           card's busy time from torch.profiler and its idle share, and
           ``alpha_s`` (seconds per round of 123 at m = 1)
  serve    a ScanService burst of 48 requests over the MoE and
           compression buckets, answers against numpy

then the ``kernels`` summary (launches counted over table1 and serve
only), the card's name and power limit as nvidia-smi prints them, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; it also exits non-zero, printing no result, when
no CUDA card is present or when it is run outside the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SE_SOURCE = "src/repro_torch/kernels/csrc/round_kernels.cu"
TPU_ENGINE = "src/repro/kernels/scan_engine.py"
FP32_PEAK_OPS = 67e12  # H100 SXM, fp32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    """Published HBM bytes/s of the card found (NVIDIA data sheets)."""
    return 4.8e12 if "H200" in name else 3.35e12


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call when Python issues the calls one after
    another: CUDA events around ``reps`` calls after ``warmup`` (the
    host clock off the card).  Where the host takes longer to issue a
    call than the card to run it, this is the host's rate."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / reps


SM_HZ = 1.98e9  # H100 SXM boost clock: converts a sleep to cycles


def device_ms(fn, dev, reps: int) -> float:
    """Milliseconds per call on the card alone: the stream first runs a
    sleep kernel long enough for the host to queue all ``reps`` calls
    behind it, so the events time the calls back to back, without the
    host's issue time between them."""
    if dev.type != "cuda":
        return host_ms(fn, dev, reps)
    per_call = host_ms(fn, dev, 3)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((reps * per_call * 3e-3 + 2e-3) * SM_HZ))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / reps


def device_busy_s(fn, dev):
    """Seconds the card spends in kernels and copies during one call of
    ``fn`` (torch.profiler's device times); None where the profiler
    records none."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    return busy_us * 1e-6 if busy_us > 0 else None


def wall_s(fn, dev, reps: int) -> list:
    """Host seconds of ``reps`` calls of ``fn``, each ending in a
    synchronise."""
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return times


def _leaves(x) -> list:
    if isinstance(x, (tuple, list)):
        return [t for part in x for t in _leaves(part)]
    return [x]


def max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(_leaves(got), _leaves(want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{tuple(g.shape)}/{g.dtype} vs "
                                 f"{tuple(w.shape)}/{w.dtype}")
        d = (g.double() - w.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def identical(got, want) -> bool:
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(_leaves(got), _leaves(want)))


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    from repro_torch.kernels import _build, scan_engine as se

    t0 = time.perf_counter()
    sources = sorted(_build.CSRC.glob("*.cu"))
    for src in sources:
        _build.compile_source(src)
    se._lib()  # load and bind the C entry points
    return {"phase": "build", "sources": [s.name for s in sources],
            "seconds": time.perf_counter() - t0, "card": card_info()}


# ---------------------------------------------------------------------------
# kernels: every instance against its plain version, and their times
# ---------------------------------------------------------------------------

OPS = ("add", "mul", "max", "min", "xor", "affine")
DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64,
          torch.bfloat16)


def rand_leaf(rng, dtype, rows, n, dev):
    if dtype in (torch.int32, torch.int64):
        a = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (rows, n)))
    else:
        a = torch.from_numpy(rng.standard_normal((rows, n)))
    return a.to(device=dev, dtype=dtype)


def rand_operand(rng, op, dtype, rows, n, dev):
    if op == "affine":
        return (rand_leaf(rng, dtype, rows, n, dev),
                rand_leaf(rng, dtype, rows, n, dev))
    return rand_leaf(rng, dtype, rows, n, dev)


def check_instances(dev, p: int, n: int) -> int:
    """Every (template, ⊕, dtype) instance bit-identical to its plain
    version at (p, n); returns the number of comparisons."""
    from repro_torch.kernels import scan_engine as se

    rng = np.random.default_rng(0)
    mask = torch.from_numpy(
        rng.integers(0, 2, p).astype(np.int32)).to(dev)
    checks = 0
    for op in OPS:
        for dt in DTYPES:
            if not se.kernel_serves(op, dt):
                continue
            a, b, c = (rand_operand(rng, op, dt, p, n, dev)
                       for _ in range(3))
            row = rand_operand(rng, op, dt, 1, n, dev)
            pairs = [
                (se.combine(op, a, b), se.combine_plain(op, a, b)),
                (se.exchange(op, a, b, mask),
                 se.exchange_plain(op, a, b, mask)),
            ]
            for else_a in (False, True):
                pairs.append((
                    se.combine(op, a, b, mask=mask, else_a=else_a),
                    se.combine_plain(op, a, b, mask=mask, else_a=else_a)))
            pairs.append((se.combine(op, a, row, mask=mask, else_a=True),
                          se.combine_plain(op, a, row, mask=mask,
                                           else_a=True)))
            for comm in (False, True):
                got = se.scan_reduce(op, a, b, c, mask, commutative=comm)
                want = se.scan_reduce_plain(op, a, b, c, mask,
                                            commutative=comm)
                pairs += list(zip(got, want))
            sync(dev)
            for got, want in pairs:
                if not identical(got, want):
                    raise AssertionError(
                        f"round kernel {op}/{dt} at p={p} n={n} differs "
                        f"from its plain version by "
                        f"{max_abs_err(got, want)}")
                checks += 1
    return checks


def bound(nbytes: int, ops: int, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / rate, ops / FP32_PEAK_OPS
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def measure(name, dev, rate, kernel, plain, library, nbytes, ops,
            reps) -> dict:
    got, want = kernel(), plain()
    sync(dev)
    if not identical(got, want):
        raise AssertionError(f"{name}: kernel differs from plain by "
                             f"{max_abs_err(got, want)}")
    bound_ms, bound_by = bound(nbytes, ops, rate)
    return {
        "max_abs_err": max_abs_err(got, want),
        "ms": device_ms(kernel, dev, reps),
        "plain_ms": device_ms(plain, dev, reps),
        "library_ms": (None if library is None
                       else device_ms(library, dev, reps)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "host_ms": host_ms(kernel, dev, reps),
        "plain_host_ms": host_ms(plain, dev, reps),
    }


def path_kernels(dev, rate, *, p=512, n_int=100_000, n_affine=4096,
                 reps=20) -> dict:
    """Each kernel at the shape the main path gives it (table1's largest
    m for the elementwise instances, the affine runs' n for affine)."""
    from repro_torch.kernels import scan_engine as se

    rng = np.random.default_rng(1)
    low = (torch.arange(p, device=dev) & 1).to(torch.int32)  # skip-1 side
    keep = (torch.arange(p, device=dev) >= 1).to(torch.int32)
    x64 = [rand_leaf(rng, torch.int64, p, n_int, dev) for _ in range(2)]
    i32 = [rand_leaf(rng, torch.int32, p, n_int, dev) for _ in range(3)]
    aff = [rand_operand(rng, "affine", torch.float32, p, n_affine, dev)
           for _ in range(3)]
    e_int, e_aff = p * n_int, p * n_affine
    out = {}
    out["combine"] = measure(
        "combine xor int64", dev, rate,
        lambda: se.combine("xor", *x64),
        lambda: se.combine_plain("xor", *x64),
        lambda: torch.bitwise_xor(*x64), 3 * e_int * 8, e_int, reps)
    masked = measure(
        "masked combine xor int64", dev, rate,
        lambda: se.combine("xor", *x64, mask=keep),
        lambda: se.combine_plain("xor", *x64, mask=keep),
        None, 3 * e_int * 8 + 4 * p, e_int, reps)
    out["combine"].update(masked_ms=masked["ms"],
                          masked_plain_ms=masked["plain_ms"],
                          masked_bound_ms=masked["bound_ms"])
    out["scan_reduce"] = measure(
        "scan_reduce add int32", dev, rate,
        lambda: se.scan_reduce("add", *i32, low, commutative=True),
        lambda: se.scan_reduce_plain("add", *i32, low, commutative=True),
        None, 5 * e_int * 4 + 4 * p, 1.5 * e_int, reps)
    out["combine_affine"] = measure(
        "combine affine fp32", dev, rate,
        lambda: se.combine("affine", aff[0], aff[1]),
        lambda: se.combine_plain("affine", aff[0], aff[1]),
        None, 6 * e_aff * 4, 3 * e_aff, reps)
    out["exchange_affine"] = measure(
        "exchange affine fp32", dev, rate,
        lambda: se.exchange("affine", aff[0], aff[1], low),
        lambda: se.exchange_plain("affine", aff[0], aff[1], low),
        None, 6 * e_aff * 4 + 4 * p, 3 * e_aff, reps)
    out["scan_reduce_affine"] = measure(
        "scan_reduce affine fp32", dev, rate,
        lambda: se.scan_reduce("affine", *aff, low, commutative=False),
        lambda: se.scan_reduce_plain("affine", *aff, low,
                                     commutative=False),
        None, 10 * e_aff * 4 + 4 * p, 4.5 * e_aff, reps)
    return out


def phase_kernels(dev, rate, *, ragged=(37, 4099), path=None) -> tuple:
    checks = check_instances(dev, *ragged)
    timed = path_kernels(dev, rate, **(path or {}))
    line = {"phase": "kernels", "ragged": list(ragged),
            "instances_checked": checks, "bit_identical": True,
            "timed": timed}
    return line, timed


# ---------------------------------------------------------------------------
# table1: the paper's sweep through the port's entry points
# ---------------------------------------------------------------------------


def exclusive_ref(x: np.ndarray, ufunc) -> np.ndarray:
    out = np.zeros_like(x)
    if x.shape[0] > 1:
        out[1:] = ufunc.accumulate(x[:-1], axis=0)
    return out


def affine_ref(a: np.ndarray, b: np.ndarray):
    """Sequential float64 fold: (exclusive (A, B) per rank, total)."""
    A, B = np.ones(a.shape[1]), np.zeros(a.shape[1])
    ea, eb = np.empty(a.shape), np.empty(a.shape)
    for r in range(a.shape[0]):
        ea[r], eb[r] = A, B
        A, B = a[r] * A, a[r] * B + b[r]
    return (ea, eb), (np.broadcast_to(A, a.shape), np.broadcast_to(B, a.shape))


# float32 composition of up to 512 affine maps, taken in another
# association order than the float64 fold: |err| <= AFFINE_TOL·(1+|ref|)
AFFINE_TOL = 1e-4


def close_affine(got, want) -> float:
    worst = 0.0
    for g, w in zip(got, want):
        g = g.detach().cpu().double().numpy()
        rel = np.abs(g - w) / (1.0 + np.abs(w))
        worst = max(worst, float(rel.max()))
    if worst > AFFINE_TOL:
        raise AssertionError(f"affine scan off the float64 fold by "
                             f"{worst} > {AFFINE_TOL}")
    return worst


def equal_int(got, want: np.ndarray) -> float:
    g = got.detach().cpu().numpy()
    if g.shape != want.shape or not np.array_equal(g, want):
        raise AssertionError("integer scan differs from numpy")
    return 0.0


def run_checked(label, pl, run, check, dev, reps) -> dict:
    """One checked run of ``pl`` (via ``run``), then ``reps`` timed."""
    from repro_torch.core import monoid as monoid_lib
    from repro_torch.core import schedule as sch
    from repro_torch.kernels import scan_engine as se

    m = monoid_lib.get(pl.spec.monoid)
    ir = pl.schedule().kernel_launches(m.commutative, fused=True)
    before = sum(se.launch_counts().values())
    with sch.collect_stats() as st:
        out = run()
    sync(dev)
    delta = sum(se.launch_counts().values()) - before
    want_delta = ir if dev.type == "cuda" else 0
    err = check(out)
    if (st.rounds, st.op_applications) != (pl.rounds, pl.op_applications):
        raise AssertionError(
            f"{label}: measured rounds/⊕ {st.rounds}/{st.op_applications}"
            f" != plan {pl.rounds}/{pl.op_applications}")
    if st.kernel_launches != ir or delta != want_delta:
        raise AssertionError(
            f"{label}: launch counters moved {delta}, stats recorded "
            f"{st.kernel_launches}, IR predicts {ir}")
    times = wall_s(run, dev, reps)
    median = statistics.median(times)
    busy = device_busy_s(run, dev)
    return {"run": label, "algorithm": pl.algorithm,
            "segments": pl.segments, "rounds": st.rounds,
            "ops": st.op_applications, "kernel_launches": ir,
            "launch_delta": delta, "max_err": err,
            "median_s": median, "min_s": min(times), "max_s": max(times),
            "device_busy_s": busy,
            "idle_share": None if busy is None else 1.0 - busy / median}


def phase_table1(dev, *, p=512, ms=(1, 100, 10_000, 100_000),
                 ring=(64, 16 << 20), n_add=100_000, n_affine=4096,
                 reps=5) -> dict:
    from repro_torch.core.scan_api import (
        ScanSpec, plan, scan, scan_with_total)

    rng = np.random.default_rng(2)
    rows = []
    for m in ms:
        xn = rng.integers(-(1 << 62), 1 << 62, (p, m), dtype=np.int64)
        want = exclusive_ref(xn, np.bitwise_xor)
        x = torch.from_numpy(xn).to(dev)
        for algo in ("123", "1doubling", "two_op", "native", "auto"):
            spec = ScanSpec(kind="exclusive", monoid="xor",
                            algorithm=algo)
            pl = plan(spec, p, nbytes=8 * m)
            run = ((lambda x=x, spec=spec: scan(x, spec)) if algo == "auto"
                   else (lambda x=x, pl=pl: pl.execute(x)))
            rows.append(dict(run_checked(
                f"xor/{algo}/m={m}", pl, run,
                lambda out, want=want: equal_int(out, want), dev, reps),
                m=m))
        del x

    p_ring, nbytes = ring
    xn = rng.integers(-(1 << 62), 1 << 62, (p_ring, nbytes // 8),
                      dtype=np.int64)
    want = exclusive_ref(xn, np.bitwise_xor)
    x = torch.from_numpy(xn).to(dev)
    pl = plan(ScanSpec(kind="exclusive", monoid="xor", algorithm="ring",
                       segments=8), p_ring, nbytes=nbytes)
    rows.append(dict(run_checked(
        f"xor/ring/p={p_ring}", pl, lambda: pl.execute(x),
        lambda out: equal_int(out, want), dev, reps), m=nbytes // 8))
    del x, xn, want

    xn = rng.integers(0, 1000, (p, n_add)).astype(np.int32)
    pre = exclusive_ref(xn, np.add)
    tot = np.broadcast_to(xn.sum(axis=0, dtype=np.int32), xn.shape)
    x = torch.from_numpy(xn).to(dev)
    for algo in ("auto", "fused_doubling"):
        pl = plan(ScanSpec(kind="scan_total", monoid="add", algorithm=algo),
                  p, nbytes=4 * n_add)
        spec = ScanSpec(kind="exclusive", monoid="add", algorithm=algo)
        rows.append(dict(run_checked(
            f"add_total/{algo}", pl,
            lambda spec=spec: scan_with_total(x, spec),
            lambda out: equal_int(out[0], pre) + equal_int(out[1], tot),
            dev, reps), m=n_add))
    del x

    an = rng.uniform(0.9, 1.1, (p, n_affine)).astype(np.float32)
    bn = (0.1 * rng.standard_normal((p, n_affine))).astype(np.float32)
    excl, total = affine_ref(an.astype(np.float64), bn.astype(np.float64))
    ab = (torch.from_numpy(an).to(dev), torch.from_numpy(bn).to(dev))
    for kind, algos in (("exclusive", ("auto", "quartering")),
                        ("scan_total", ("auto", "fused_doubling"))):
        for algo in algos:
            spec = ScanSpec(kind=kind, monoid="affine", algorithm=algo)
            pl = plan(spec, p, nbytes=8 * n_affine)
            if kind == "exclusive":
                check = lambda out: close_affine(out, excl)  # noqa: E731
            else:
                check = lambda out: max(  # noqa: E731
                    close_affine(out[0], excl), close_affine(out[1], total))
            run = ((lambda spec=spec: scan(ab, spec)) if algo == "auto"
                   else (lambda pl=pl: pl.execute(ab)))
            rows.append(dict(run_checked(
                f"affine_{kind}/{algo}", pl, run, check, dev, reps),
                m=n_affine))

    a123 = next(r for r in rows if r["run"] == "xor/123/m=1")
    return {"phase": "table1", "p": p, "runs": rows,
            "alpha_s": a123["median_s"] / a123["rounds"]}


# ---------------------------------------------------------------------------
# serve: a burst through the continuous batcher
# ---------------------------------------------------------------------------


def phase_serve(dev, *, p=64, n_req=48, warm_req=16, max_batch=8) -> dict:
    from repro_torch.core.schedule import StackedExecutor
    from repro_torch.serve import Bucket, ScanService

    experts, padded = 60, 64  # qwen2-moe-a2.7b: 60 experts padded to 64
    moe = Bucket(kind="scan_total", monoid="add", shape=(padded,),
                 dtype="int32", name="moe")
    comp = Bucket(kind="exclusive", monoid="add", shape=(),
                  dtype="int32", name="compression")
    svc = ScanService(p, [moe, comp], max_batch=max_batch,
                      executor=StackedExecutor(dev))
    svc.warmup()
    rng = np.random.default_rng(3)

    def burst(n):
        reqs = []
        for _ in range(n):
            if rng.random() < 0.5:
                counts = rng.integers(0, 32, (p, padded)).astype(np.int32)
                counts[:, experts:] = 0
                reqs.append((svc.submit(counts, kind="scan_total",
                                        now=svc.now), counts))
            else:
                slots = rng.integers(1, 4096, p).astype(np.int32)
                reqs.append((svc.submit(slots, kind="exclusive",
                                        now=svc.now), slots))
        t0 = time.perf_counter()
        svc.drain()
        sync(dev)
        seconds = time.perf_counter() - t0
        for req, xn in reqs:
            if req.status != "done":
                raise AssertionError(f"request {req.rid} {req.status}")
            pre = exclusive_ref(xn, np.add)
            if req.bucket.kind == "scan_total":
                equal_int(req.result[0], pre)
                equal_int(req.result[1], np.broadcast_to(
                    xn.sum(axis=0, dtype=np.int32), xn.shape))
            else:
                equal_int(req.result, pre)
        return seconds

    burst(warm_req)  # first launches of each batch shape, unmeasured
    svc.reset_metrics()
    seconds = burst(n_req)
    mt = svc.metrics
    line = {"phase": "serve", "p": p, "requests": n_req,
            "max_batch": max_batch, "all_correct": True,
            "post_warmup_compiles": svc.post_warmup_compiles,
            "fused_round_win": mt.fused_round_win,
            "mean_occupancy": mt.mean_occupancy,
            "p50_latency_s": mt.latency_percentile(50),
            "p99_latency_s": mt.latency_percentile(99),
            "drain_wall_s": seconds}
    if svc.post_warmup_compiles != 0:
        raise AssertionError(f"{svc.post_warmup_compiles} plans after "
                             f"warmup")
    if not mt.fused_round_win >= 2:
        raise AssertionError(f"fused round win {mt.fused_round_win} < 2")
    return line


# ---------------------------------------------------------------------------
# the summary line
# ---------------------------------------------------------------------------

KERNEL_ROWS = (
    # name, wrapper, ⊕ filter, TPU kernel replaced, its Pallas bodies
    ("combine", "combine", "elementwise", f"{TPU_ENGINE}:245",
     "_combine_kernel :245, _masked_combine_kernel :249"),
    ("scan_reduce", "scan_reduce", "elementwise", f"{TPU_ENGINE}:263",
     "_scan_reduce_kernel :263"),
    ("combine_affine", "combine", "affine", f"{TPU_ENGINE}:276",
     "_affine_combine_kernel :276, _affine_masked_kernel :282"),
    ("exchange_affine", "exchange", "affine", f"{TPU_ENGINE}:290",
     "_affine_exchange_kernel :290"),
    ("scan_reduce_affine", "scan_reduce", "affine", f"{TPU_ENGINE}:300",
     "_affine_scan_reduce_kernel :300"),
)


def kernel_summary(timed: dict) -> list:
    from repro_torch.kernels import scan_engine as se

    rows = []
    for name, wrapper, ops, replaces, bodies in KERNEL_ROWS:
        by_op = se.KERNELS[wrapper].launches_by_op
        n = sum(v for op, v in by_op.items()
                if (op == "affine") == (ops == "affine"))
        t = timed[name]
        rows.append({"name": name, "route": "cuda", "source": SE_SOURCE,
                     "replaces": replaces, "pallas_bodies": bodies,
                     "launches": n,
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"],
                     "host_ms": t["host_ms"]})
    idle = [r["name"] for r in rows if r["launches"] == 0]
    if idle:
        raise AssertionError(f"main path never launched {idle}")
    return rows


def main() -> int:
    # the port first: run alone, without the repository, this raises
    from repro_torch.kernels import scan_engine as se

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is present", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    build = phase_build()
    emit(build)
    rate = hbm_rate(torch.cuda.get_device_name(0))
    line, timed = phase_kernels(dev, rate)
    emit(line)
    se.reset_launch_counts()  # the main path's launches from here on
    emit(phase_table1(dev))
    emit(phase_serve(dev))
    emit({"kernels": kernel_summary(timed)})
    print(card_info(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
