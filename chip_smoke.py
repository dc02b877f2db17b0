"""Drive the PyTorch port's exclusive-scan path on one NVIDIA card.

Run from the repository root, on a machine with an H100:

    python3 chip_smoke.py

It builds the kernels from ``src/repro_torch/kernels/csrc`` and prints
one JSON line per phase:

  build    compile every kernel source (one nvcc per source, sm_90a, all
           at once) and load them
  kernels  every kernel instance against its plain PyTorch version (bit
           for bit) at a ragged size: the round kernels at (37, 4099)
           and (37, 4104) (rows unaligned and aligned to 16 bytes), also
           with row tables (peer rows read in place: shifts by 1 and 5,
           an xor permutation, every row -1); the chunked-scan kernels
           at (3, 37, 4099) and at shapes that reach both regimes of
           ``monoid_chunk`` (the look-back at (1, 100 003, 1),
           (3, 50 001, 1), (1, 1000, 1), and 20 runs at (1, 10⁶, 1) that
           must agree; the strip stream at (2, 4099, 37) and (1, 4096,
           8192)); routing at (1000, 3, 61); then each kernel at the
           shape its path gives it: kernel, plain and library times on
           the card (CUDA events over calls queued behind a sleep, so
           the host's issue time is not in them) beside the least time
           the card's HBM allows, and the kernel's time per call as
           Python issues it; beside the combine, one shift round with
           the peer row read in place against the old gather-then-
           combine
  table1   ``plan(...).execute(x)`` and ``scan(x, spec)`` over p = 512
           ranks for the paper's algorithms at m in {1, 100, 10 000,
           100 000} int64 under MPI_BXOR, plus a pinned ring, scan_total
           and affine runs; each output against numpy, each stats count
           against the plan, and the kernels' launch counters against the
           IR's ``kernel_launches``; wall times (median, min, max), the
           card's busy time from torch.profiler and its idle share, and
           ``alpha_s`` (seconds per round of 123 at m = 1)
  serve    a ScanService burst of 48 requests over the MoE (payloads from
           ``serve.workloads.moe_dispatch_payload``, qwen2-moe-a2.7b) and
           compression buckets, answers against numpy
  ops      each ``kernels.ops`` entry point once at a real size, checked
           against numpy or a float64 reference
  cp_ssm   ``cp_ssm_scan`` at Jamba-1.5-Large's mamba width (16 384 ×
           16 state floats per token, S = 4096, p = 8 and 64, four carry
           algorithms): h against a float64 recurrence of the whole
           sequence on 8192 sampled columns, rounds and ⊕ against the
           plan, every kernel's launches against the path's
  moe_dispatch  ``dispatch_slots`` at Qwen1.5-MoE-A2.7B's routing (p =
           64 ranks of 4096 tokens, top-4 of 60 experts padded to 64):
           every output equal to numpy, the drop fraction

then the ``kernels`` summary (launches counted over the main path's
phases, table1 to moe_dispatch, each with its counters set to 0 just
before it), the card's name and power limit as nvidia-smi prints them,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero; it also exits non-zero, printing no
result, when no CUDA card is present or when it is run outside the
repository.
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
    ``fn``: the union of the device intervals torch.profiler records
    for a second call, told from the first by a sleep kernel between
    them, on the device's own clock (the profiler can miss the first
    kernel it sees, and its host and device clocks can disagree by
    more than a short call lasts); None where it records none."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(1000)  # the marker: a spin_kernel
        torch.cuda.synchronize(dev)
        fn()
        torch.cuda.synchronize(dev)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    marks = [e.end_ns() for e in events if "spin_kernel" in e.name()]
    if not marks:
        return None
    spans = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.start_ns() >= max(marks)
                   and "spin_kernel" not in e.name())
    busy_ns, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy_ns, end = busy_ns + b - a, b
        elif b > end:
            busy_ns, end = busy_ns + b - end, b
    return busy_ns * 1e-9 if busy_ns > 0 else None


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
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build, moe_routing as mr
    from repro_torch.kernels import scan_engine as se

    t0 = time.perf_counter()
    sources = sorted(_build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        list(pool.map(_build.compile_source, sources))
    for load in (se._lib, se._chunk_lib, mr._lib):  # load and bind
        load()
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


def row_tables(p: int, dev) -> dict:
    """Row tables as the executor builds them: shifts by 1 and 5 (any
    negative entry reads zeros), an xor permutation (partners past p
    read zeros), every row -1."""
    r = np.arange(p)
    tabs = {"shift1": r - 1, "shift5": r - 5,
            "xor4": np.where((r ^ 4) < p, r ^ 4, -1),
            "none": np.full(p, -1)}
    return {k: torch.from_numpy(v.astype(np.int32)).to(dev)
            for k, v in tabs.items()}


def check_instances(dev, p: int, n: int) -> int:
    """Every (template, ⊕, dtype) instance bit-identical to its plain
    version at (p, n), with plain operands and with a row-table operand
    (against the plain version on the gathered rows); returns the
    number of comparisons."""
    from repro_torch.kernels import scan_engine as se

    rng = np.random.default_rng(0)
    mask = torch.from_numpy(
        rng.integers(0, 2, p).astype(np.int32)).to(dev)
    tables = row_tables(p, dev)
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
            for src in tables.values():
                ra = se.Rows(a, src)
                ga = se.gather_rows(ra)
                pairs += [
                    (se.combine(op, ra, b, mask=mask),
                     se.combine_plain(op, ga, b, mask=mask)),
                    (se.combine(op, b, ra),
                     se.combine_plain(op, b, ga)),
                    (se.exchange(op, ra, b, mask),
                     se.exchange_plain(op, ga, b, mask))]
                pairs += list(zip(
                    se.scan_reduce(op, ra, b, c, mask, commutative=True),
                    se.scan_reduce_plain(op, ga, b, c, mask,
                                         commutative=True)))
            sync(dev)
            for got, want in pairs:
                if not identical(got, want):
                    raise AssertionError(
                        f"round kernel {op}/{dt} at p={p} n={n} differs "
                        f"from its plain version by "
                        f"{max_abs_err(got, want)}")
                checks += 1
    return checks


def check_chunk_instances(dev, g: int, t: int, d: int, *,
                          ints_only: bool = False,
                          affine: bool = True) -> int:
    """Every chunked-scan instance (each elementwise ⊕ and dtype, the
    affine scan, summary and general forms) bit-identical to its plain
    version at (g, t, d); returns the number of comparisons.
    ``ints_only`` keeps the integer ⊕ (the look-back regime at D = 1,
    where a float's plain version is a row loop of t steps)."""
    from repro_torch.kernels import scan_engine as se

    rng = np.random.default_rng(10)
    checks = 0

    def same(got, want, label):
        nonlocal checks
        sync(dev)
        for gl, wl in zip(got, want):
            if (gl is None) != (wl is None) or (
                    gl is not None and not identical(gl, wl)):
                raise AssertionError(
                    f"chunked-scan kernel {label} at {(g, t, d)} differs "
                    f"from its plain version")
            checks += gl is not None
    for op in OPS[:-1]:
        for dt in DTYPES:
            if not se.kernel_serves(op, dt) or (
                    ints_only and dt.is_floating_point):
                continue
            x = rand_leaf(rng, dt, g * t, d, dev).reshape(g, t, d)
            init = rand_leaf(rng, dt, g, d, dev)
            for kw in ({}, {"init": init, "exclusive": False,
                            "final": True}):
                same(se.monoid_chunk(x, op, **kw),
                     se.monoid_chunk_plain(x, op, **kw), f"{op}/{dt}")
    if not affine:
        return checks
    for dt in (torch.float32, torch.float64):
        a, b = (torch.from_numpy(rng.uniform(0.9, 1.1, (g, t, d)))
                .to(device=dev, dtype=dt) for _ in range(2))
        a0, h0 = (rand_leaf(rng, dt, g, d, dev) for _ in range(2))
        for kw in ({"h0": h0, "h_final": True},
                   {"h_traj": False, "a_final": True, "h_final": True},
                   {"a0": a0, "h0": h0, "exclusive": True, "a_traj": True,
                    "a_final": True, "h_final": True}):
            same(se.affine_chunk(a, b, **kw),
                 se.affine_chunk_plain(a, b, **kw), f"affine/{dt}")
    return checks


# (g, t, d, ints_only) shapes that reach both regimes of monoid_chunk:
# the look-back (integer ⊕ at D = 1) across many tiles with a ragged
# last one, and in one tile; the strip stream at ragged D and at the
# ops path's (4096, 8192)
REGIME_SHAPES = ((1, 100_003, 1, True), (3, 50_001, 1, True),
                 (1, 1000, 1, False), (2, 4099, 37, False),
                 (1, 4096, 8192, False))


def check_regimes(dev, n: int = 10**6, runs: int = 20) -> dict:
    """monoid_chunk at REGIME_SHAPES, bit for bit, and the look-back
    ``runs`` times at (1, n, 1): every output the same, the plain one."""
    from repro_torch.kernels import scan_engine as se

    checks = {}
    for g, t, d, ints_only in REGIME_SHAPES:
        checks[f"{g}x{t}x{d}"] = check_chunk_instances(
            dev, g, t, d, ints_only=ints_only, affine=False)
        torch.cuda.empty_cache()
    x = torch.from_numpy(np.random.default_rng(13).integers(
        -(1 << 40), 1 << 40, (1, n, 1))).to(dev)
    want = se.monoid_chunk_plain(x, "add", final=True)
    for _ in range(runs):
        got = se.monoid_chunk(x, "add", final=True)
        sync(dev)
        if not (identical(got[0], want[0]) and identical(got[1], want[1])):
            raise AssertionError("the look-back scan gave another result "
                                 "on a repeated run")
    return {"shapes": checks, "repeat_runs_identical": runs}


def check_routing(dev, t: int, k: int, e: int) -> int:
    """The routing kernel bit-identical to its plain version at (t, k)
    and e experts, one group and three."""
    from repro_torch.kernels import moe_routing as mr

    rng = np.random.default_rng(11)
    checks = 0
    for shape in ((t, k), (3, t, k)):
        ids = torch.from_numpy(rng.integers(0, e, shape).astype(np.int32))
        ids = ids.to(dev)
        got = mr.moe_routing(ids, num_experts=e)
        want = mr.moe_routing_plain(ids, num_experts=e)
        sync(dev)
        if not identical(got, want):
            raise AssertionError(f"moe_routing at {shape}, E={e} differs "
                                 f"from its plain version")
        checks += 2
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
    from repro_torch.core import schedule as sch
    from repro_torch.kernels import scan_engine as se

    rng = np.random.default_rng(1)
    low = (torch.arange(p, device=dev) & 1).to(torch.int32)  # skip-1 side
    keep = (torch.arange(p, device=dev) >= 1).to(torch.int32)
    shift1 = row_tables(p, dev)["shift1"]
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
    # one shift round (skip 1, masked) as the executor runs it: the peer
    # row read in place; beside it the old two steps, the _shift_rows
    # copy and then the combine, and the copy alone
    peer = se.Rows(x64[0], shift1)
    shift = measure(
        "shift round xor int64", dev, rate,
        lambda: se.combine("xor", peer, x64[1], mask=keep),
        lambda: se.combine_plain("xor", se.gather_rows(peer), x64[1],
                                 mask=keep),
        None, 3 * e_int * 8 + 8 * p, e_int, reps)
    two_step = device_ms(
        lambda: se.combine("xor", sch._shift_rows(x64[0], 1), x64[1],
                           mask=keep), dev, reps)
    copy_only = device_ms(lambda: sch._shift_rows(x64[0], 1), dev, reps)
    out["combine"].update(masked_ms=masked["ms"],
                          masked_plain_ms=masked["plain_ms"],
                          masked_bound_ms=masked["bound_ms"],
                          shift_round_ms=shift["ms"],
                          shift_round_bound_ms=shift["bound_ms"],
                          shift_round_two_step_ms=two_step,
                          shift_copy_ms=copy_only)
    out["exchange"] = measure(
        "exchange add int64", dev, rate,
        lambda: se.exchange("add", *x64, low),
        lambda: se.exchange_plain("add", *x64, low),
        lambda: torch.add(*x64), 3 * e_int * 8 + 4 * p, e_int, reps)
    out["exchange"]["library"] = "torch.add (r ⊕ w on every rank)"
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


def path_chunk_kernels(dev, rate, *, ex=(4096, 8192), ex_small=10**6,
                       aff=(8, 512, 262_144), route=(64, 4096, 4, 64),
                       reps=5) -> dict:
    """The chunked-scan and routing kernels at the shapes their paths
    give them: ops.exscan's (T, D) and 1-D vector, cp_ssm's per-rank
    shards at p = 8 (G = p·B, S/p, d_inner·d_state), moe_dispatch's
    p = 64 ranks of 4096 tokens, top-4 of 64 padded experts."""
    from repro_torch.kernels import moe_routing as mr
    from repro_torch.kernels import scan_engine as se

    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}
    t, d = ex
    xf = torch.randn((t, d), generator=gen, device=dev)
    ms = measure(
        "monoid_exscan add fp32", dev, rate,
        lambda: se.monoid_exscan(xf, "add"),
        lambda: se.monoid_chunk_plain(xf, "add")[0],
        lambda: torch.cumsum(xf, dim=0), 2 * t * d * 4, t * d, reps)
    xi = torch.randint(-(1 << 62), 1 << 62, (t, d), generator=gen,
                       device=dev)
    xor = measure(
        "monoid_exscan xor int64", dev, rate,
        lambda: se.monoid_exscan(xi, "xor"),
        lambda: se.monoid_chunk_plain(xi, "xor")[0], None,
        2 * t * d * 8, t * d, reps)
    xs = torch.randint(-(1 << 40), 1 << 40, (ex_small, 1), generator=gen,
                       device=dev)
    small = measure(
        "monoid_exscan add int64 small-D", dev, rate,
        lambda: se.monoid_exscan(xs, "add"),
        lambda: se.monoid_chunk_plain(xs, "add")[0],
        lambda: torch.cumsum(xs, dim=0), 2 * ex_small * 8, ex_small, reps)
    del xf, xi, xs
    ms.update(shape=list(ex), library="torch.cumsum (inclusive)",
              regime=se.monoid_chunk_regime("add", torch.float32, d),
              xor_int64={"regime": se.monoid_chunk_regime(
                  "xor", torch.int64, d), **{k: xor[k] for k in (
                      "ms", "plain_ms", "bound_ms", "host_ms")}},
              small_d_int64={"shape": [ex_small, 1],
                             "regime": se.monoid_chunk_regime(
                                 "add", torch.int64, 1),
                             **{k: small[k] for k in (
                                 "ms", "plain_ms", "library_ms",
                                 "bound_ms", "host_ms")}})
    out["monoid_exscan"] = ms

    g, t, d = aff
    a = torch.rand(aff, generator=gen, device=dev).mul_(0.1).add_(0.9)
    b = torch.randn(aff, generator=gen, device=dev)
    h0 = torch.randn((g, d), generator=gen, device=dev)
    e = g * t * d
    scan_t = measure(
        "affine_chunk_scan fp32", dev, rate,
        lambda: se.affine_chunk_scan(a, b, h0),
        lambda: se.affine_chunk_plain(a, b, h0=h0, h_final=True)[1::2],
        None, 3 * e * 4 + 2 * g * d * 4, 2 * e, reps)
    summ = measure(
        "affine_chunk_summary fp32", dev, rate,
        lambda: se.affine_chunk_summary(a, b),
        lambda: se.affine_chunk_plain(a, b, h_traj=False, a_final=True,
                                      h_final=True)[2:],
        None, 2 * e * 4 + 2 * g * d * 4, 3 * e, reps)
    del a, b, h0
    scan_t.update(shape=list(aff), summary={
        k: summ[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "host_ms")})
    out["affine_chunk"] = scan_t

    g, t, k, n_exp = route
    ids = torch.randint(0, n_exp, (g, t, k), generator=gen, device=dev,
                        dtype=torch.int32)
    keyed = (ids + n_exp * torch.arange(g, device=dev,
                                         dtype=torch.int32)[:, None, None]
             ).flatten()
    rt = measure(
        "moe_routing", dev, rate,
        lambda: mr.moe_routing(ids, num_experts=n_exp),
        lambda: mr.moe_routing_plain(ids, num_experts=n_exp),
        lambda: torch.bincount(keyed, minlength=g * n_exp),
        2 * g * t * k * 4 + g * n_exp * 4, g * t * k, reps)
    rt.update(shape=[g, t, k], experts=n_exp,
              library="torch.bincount (counts only)")
    out["moe_routing"] = rt
    return out


def phase_kernels(dev, rate, *, ragged=(37, 4099), aligned_n=4104,
                  ragged_g=3, routing=(1000, 3, 61), path=None,
                  chunk_path=None):
    checks = check_instances(dev, *ragged)
    aligned = (ragged[0], aligned_n)
    checks_aligned = check_instances(dev, *aligned)
    chunk_checks = check_chunk_instances(dev, ragged_g, *ragged)
    regimes = check_regimes(dev)
    routing_checks = check_routing(dev, *routing)
    timed = path_kernels(dev, rate, **(path or {}))
    timed.update(path_chunk_kernels(dev, rate, **(chunk_path or {})))
    line = {"phase": "kernels", "ragged": list(ragged),
            "instances_checked": checks, "aligned": list(aligned),
            "instances_checked_aligned": checks_aligned,
            "chunk_ragged": [ragged_g, *ragged],
            "chunk_instances_checked": chunk_checks,
            "chunk_regimes_checked": regimes,
            "routing_ragged": list(routing),
            "routing_checked": routing_checks, "bit_identical": True,
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


ROUND_KERNELS = ("combine", "exchange", "scan_reduce")


def run_checked(label, pl, run, check, dev, reps, path_launches=None) -> dict:
    """One checked run of ``pl`` (via ``run``), then ``reps`` timed.
    The round kernels must launch what the IR predicts, and every other
    kernel what ``path_launches`` names (none by default)."""
    from repro_torch.core import monoid as monoid_lib
    from repro_torch.core import schedule as sch
    from repro_torch.kernels import scan_engine as se

    m = monoid_lib.get(pl.spec.monoid)
    ir = pl.schedule().kernel_launches(m.commutative, fused=True)
    before = se.launch_counts()
    with sch.collect_stats() as st:
        out = run()
    sync(dev)
    after = se.launch_counts()
    moved = {k: after[k] - before.get(k, 0) for k in after}
    delta = sum(moved[k] for k in ROUND_KERNELS)
    others = {k: v for k, v in moved.items() if k not in ROUND_KERNELS}
    on_card = dev.type == "cuda"
    want_others = {k: (path_launches or {}).get(k, 0) if on_card else 0
                   for k in others}
    err = check(out)
    if (st.rounds, st.op_applications) != (pl.rounds, pl.op_applications):
        raise AssertionError(
            f"{label}: measured rounds/⊕ {st.rounds}/{st.op_applications}"
            f" != plan {pl.rounds}/{pl.op_applications}")
    if st.kernel_launches != ir or delta != (ir if on_card else 0):
        raise AssertionError(
            f"{label}: launch counters moved {delta}, stats recorded "
            f"{st.kernel_launches}, IR predicts {ir}")
    if others != want_others:
        raise AssertionError(f"{label}: kernels launched {others}, the "
                             f"path predicts {want_others}")
    times = wall_s(run, dev, reps)
    median = statistics.median(times)
    busy = device_busy_s(run, dev)
    row = {"run": label, "algorithm": pl.algorithm,
           "segments": pl.segments, "rounds": st.rounds,
           "ops": st.op_applications, "kernel_launches": ir,
           "launch_delta": delta, "max_err": err,
           "median_s": median, "min_s": min(times), "max_s": max(times),
           "device_busy_s": busy,
           "idle_share": None if busy is None else 1.0 - busy / median}
    if path_launches:
        row["path_launch_delta"] = {k: v for k, v in others.items() if v}
    return row


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
    from repro_torch import configs
    from repro_torch.core.schedule import StackedExecutor
    from repro_torch.serve import ScanService, workloads

    cfg = configs.get("qwen2-moe-a2.7b")  # 60 experts padded to 64
    moe = workloads.moe_bucket(cfg, name="moe")
    comp = workloads.compression_bucket(name="compression")
    svc = ScanService(p, [moe, comp], max_batch=max_batch,
                      executor=StackedExecutor(dev))
    svc.warmup()
    rng = np.random.default_rng(3)

    def burst(n):
        reqs = []
        for _ in range(n):
            if rng.random() < 0.5:
                counts = workloads.moe_dispatch_payload(cfg, p, rng,
                                                        device=dev)
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
# ops: the kernels' public entry points
# ---------------------------------------------------------------------------

U32 = 2.0 ** -24  # unit roundoff of float32


def check_left_fold(got, x) -> float:
    """An exclusive float32 sum along axis 0 against the float64 one,
    within recursive summation's a-priori bound (Higham §4.2):
    |err_t| <= γ_t·Σ_{i<t}|x_i|, γ_t = t·u/(1 − t·u).  Returns the
    largest |err| as a share of its bound."""
    x64 = x.double()
    ref = torch.cumsum(x64, 0) - x64
    mass = torch.cumsum(x64.abs(), 0) - x64.abs()
    t = torch.arange(x.shape[0], device=x.device,
                     dtype=torch.float64)[:, None]
    bound_ = t * U32 / (1.0 - t * U32) * mass
    err = (got.double() - ref).abs()
    if bool((err > bound_).any()):
        raise AssertionError("float exscan outside the summation bound")
    share = err / bound_.clamp_min(1e-300)
    return float(share.max())


def affine_ref_cols(a, b, cols, h0=None):
    """float64 recurrence h_t = a_t·h_{t-1} + b_t along axis 0 of the
    (T, D) tensors on the columns ``cols``: (h (T, c), A = ∏a (c,))."""
    an = a[:, cols].double().cpu().numpy()
    bn = b[:, cols].double().cpu().numpy()
    h = np.zeros(len(cols)) if h0 is None else \
        h0[cols].double().cpu().numpy()
    A = np.ones(len(cols))
    hs = np.empty_like(an)
    for t in range(an.shape[0]):
        h = an[t] * h + bn[t]
        A = an[t] * A
        hs[t] = h
    return hs, A


def close_rel(got, want) -> float:
    """|got − want| <= AFFINE_TOL·(1 + |want|) for float64 ``want``."""
    g = got.detach().double().cpu().numpy()
    rel = np.abs(g - want) / (1.0 + np.abs(want))
    worst = float(rel.max())
    if worst > AFFINE_TOL:
        raise AssertionError(f"off the float64 reference by {worst} > "
                             f"{AFFINE_TOL}")
    return worst


def routing_ref(ids: np.ndarray, n_exp: int):
    """Positions and counts of (G, N) expert ids, numpy, exact: a
    stable sort by (group, expert) ranks each entry among its peers."""
    g, n = ids.shape
    key = (ids.astype(np.int64) + n_exp * np.arange(g)[:, None]).ravel()
    order = np.argsort(key, kind="stable")
    first = np.searchsorted(key[order], key[order], side="left")
    pos = np.empty(key.size, np.int64)
    pos[order] = np.arange(key.size) - first
    counts = np.bincount(key, minlength=g * n_exp).reshape(g, n_exp)
    return pos.reshape(g, n).astype(np.int32), counts.astype(np.int32)


def expect_launches(label, before, want: dict, dev) -> dict:
    """The kernels' launch counters moved exactly as ``want`` says (on
    the card; the CPU runs the plain versions and launches nothing)."""
    from repro_torch.kernels import scan_engine as se

    after = se.launch_counts()
    moved = {k: after[k] - before.get(k, 0) for k in after}
    on_card = dev.type == "cuda"
    want = {k: want.get(k, 0) if on_card else 0 for k in moved}
    if moved != want:
        raise AssertionError(f"{label}: kernels launched {moved}, the path "
                             f"predicts {want}")
    return {k: v for k, v in moved.items() if v}


def phase_ops(dev, *, t=4096, d=8192, n=10**6, route=(4096, 4, 64),
              cols=1024) -> dict:
    """Each ``kernels.ops`` entry point once, checked: ``exscan`` of a
    (T, D) float32 array and of a 1-D int64 vector, ``ssm_scan`` from
    h0, ``ssm_chunk_summary`` and ``moe_routing``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import scan_engine as se

    gen = torch.Generator(device=dev).manual_seed(20)
    rng = np.random.default_rng(20)
    rows = []

    def call(name, fn, want, check):
        before = se.launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        seconds = time.perf_counter() - t0
        moved = expect_launches(f"ops.{name}", before, want, dev)
        rows.append({"call": name, "seconds": seconds, "launches": moved,
                     "check": check(out)})

    x = torch.randn((t, d), generator=gen, device=dev)
    call("exscan(float32 (T, D))", lambda: ops.exscan(x, device=dev),
         {"monoid_chunk": 1}, lambda out: check_left_fold(out, x))
    vn = rng.integers(-(1 << 40), 1 << 40, n)
    v = torch.from_numpy(vn).to(dev)
    call("exscan(int64 (n,))", lambda: ops.exscan(v, device=dev),
         {"monoid_chunk": 1},
         lambda out: equal_int(out, np.concatenate(
             [[0], np.cumsum(vn)[:-1]])))
    del x, v
    a = torch.rand((t, d), generator=gen, device=dev).mul_(0.1).add_(0.9)
    b = torch.randn((t, d), generator=gen, device=dev)
    h0 = torch.randn((d,), generator=gen, device=dev)
    pick = np.sort(rng.choice(d, cols, replace=False))
    cidx = torch.from_numpy(pick).to(dev)
    hs, _ = affine_ref_cols(a, b, cidx, h0)
    call("ssm_scan", lambda: ops.ssm_scan(a, b, h0, device=dev),
         {"affine_chunk": 1},
         lambda out: max(close_rel(out[0][:, cidx], hs),
                         close_rel(out[1][cidx], hs[-1])))
    h_free, A = affine_ref_cols(a, b, cidx)
    call("ssm_chunk_summary", lambda: ops.ssm_chunk_summary(a, b, device=dev),
         {"affine_chunk": 1},
         lambda out: max(close_rel(out[0][cidx], A),
                         close_rel(out[1][cidx], h_free[-1])))
    del a, b, h0
    tok, k, n_exp = route
    idn = rng.integers(0, n_exp, (tok, k)).astype(np.int32)
    pos_w, cnt_w = routing_ref(idn.reshape(1, -1), n_exp)
    call("moe_routing", lambda: ops.moe_routing(idn, n_exp, device=dev),
         {"moe_routing": 1},
         lambda out: equal_int(out[0], pos_w.reshape(tok, k))
         + equal_int(out[1], cnt_w[0]))
    return {"phase": "ops", "calls": rows}


# ---------------------------------------------------------------------------
# cp_ssm: context-parallel SSM prefill at Jamba-1.5-Large's mamba width
# ---------------------------------------------------------------------------


def phase_cp_ssm(dev, *, ps=(8, 64), seq=4096, bsz=1,
                 state=(16_384, 16), algos=("auto", "123", "1doubling",
                                            "two_op"),
                 cols=8192, reps=5) -> dict:
    """``cp_ssm_scan`` over p ranks of a (B, S) sequence with Jamba's
    d_inner × d_state state per token; h against a float64 recurrence
    of the whole sequence on a fixed sample of columns."""
    from repro_torch.core.scan_api import plan
    from repro_torch.models.context_parallel import _carry_spec, cp_ssm_scan

    if bsz != 1:
        raise ValueError("the column sample reads one sequence (B = 1)")
    d = int(np.prod(state))
    pick = np.sort(np.random.default_rng(30).choice(d, cols, replace=False))
    cidx = torch.from_numpy(pick).to(dev)
    rows = []
    for p in ps:
        shape = (p, bsz, seq // p) + tuple(state)
        gen = torch.Generator(device=dev).manual_seed(31 + p)
        a = torch.rand(shape, generator=gen, device=dev).mul_(0.1).add_(0.9)
        b = torch.randn(shape, generator=gen, device=dev)
        want, _ = affine_ref_cols(a.reshape(seq, d), b.reshape(seq, d), cidx)
        for algo in algos:
            cspec = _carry_spec(None, algo)
            pl = plan(cspec, p, nbytes=2 * bsz * d * 4)
            rows.append(dict(run_checked(
                f"cp_ssm/p={p}/{algo}", pl,
                lambda cspec=cspec: cp_ssm_scan(a, b, spec=cspec),
                lambda out: close_rel(out.reshape(seq, d)[:, cidx], want),
                dev, reps, path_launches={"affine_chunk": 2}),
                p=p, tokens_per_rank=seq // p))
        del a, b
        torch.cuda.empty_cache()
    return {"phase": "cp_ssm", "model": "jamba-1.5-large-398b",
            "seq": seq, "batch": bsz, "state": list(state),
            "state_floats_per_token": d, "cols_checked": cols,
            "runs": rows}


# ---------------------------------------------------------------------------
# moe_dispatch: dispatch accounting at Qwen1.5-MoE-A2.7B's routing
# ---------------------------------------------------------------------------


def dispatch_ref(top: np.ndarray, e_pad: int, cap: int):
    """numpy: positions, offsets, totals, keep and slot of (p, n0, k)
    router choices."""
    p, n0, k = top.shape
    flat = top.reshape(p, n0 * k)
    pos, counts = routing_ref(flat, e_pad)
    offsets = np.cumsum(counts, axis=0, dtype=np.int32) - counts
    totals = np.broadcast_to(counts.sum(axis=0, dtype=np.int32), counts.shape)
    gpos = np.take_along_axis(offsets, flat, axis=1) + pos
    keep = (pos < cap) & (gpos < cap * p)
    slot = np.where(keep, flat * cap + pos, e_pad * cap).astype(np.int32)
    return pos.reshape(p, n0, k), offsets, totals, keep, slot


def phase_moe_dispatch(dev, *, p=64, n0=4096, algos=("auto", "123"),
                       reps=5) -> dict:
    from repro_torch import configs
    from repro_torch.core.scan_api import ScanSpec, plan
    from repro_torch.models import params
    from repro_torch.models.moe import dispatch_slots

    cfg = configs.get("qwen2-moe-a2.7b")
    k, e_pad = cfg.top_k, params.experts_padded(cfg)
    gen = torch.Generator(device=dev).manual_seed(40)
    # k distinct experts of the real ones per token
    top = torch.rand((p, n0, cfg.n_experts), generator=gen, device=dev) \
        .topk(k, dim=-1).indices.to(torch.int32).contiguous()
    cap = max(8, int(cfg.capacity_factor * n0 * k / e_pad))
    want = dispatch_ref(top.cpu().numpy(), e_pad, cap)
    names = ("positions", "offsets", "totals", "keep", "slot")

    def check(out):
        for name, got, w in zip(names, out, want):
            g = got.cpu().numpy()
            if g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"moe_dispatch {name} differs from "
                                     f"numpy")
        return 0.0

    rows = []
    for algo in algos:
        spec = ScanSpec(kind="exclusive", monoid="add", algorithm=algo)
        pl = plan(ScanSpec(kind="scan_total", monoid="add",
                           algorithm=algo), p, nbytes=4 * e_pad)
        rows.append(run_checked(
            f"moe_dispatch/{algo}", pl,
            lambda spec=spec: dispatch_slots(cfg, top, spec=spec), check,
            dev, reps, path_launches={"moe_routing": 1}))
    return {"phase": "moe_dispatch", "model": cfg.name, "p": p,
            "tokens_per_rank": n0, "top_k": k, "experts": cfg.n_experts,
            "experts_padded": e_pad, "capacity": cap,
            "drop_fraction": float(1.0 - want[3].mean()), "runs": rows}


# ---------------------------------------------------------------------------
# the summary line
# ---------------------------------------------------------------------------

CS_SOURCE = "src/repro_torch/kernels/csrc/chunked_scan.cu"
MR_SOURCE = "src/repro_torch/kernels/csrc/moe_routing.cu"
TPU_ROUTING = "src/repro/kernels/moe_routing.py"

KERNEL_ROWS = (
    # name, wrapper, ⊕ filter (None: all), source, TPU kernel replaced,
    # its Pallas bodies
    ("combine", "combine", "elementwise", SE_SOURCE, f"{TPU_ENGINE}:245",
     "_combine_kernel :245, _masked_combine_kernel :249"),
    ("exchange", "exchange", "elementwise", SE_SOURCE, f"{TPU_ENGINE}:254",
     "_exchange_kernel :254"),
    ("scan_reduce", "scan_reduce", "elementwise", SE_SOURCE,
     f"{TPU_ENGINE}:263", "_scan_reduce_kernel :263"),
    ("combine_affine", "combine", "affine", SE_SOURCE, f"{TPU_ENGINE}:276",
     "_affine_combine_kernel :276, _affine_masked_kernel :282"),
    ("exchange_affine", "exchange", "affine", SE_SOURCE, f"{TPU_ENGINE}:290",
     "_affine_exchange_kernel :290"),
    ("scan_reduce_affine", "scan_reduce", "affine", SE_SOURCE,
     f"{TPU_ENGINE}:300", "_affine_scan_reduce_kernel :300"),
    ("monoid_exscan", "monoid_chunk", None, CS_SOURCE, f"{TPU_ENGINE}:152",
     "_scan_body :109 as monoid_exscan :192"),
    ("affine_chunk", "affine_chunk", None, CS_SOURCE, f"{TPU_ENGINE}:152",
     "_scan_body :109 as affine_chunk_scan :211, affine_chunk_summary "
     ":227"),
    ("moe_routing", "moe_routing", None, MR_SOURCE, f"{TPU_ROUTING}:54",
     "_routing_kernel :26"),
)

# Rows no main path can launch, and why.
OFF_PATH = {
    "exchange": "every elementwise ⊕ is commutative, so no round runs the "
                "non-commutative butterfly exchange; checked bit for bit "
                "and timed in the kernels phase only",
}


def kernel_summary(timed: dict, launched: dict) -> list:
    """One row per kernel; ``launched`` holds the main path's launches
    by wrapper and ⊕."""
    rows = []
    for name, wrapper, ops, source, replaces, bodies in KERNEL_ROWS:
        by_op = launched.get(wrapper, {})
        n = sum(v for op, v in by_op.items()
                if ops is None or (op == "affine") == (ops == "affine"))
        t = timed[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "pallas_bodies": bodies,
               "launches": n,
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"],
               "library_ms": t["library_ms"], "host_ms": t["host_ms"]}
        if name in OFF_PATH:
            row["off_path"] = OFF_PATH[name]
        rows.append(row)
    idle = [r["name"] for r in rows
            if r["launches"] == 0 and r["name"] not in OFF_PATH]
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
    launched: dict = {}
    # each path of the main path: counts set to 0 just before, read after
    for phase in (phase_table1, phase_serve, phase_ops, phase_cp_ssm,
                  phase_moe_dispatch):
        se.reset_launch_counts()
        line = phase(dev)
        line["launches"] = {}
        for name, fn in se.KERNELS.items():
            for op, n in fn.launches_by_op.items():
                by_op = launched.setdefault(name, {})
                by_op[op] = by_op.get(op, 0) + n
            if fn.launches:
                line["launches"][name] = fn.launches
        emit(line)
    emit({"kernels": kernel_summary(timed, launched)})
    print(card_info(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
