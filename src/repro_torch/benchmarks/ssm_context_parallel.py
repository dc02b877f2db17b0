"""Context-parallel SSM prefill benchmark: the cross-rank state carry
through each exscan algorithm, the sequence split 8 ways.

The AFFINE ⊕ composes (decay, state) pairs: the "expensive operator"
case where the 123-doubling algorithm's q−1 applications beat two-⊕
doubling's ~2·log₂p.  ``cp_ssm_scan`` takes the global (B, S, D) = (1,
4096, 1024) fp32 sequence split into p = 8 shards on a leading rank
axis, (8, 1, 512, 1024), on ``--device`` (the card by default): one
``affine_chunk`` launch for the shards' summaries, the carry's plan
through the affine round kernels, one ``affine_chunk`` rescan.  The
algorithm is pinned per row through ``ScanSpec`` (plus ``"auto"``, the
planner's pick); a row is the minimum of 10 synchronised calls after
one untimed one, as in the JAX package's
``benchmarks/ssm_context_parallel.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.ssm_context_parallel
        [--device cpu] [--json [PATH]]
        [--nprocs N --p-intra P --backend {gloo,nccl}] [--check]

With ``--nprocs N --p-intra P`` (N·P = 8) the same cells also run
across a :class:`~repro_torch.dist.WorkerPool` of N processes holding P
ranks each (``WorkerPool.call("cp_ssm_scan")``; under ``nccl`` one
process a card, under ``gloo`` all on ``--device``), one row an
algorithm beside the stacked ones: the minimum of 10 pool calls (each
the slowest process's wall) after one untimed one.  ``--check`` exits
non-zero unless every pool row's h equals the stacked run's bit for
bit (and, under nccl, nothing was staged through the host).
"""

from __future__ import annotations

import argparse

import numpy as np

DEFAULT_JSON = "BENCH_torch_ssm_context_parallel.json"

ALGS = ("auto", "123", "1doubling", "two_op")
P = 8
B, S, D = 1, 4096, 1024
REPS = 10


def inputs(seed: int = 0, shape=(B, S, D)):
    """The decays a ~ U(0.9, 1) and inputs b ~ N(0, 1), fp32, (B, S, D)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.9, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return a, b


def split(x, p: int):
    """(B, S, ...) -> (p, B, S/p, ...), as ``cp_ssm_scan`` takes it."""
    bsz, seq = x.shape[:2]
    return x.reshape(bsz, p, seq // p, *x.shape[2:]).transpose(0, 1) \
        .contiguous()


def join(h):
    """The inverse of :func:`split`."""
    p, bsz, chunk = h.shape[:3]
    return h.transpose(0, 1).reshape(bsz, p * chunk, *h.shape[3:])


def prefill(alg: str, a: np.ndarray, b: np.ndarray, device, *,
            reps: int = REPS):
    """One algorithm's cell: ``(µs, h)``, the minimum of ``reps``
    synchronised ``cp_ssm_scan`` calls and the first call's h, (B, S,
    ...) on the device."""
    import torch

    from repro_torch.benchmarks.common import timed
    from repro_torch.core.scan_api import ScanSpec
    from repro_torch.models.context_parallel import cp_ssm_scan

    dev = torch.device(device)
    at = split(torch.from_numpy(a).to(dev), P)
    bt = split(torch.from_numpy(b).to(dev), P)
    spec = ScanSpec(kind="exclusive", monoid="affine", algorithm=alg)
    h, ts = timed(lambda: cp_ssm_scan(at, bt, spec=spec), dev, reps)
    return min(ts) * 1e6, join(h)


def run(csv_rows: list, device=None, *, outputs: dict | None = None) -> list:
    """Append one row an algorithm, on :func:`inputs` of seed 0;
    ``device`` None is the card (raises when there is none).
    ``outputs``, when given, receives each row's first h (B, S, D)
    under the row's name."""
    from repro_torch import device as device_lib
    from repro_torch.benchmarks.common import wallclock_unit

    device = device_lib.resolve(device)
    a, b = inputs()
    for alg in ALGS:
        us, h = prefill(alg, a, b, device)
        name = f"cp_ssm_prefill_p{P}/{alg}"
        csv_rows.append((name, us, wallclock_unit(device)))
        if outputs is not None:
            outputs[name] = h
    return csv_rows


def run_pool(nprocs: int, p_intra: int, backend: str, device=None, *,
             reps: int = REPS, timeout: float = 300.0,
             shape=(B, S, D)) -> list:
    """One row an algorithm from a pool of ``nprocs`` processes of
    ``p_intra`` ranks (p = 8) on :func:`inputs` of seed 0: a dict with
    the pool's µs (the minimum of ``reps`` calls after one untimed), the
    stacked run's µs on the pool's first device, whether h equals the
    stacked h bit for bit, and the call's messages and staging copies."""
    from repro_torch.core.scan_api import ScanSpec
    from repro_torch.dist import WorkerPool

    if nprocs * p_intra != P:
        raise ValueError(f"{nprocs} processes of {p_intra} ranks are not "
                         f"the bench's p = {P}")
    import torch

    a, b = inputs(0, shape)
    shards = tuple(split(torch.from_numpy(x), P).numpy() for x in (a, b))
    rows = []
    with WorkerPool(nprocs, p_intra=p_intra, backend=backend,
                    device=device, timeout=timeout) as pool:
        for alg in ALGS:
            spec = ScanSpec(kind="exclusive", monoid="affine", algorithm=alg)
            res = pool.call("cp_ssm_scan", shards, spec=spec,
                            repeats=1 + reps)
            us, h = prefill(alg, a, b, pool.device, reps=reps)
            rows.append({
                "name": f"cp_ssm_prefill_p{P}/{alg}/procs{nprocs}x"
                        f"{p_intra}/{backend}",
                "us": min(res.seconds[1:]) * 1e6, "stacked_us": us,
                "identical": bool(np.array_equal(
                    join(torch.from_numpy(res.outputs)).numpy(),
                    h.cpu().numpy())),
                "rounds": res.stats["rounds"],
                "messages": res.transport["msgs"],
                "staged_copies": res.transport["staged_copies"],
                "backend": backend, "device": str(pool.device),
                "cards": pool.cards})
    return rows


def pool_ok(row: dict) -> bool:
    """A pool row's gate: h bit for bit the stacked run's, and no copy
    staged through the host under nccl."""
    return row["identical"] and (row["backend"] != "nccl"
                                 or row["staged_copies"] == 0)


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    common.add_json_arg(ap, DEFAULT_JSON)
    common.add_pool_args(ap)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    rows = run([], device=dev)
    pool_rows = [] if not args.nprocs else run_pool(
        args.nprocs, args.p_intra, args.backend,
        dev if args.backend == "gloo" else None)
    common.print_csv(rows + [(r["name"], r["us"],
                              common.wallclock_unit(dev))
                             for r in pool_rows])
    if args.json:
        common.write_rows(args.json, "torch_ssm_context_parallel", rows,
                          dev, pool_rows=pool_rows)
    bad = [r["name"] for r in pool_rows if not pool_ok(r)]
    if args.check and bad:
        print(f"POOL DRIFT in {bad}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
