"""Context-parallel SSM prefill: the paper's headline scenario.

A 32k-token sequence is split over 8 ranks stacked on ``--device`` (the
card by default); each rank scans its chunk locally and the carry-in
states across ranks come from an exclusive prefix scan under the
(expensive, non-commutative) AFFINE state-composition operator.
123-doubling does this in q = ⌈log₂(p−1) + log₂ 4/3⌉ rounds with q−1
compositions.  The reference result is one sequential scan of the
whole sequence (``models.mamba.ssm_scan_chunked``).

    PYTHONPATH=src python -m repro_torch.examples.context_parallel_ssm
        [--device cpu]
"""

from __future__ import annotations

import argparse

P = 8
B, S, D = 1, 32768, 512
ALGS = ("auto", "123", "1doubling", "two_op")


def run(device, *, shape=(B, S, D), reps: int = 3,
        verbose: bool = True) -> dict:
    """``{alg: {"rounds", "ops", "max_err", "wall_s", "h"}}``: each
    algorithm's carry counts, its largest error against the sequential
    scan, the minimum of ``reps`` synchronised calls after one untimed
    one, and h (B, S, D) on the device."""
    import torch

    from repro_torch.benchmarks.common import timed
    from repro_torch.benchmarks.ssm_context_parallel import inputs, join, \
        split
    from repro_torch.core import collectives
    from repro_torch.core.scan_api import ScanSpec
    from repro_torch.models.context_parallel import cp_ssm_scan
    from repro_torch.models.mamba import ssm_scan_chunked

    say = print if verbose else (lambda *a, **k: None)
    dev = torch.device(device)
    a, b = (torch.from_numpy(v).to(dev) for v in inputs(0, shape))
    ref, _ = ssm_scan_chunked(a, b, torch.zeros((shape[0],) + shape[2:],
                                                device=dev))
    at, bt = split(a, P), split(b, P)
    res = {}
    for alg in ALGS:
        spec = ScanSpec(kind="exclusive", monoid="affine", algorithm=alg)
        with collectives.collect_stats() as stats:
            h = join(cp_ssm_scan(at, bt, spec=spec))
        _, ts = timed(lambda: cp_ssm_scan(at, bt, spec=spec), dev, reps)
        err = float(torch.max(torch.abs(h - ref)))
        res[alg] = {"rounds": stats.rounds, "ops": stats.op_applications,
                    "max_err": err, "wall_s": min(ts), "h": h}
        say(f"{alg:>10s}: {stats.rounds} carry rounds, "
            f"{stats.op_applications} ⊕ compositions/rank, "
            f"max err {err:.1e}, wall {min(ts)*1e3:.1f} ms")
    say(f"\n(sequence length {shape[1]} split {P} ways; the carry-in "
        f"state of each rank reconstructed exactly — errors are fp32 "
        f"noise)")
    return res


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    run(device_lib.resolve(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
