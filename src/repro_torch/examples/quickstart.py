"""Quickstart: the paper's exclusive scan behind the planner API.

Builds a ScanSpec, lets the planner pick the algorithm for the payload
("auto": the cost model weighs rounds against bytes against ⊕ cost),
inspects the resulting ScanPlan before running anything, then runs
every registered exclusive algorithm over p = 8 ranks stacked on
``--device`` (the card by default) and checks each output against
numpy and its measured rounds against the plan's; then the deprecated
``collectives.exscan``, and Theorem 1's counts at scale.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import warnings

import numpy as np

P = 8


def payload(p: int = P) -> np.ndarray:
    """The ranks' inputs V_r: int32 (p, 4) from ``default_rng(0)``."""
    return np.random.default_rng(0).integers(0, 100, size=(p, 4)) \
        .astype(np.int32)


def run(device, *, verbose: bool = True) -> dict:
    """Every exclusive algorithm and auto, then the legacy wrapper, on
    the payload: ``{alg: {"out", "rounds", "ops", "allgathers",
    "planned"}}`` plus ``"legacy"`` (its output).  Raises when an output
    differs from numpy or a count from the plan."""
    import torch

    from repro_torch.core import collectives, oracle
    from repro_torch.core.scan_api import ScanSpec, algorithms, plan, scan
    from repro_torch.core.schedule import StackedExecutor

    say = print if verbose else (lambda *a, **k: None)
    ex = StackedExecutor(device)
    x = payload()
    p = len(x)
    xt = torch.from_numpy(x).to(ex.device)
    say(f"inputs V_r (p={p} ranks, m=4):\n{x}\n")
    expected = np.zeros_like(x)
    expected[1:] = np.cumsum(x[:-1], axis=0)

    # the planner API: describe WHAT, let the cost model pick HOW
    spec = ScanSpec(kind="exclusive", monoid="add", algorithm="auto",
                    axis_name="ranks")
    pl = plan(spec, p=p, nbytes=x[0].nbytes)
    say("auto plan for this payload:")
    say(" ", pl.describe())
    # plans are schedules: round-by-round peers, masks and combine
    # directions, inspected without running anything
    say("\nits schedule IR (what the executor runs):")
    say("  " + pl.schedule().describe().replace("\n", "\n  "))
    big = plan(spec, p=p, nbytes=1 << 20)
    say(f"\na 1 MiB payload plans {big.algorithm} (S={big.segments}, "
        f"{big.rounds} rounds, "
        f"{big.bytes_on_wire / (1 << 20):.2f}·m on the wire):")
    say("  " + "\n  ".join(big.schedule().describe().split("\n")[:4])
        + "\n    ...\n")

    res = {}
    for alg in algorithms("exclusive") + ("auto",):
        aspec = spec.over("ranks", algorithm=alg)
        with collectives.collect_stats() as stats:
            out = scan(xt, aspec, executor=ex).cpu().numpy()
        if not np.array_equal(out, expected):
            raise RuntimeError(f"{alg}: output differs from numpy's")
        apl = plan(aspec, p=p, nbytes=x[0].nbytes)
        if stats.rounds != apl.rounds:  # plans predict measurements
            raise RuntimeError(f"{alg}: {stats.rounds} rounds, planned "
                               f"{apl.rounds}")
        res[alg] = {"out": out, "rounds": stats.rounds,
                    "ops": stats.op_applications,
                    "allgathers": stats.allgathers,
                    "planned": apl.algorithm}
        say(f"{alg:>10s}: rounds={stats.rounds} "
            f"⊕/device={stats.op_applications} "
            f"(all-gathers={stats.allgathers})"
            f"{'  <- planned: ' + apl.algorithm if alg == 'auto' else ''}"
            f"  ✓ correct")

    # the legacy string API still works, but is deprecated
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = collectives.exscan(xt, "ranks", "add", "123",
                                    executor=ex).cpu().numpy()
    if not np.array_equal(legacy, expected):
        raise RuntimeError("legacy collectives.exscan differs from numpy's")
    if not any(issubclass(w.category, DeprecationWarning) for w in caught):
        raise RuntimeError("collectives.exscan gave no DeprecationWarning")
    res["legacy"] = legacy
    say("\nlegacy collectives.exscan(...) ✓ still works "
        "(with a DeprecationWarning pointing at ScanSpec)")

    say("\nTheorem 1 at the paper's p=36 and at scale:")
    for p_ in (36, 256, 512):
        q = oracle.q_123(p_)
        say(f"  p={p_:4d}: 123-doubling {q} rounds / {q-1} ⊕ | "
            f"1-doubling {oracle.rounds_1doubling(p_)} rounds | "
            f"two-⊕ {oracle.rounds_two_op(p_)} rounds "
            f"/ ~{2*oracle.rounds_two_op(p_)-1} ⊕")
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
