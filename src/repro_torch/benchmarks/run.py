"""Benchmark harness: one module per paper table or figure, as one
``name,value,derived`` CSV.

Modules (the JAX package's ``benchmarks/run.py`` list):
  * round_counts          — Theorem 1 rounds/⊕ table (exact)
  * plan_table            — ScanSpec("auto") planner decisions per
                            (p, payload), under the active profile
  * exscan_table1         — paper Table 1 / Fig 1 analogue (measured on
                            p = 8 stacked ranks, α-β-γ modeled at scale)
  * moe_dispatch          — the MoE model's forward, algorithm sweep
  * ssm_context_parallel  — the context-parallel SSM prefill, algorithm
                            sweep

Each runs on ``--device`` (the card by default; ``cpu`` for the host).
The JAX package's harness also adds roofline rows read from the JSON
that ``launch/dryrun.py`` writes; the port has no dry-run yet, so the
harness has no roofline rows.  A module that fails is reported with
its traceback and the harness exits 1 after printing the others' rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]
        [--json [PATH]]
"""

from __future__ import annotations

import argparse
import sys
import traceback

DEFAULT_JSON = "BENCH_torch_run.json"


def modules() -> list:
    """``(name, fn(csv_rows, device))`` in the harness's order."""
    from repro_torch.benchmarks import exscan_table1, moe_dispatch, \
        plan_table, round_counts, ssm_context_parallel

    return [
        ("round_counts", round_counts.run),
        ("plan_table", plan_table.run),
        ("exscan_table1", exscan_table1.run),
        ("moe_dispatch", moe_dispatch.run),
        ("ssm_context_parallel", ssm_context_parallel.run),
    ]


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    common.add_json_arg(ap, DEFAULT_JSON)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    rows: list = []
    failed = []
    for name, fn in modules():
        try:
            fn(rows, device=dev)
        except Exception:  # noqa: BLE001 - report, run the rest, exit 1
            failed.append(name)
            print(f"# BENCH FAILED: {name}", file=sys.stderr)
            traceback.print_exc()
    print("name,value,derived")
    common.print_csv(rows)
    if args.json:
        common.write_rows(args.json, "torch_run", rows, dev, failed=failed)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
