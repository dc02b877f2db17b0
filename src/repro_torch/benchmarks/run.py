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
  * roofline              — from the port's latest dry-run JSON
                            (``dryrun_results_torch.json``), if present

Each runs on ``--device`` (the card by default; ``cpu`` for the host).
The roofline rows are the dry run's H100 bounds, read from the file; the
JAX package's ``dryrun_results.json`` (TPU constants) is never read.  A
module that fails is reported with its traceback and the harness exits
1 after printing the others' rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]
        [--json [PATH]]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

DEFAULT_JSON = "BENCH_torch_run.json"
DRYRUN_JSON = "dryrun_results_torch.json"


def roofline_rows(csv_rows: list, device=None, path: str | None = None):
    """The single-pod cells of the port's dry-run JSON (``path``, else
    :data:`DRYRUN_JSON`) as rows: each cell's bound (ms, the dominant
    term's name) and MFU bound.  Nothing when the file is absent;
    ``device`` is unused (the rows are read, not measured)."""
    path = DRYRUN_JSON if path is None else path
    if not os.path.exists(path):
        return csv_rows
    with open(path) as f:
        cells = json.load(f)
    for c in cells:
        if c.get("status") != "ok":
            continue
        if c.get("mesh") != "16x16":
            continue  # multi-pod pass is trace-proof only (no probes)
        key = f"roofline/{c['arch']}/{c['shape']}/{c['mesh']}"
        csv_rows.append((key + "/bound_ms",
                         1e3 * max(c["compute_s"], c["memory_s"],
                                   c["collective_s"]),
                         c["dominant"]))
        csv_rows.append((key + "/mfu_bound", c["mfu_bound"], "fraction"))
    return csv_rows


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
        ("roofline", roofline_rows),
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
