"""Render the roofline markdown table from the port's dry-run JSON, from
the JAX package's ``benchmarks/roofline_table.py``.

The cells are ``launch/dryrun.py``'s (``dryrun_results_torch.json`` by
default), priced under one NVIDIA H100's constants
(``launch/roofline.py``); the table adds whether each cell's per-device
peak fits the card's HBM.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_table \\
        [dryrun_results_torch.json ...]
"""

from __future__ import annotations

import json
import os
import sys

DEFAULT_PATHS = ("dryrun_results_torch.json",)


def load(paths):
    cells = []
    for p in paths:
        if os.path.exists(p):
            with open(p) as f:
                cells.extend(json.load(f))
    return cells


def fmt(cells):
    rows = []
    rows.append(
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "dominant | useful/HLO | MFU bound |")
    rows.append("|---|---|---|---|---|---|---|---|---|")
    for c in cells:
        if c.get("status") == "skipped":
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | — | — | — | "
                f"skip: {c['reason'][:40]}… | — | — |")
            continue
        if c.get("status") != "ok":
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | — | — | — | "
                f"**FAILED** | — | — |")
            continue
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {c['compute_s']:.3f} | {c['memory_s']:.3f} "
            f"| {c['collective_s']:.3f} | {c['dominant']} "
            f"| {c.get('useful_flops_fraction', 0):.2f} "
            f"| {c.get('mfu_bound', 0):.3f} |")
    return "\n".join(rows)


def fmt_fit(cells):
    """The per-device memory of each ok cell against the card's HBM."""
    rows = ["| arch | shape | mesh | argument GB | peak GB | fits 80 GB |",
            "|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("status") != "ok":
            continue
        mem = c["memory_analysis"]
        rows.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} "
                    f"| {mem['argument_bytes'] / 1e9:.2f} "
                    f"| {mem['peak_bytes'] / 1e9:.2f} "
                    f"| {'yes' if c['fits_hbm'] else 'no'} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    paths = (sys.argv[1:] if argv is None else argv) or DEFAULT_PATHS
    cells = load(paths)
    print(fmt(cells))
    print()
    print(fmt_fit(cells))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
