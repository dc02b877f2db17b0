"""Theorem 1 table: rounds and ⊕ applications against p for the three
exclusive-scan algorithms (exact, from the message-schedule oracle),
the block family's closed forms against the IR and the executed
schedule, the pipelined segmented ring's p−2+S rounds executed against
the plan's prediction, the fused-scan round law (k concurrent small
scans packed into one payload ride the SINGLE-scan round count, not
k×), and the commutativity-elision ⊕ law (butterfly exchange rounds
cost one ⊕ instead of two and fused scan_total rounds two instead of
three for commutative monoids, consistently across the IR's
``op_count``, the plan's prediction and the executed count).

The rows are the JAX package's ``benchmarks/round_counts.py`` row for
row.  Every executed check runs the plan's schedule through
:class:`~repro_torch.core.schedule.StackedExecutor` on ``--device``
(the card by default; ``cpu`` for the host) against a sequential
reference (``schedule.verify_plan``).

    PYTHONPATH=src python -m repro_torch.benchmarks.round_counts
        [--device cpu] [--check] [--json [PATH]]

``--check`` turns any drift into a non-zero exit.
"""

from __future__ import annotations

import argparse

from repro_torch.core import oracle
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.scan_api import ScanSpec, plan, plan_fused

DEFAULT_JSON = "BENCH_torch_round_counts.json"

PS = (4, 8, 16, 32, 36, 64, 128, 256, 512, 1024)
RING_PS = (4, 8, 16, 36, 64)  # executed, keep p moderate
RING_SS = (1, 4, 16)
FUSED_PS = (8, 36, 64, 256)  # fused k-scan round-law rows
FUSED_K = 4
ELISION_PS = (4, 8, 16, 32)  # commutative ⊕-elision rows (pow-2 p)


def run(csv_rows: list, check: bool = False, device=None) -> list:
    """Append the table's ``(name, value, derived)`` rows, each executed
    check on ``device`` (None is the card; raises when there is none);
    with ``check``, raise ``SystemExit`` on any drift."""
    from repro_torch import device as device_lib

    device = device_lib.resolve(device)
    for p in PS:
        for alg in ("two_op", "1doubling", "123"):
            st = oracle.verify(p, alg)
            csv_rows.append((f"rounds/{alg}/p{p}", st.rounds, "rounds"))
            csv_rows.append((f"ops/{alg}/p{p}", st.result_path_ops,
                             "oplus_result_path"))
    drift = []
    # block-distributed mid-m builders: closed-form rounds against the
    # IR against the executed schedule (they split rows, so they verify
    # through verify_plan, the closed form drift-checked explicitly)
    closed = {"halving": oracle.rounds_halving,
              "quartering": oracle.rounds_quartering,
              "reduce_scatter": oracle.rounds_reduce_scatter}
    for p in PS:
        for alg, form in closed.items():
            pl = plan(ScanSpec(kind="exclusive", algorithm=alg),
                      p=p, nbytes=64)
            key = f"rounds/{alg}/p{p}"
            csv_rows.append((key, pl.rounds, "rounds_predicted"))
            csv_rows.append((key + "_closed", form(p), "closed_form"))
            if pl.rounds != form(p):
                drift.append((key, {"plan": pl.rounds,
                                    "closed_form": form(p)}))
            if p <= 64:  # executed for moderate p
                res = schedule_lib.verify_plan(pl, device=device)
                csv_rows.append((key + "_measured",
                                 res["rounds_measured"],
                                 "simulator_executor"))
                if not res["ok"]:
                    drift.append((key, res))
        # the reduce-scatter depth law: 2⌈log₂p⌉ rounds at powers of two
        if p & (p - 1) == 0:
            want = 2 * (p.bit_length() - 1)
            if oracle.rounds_reduce_scatter(p) != want:
                drift.append((f"rounds/reduce_scatter/p{p}",
                              {"closed_form":
                               oracle.rounds_reduce_scatter(p),
                               "2ceil_log2_p": want}))
    for p in RING_PS:
        for S in RING_SS:
            pl = plan(ScanSpec(kind="exclusive", algorithm="ring",
                               segments=S), p=p, nbytes=S * 64)
            res = schedule_lib.verify_plan(pl, device=device)
            key = f"rounds/ring_S{S}/p{p}"
            csv_rows.append((key, pl.rounds, "rounds_predicted"))
            csv_rows.append((key + "_measured", res["rounds_measured"],
                             "simulator_executor"))
            if not res["ok"]:
                drift.append((key, res))
    # fused round law: k small concurrent exscans packed into one
    # payload cost the single-scan round count (not k×)
    spec = ScanSpec(kind="exclusive", monoid="add", algorithm="auto")
    for p in FUSED_PS:
        single = plan(spec, p=p, nbytes=8 * FUSED_K)
        fp = plan_fused([spec] * FUSED_K, p, [8] * FUSED_K)
        key = f"rounds/fused_k{FUSED_K}/p{p}"
        csv_rows.append((key, fp.rounds, "rounds_fused"))
        csv_rows.append((key + "_single", single.rounds,
                         "rounds_single_scan"))
        if not fp.fused or fp.rounds != single.rounds:
            drift.append((key, {"fused": fp.fused,
                                "rounds": fp.rounds,
                                "single": single.rounds}))
        elif check:
            res = fp.verify(device=device)
            if not res["ok"]:
                drift.append((key, res))
    # commutativity-elided ⊕ counts: the IR's op_count, the plan's
    # prediction and the executed count agree (affine rows keep the
    # non-commutative counts as the baseline)
    for p in ELISION_PS:
        cells = (("butterfly", "allreduce", "add", "affine"),
                 ("fused_doubling", "scan_total", "add", "affine"))
        for alg, kind, comm_m, noncomm_m in cells:
            for mono in (comm_m, noncomm_m):
                pl = plan(ScanSpec(kind=kind, algorithm=alg,
                                   monoid=mono), p=p, nbytes=64)
                key = f"ops/{alg}/{mono}/p{p}"
                csv_rows.append((key, pl.op_applications,
                                 "oplus_predicted"))
                sched = pl.schedule()
                commutative = mono == comm_m
                if pl.op_applications != sched.op_count(commutative):
                    drift.append((key, {
                        "plan": pl.op_applications,
                        "ir": sched.op_count(commutative)}))
                res = schedule_lib.verify_plan(pl, device=device)
                csv_rows.append((key + "_measured",
                                 res["ops_measured"],
                                 "simulator_executor"))
                if not res["ok"]:
                    drift.append((key, res))
            comm = plan(ScanSpec(kind=kind, algorithm=alg,
                                 monoid=comm_m), p=p, nbytes=64)
            noncomm = plan(ScanSpec(kind=kind, algorithm=alg,
                                    monoid=noncomm_m), p=p, nbytes=64)
            if comm.op_applications >= noncomm.op_applications:
                drift.append((f"ops/{alg}/p{p}", {
                    "commutative": comm.op_applications,
                    "noncommutative": noncomm.op_applications,
                    "expected": "commutative strictly fewer"}))
    if check and drift:
        raise SystemExit(
            f"plan/measurement drift in {len(drift)} cells: {drift}")
    return csv_rows


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    ap.add_argument("--check", action="store_true",
                    help="fail on plan-vs-executed drift")
    common.add_json_arg(ap, DEFAULT_JSON)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    rows = run([], check=args.check, device=dev)
    common.print_csv(rows)
    if args.json:
        common.write_rows(args.json, "torch_round_counts", rows, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
