"""Production-mesh dry run on one NVIDIA H100's roofline: trace every
(arch × shape × mesh) cell on meta tensors, from the JAX package's
``launch/dryrun.py``.

Each cell's step runs once on ``torch.device("meta")`` with the model
at ranks = the production mesh (16 × 16, or 2 × 16 × 16 with
``--multi-pod``): the stacked program of all ranks, no data and no
card.  Per device its FLOPs, bytes and temp memory are the trace's
totals over the rank count (``"per_device": "even split"``), its
argument bytes exact from the shardings, and its collectives priced
from the shardings and the trace (``launch/roofline.py``); the terms
are the card's (``roofline.hardware()``), and ``fits_hbm`` says whether
the per-device peak fits the card's 80 GB.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --both-meshes --json out.json

``--json`` without a path writes ``dryrun_results_torch.json``, so the JAX
package's ``dryrun_results.json`` (TPU constants) is never read as the
card's.  A cell that raises is recorded as ``FAILED`` and the exit code
is 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback

from repro_torch import configs
from repro_torch.core import scan_api
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.scan_api import ScanSpec
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh

DEFAULT_JSON = "dryrun_results_torch.json"


def _grid(mesh) -> tuple:
    return tuple(zip(mesh.axis_names, mesh.sizes))


def _verify_scan_plans(cfg, mesh) -> list:
    """Resolve the cell's scan spec per mesh axis and execute each
    plan's schedule with the stacked executor on the CPU against the
    host reference, so plan/measurement drift fails the cell before
    the trace does.

    Covers the payload regimes and monoid families the cell's call
    sites re-target the spec to: the MoE-dispatch-sized small "add"
    payload, a 1 MiB context-carry-sized one under both "add" and the
    non-commutative "affine" carry monoid, and the non-segmentable
    "matmul" path — plus the composed forms: the multi-axis scan over
    every mesh axis, its fused exscan+allreduce ("scan_total"), and a
    fused k-scan bundle (compression offsets).
    """
    checks = []
    small = 4 * max(cfg.n_experts, 16)  # int32 expert counts
    cases = (("add", small), ("add", 1 << 20), ("affine", 1 << 20),
             ("matmul", small))
    with scan_api.use_cost_model(mesh_lib.axis_cost_model):
        for axis in mesh.axis_names:
            for mono, nbytes in cases:
                pl = scan_api.plan(
                    cfg.scan_spec.over(axis, monoid=mono),
                    p=mesh.shape[axis], nbytes=nbytes)
                res = schedule_lib.verify_plan(pl)
                checks.append({"axis": axis, "monoid": mono,
                               "nbytes": nbytes, **res})
                if not res["ok"]:
                    raise RuntimeError(
                        f"scan plan/schedule drift on axis {axis!r} "
                        f"({mono}): {res}")
        maxes = tuple(mesh.axis_names)
        msizes = tuple(int(mesh.shape[a]) for a in maxes)
        for kind in ("exclusive", "scan_total"):
            pl = scan_api.plan(
                cfg.scan_spec.over(maxes, kind=kind, monoid="add",
                                   algorithm="auto", segments=None),
                p=msizes, nbytes=small)
            res = schedule_lib.verify_plan(pl)
            checks.append({"axis": maxes, "monoid": "add", "kind": kind,
                           "nbytes": small, **res})
            if not res["ok"]:
                raise RuntimeError(
                    f"composed {kind} plan/schedule drift over "
                    f"{maxes}: {res}")
        axis = mesh.axis_names[-1]
        fp = scan_api.plan_fused(
            [cfg.scan_spec.over(axis, kind="exclusive", monoid="add",
                                algorithm="auto", segments=None)] * 4,
            int(mesh.shape[axis]), [16] * 4)
        res = fp.verify()
        checks.append({"axis": axis, "monoid": "add", "kind": "fused",
                       "nbytes": 16, "algorithm": "fused[4]",
                       "segments": 1, **res})
        if not res["ok"]:
            raise RuntimeError(
                f"fused scan plan/schedule drift on axis {axis!r}: "
                f"{res}")
    return checks


def _probe(cfg, shape, mesh, repeats: int):
    """Trace a reduced-depth twin of the cell (``repeats`` pattern
    units) and return (flops, bytes, CollectiveStats) per device.  The
    full cell's cost is reconstructed from two probes as the reference
    does:  cost(R) = probe(1) + (R - 1) * (probe(2) - probe(1)),  exact
    for a uniform stack (embed and head live in probe(1))."""
    unit = len(cfg.pattern())
    cfg_p = dataclasses.replace(cfg, n_layers=unit * repeats,
                                unroll_stack=True)
    with scan_api.use_cost_model(mesh_lib.axis_cost_model):
        compiled = steps_lib.lower_cell(cfg_p, shape, mesh).compile()
    cost = compiled.cost_analysis()
    return (float(cost["flops"]), float(cost["bytes accessed"]),
            compiled.collectives())


def _extrapolate(p1, p2, repeats: int):
    f1, b1, c1 = p1
    f2, b2, c2 = p2
    r = repeats - 1
    flops = f1 + r * (f2 - f1)
    bytes_ = b1 + r * (b2 - b1)
    ops = sorted(set(c1.op_counts) | set(c2.op_counts))
    counts = {o: c1.op_counts.get(o, 0)
              + r * (c2.op_counts.get(o, 0) - c1.op_counts.get(o, 0))
              for o in ops}
    byts = {o: c1.op_bytes.get(o, 0.0)
            + r * (c2.op_bytes.get(o, 0.0) - c1.op_bytes.get(o, 0.0))
            for o in ops}
    return flops, bytes_, rl.CollectiveStats(counts, byts)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, strategy: str = "tp",
             probes: bool = True, profile_dir: str | None = None,
             **cfg_overrides) -> dict:
    cfg = configs.get(arch, sharding_strategy=strategy, **cfg_overrides)
    shape = steps_lib.SHAPES[shape_name]
    ok, reason = steps_lib.applicable(cfg, shape)
    cell = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "strategy": strategy,
    }
    if not ok:
        cell["status"] = "skipped"
        cell["reason"] = reason
        if verbose:
            print(f"[SKIP] {arch} x {shape_name}: {reason}")
        return cell

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    # the profile stored for this grid on the host (defaults when none
    # is), and its provenance
    profile = mesh_lib.use_calibrated_profile(_grid(mesh), profile_dir,
                                              device="cpu")
    cell["cost_profile"] = profile.provenance(
        mesh_lib.mesh_fingerprint(_grid(mesh), device="cpu"))
    if verbose:
        print(f"  cost profile: {profile.source} "
              f"fingerprint={profile.fingerprint()}")
    cell["scan_plan_checks"] = _verify_scan_plans(cfg, mesh)
    t0 = time.time()
    with scan_api.use_cost_model(mesh_lib.axis_cost_model):
        lowered = steps_lib.lower_cell(cfg, shape, mesh)
    t_lower = time.time() - t0
    t0 = time.time()
    with scan_api.use_cost_model(mesh_lib.axis_cost_model):
        compiled = lowered.compile()
    t_compile = time.time() - t0
    mem = compiled.memory_analysis()

    # cost probes (see _probe); --no-probes reads the whole trace
    t0 = time.time()
    if probes:
        p1 = _probe(cfg, shape, mesh, 1)
        p2 = _probe(cfg, shape, mesh, 2)
        flops, bytes_hbm, coll = _extrapolate(p1, p2, cfg.n_repeats)
    else:
        cost = compiled.cost_analysis()
        flops = float(cost["flops"])
        bytes_hbm = float(cost["bytes accessed"])
        coll = compiled.collectives()
    t_probe = time.time() - t0

    training = shape.kind == "train"
    tokens = shape.batch * (shape.seq if shape.kind != "decode" else 1)
    model_flops = cfg.model_flops_per_token(shape.seq, training) * tokens
    roof = rl.analyze(flops, bytes_hbm, coll, model_flops=model_flops,
                      n_devices=n_dev)

    cell.update(
        status="ok",
        hardware=rl.hardware(),
        per_device="even split",
        lower_s=round(t_lower, 1),
        compile_s=round(t_compile, 1),
        probe_s=round(t_probe, 1),
        flops_per_device=roof.flops,
        bytes_per_device=roof.bytes_hbm,
        collective_bytes=roof.collective.total_bytes,
        collective_ops=roof.collective.op_counts,
        collective_op_bytes=roof.collective.op_bytes,
        compute_s=roof.compute_s,
        memory_s=roof.memory_s,
        collective_s=roof.collective_s,
        dominant=roof.dominant,
        model_flops=model_flops,
        useful_flops_fraction=roof.useful_flops_fraction,
        mfu_bound=roof.mfu_bound,
        kernel_launches=compiled.kernel_launches,
        memory_analysis=mem,
        fits_hbm=mem["peak_bytes"] <= rl.HBM_BYTES,
    )
    if verbose:
        print(f"[OK] {arch} x {shape_name} @ {cell['mesh']} "
              f"(lower {t_lower:.1f}s, trace {t_compile:.1f}s, "
              f"probes {t_probe:.1f}s)")
        plans = {(str(c["axis"]), c["monoid"], c["nbytes"]):
                 f"{c['algorithm']}/S{c['segments']}"
                 for c in cell["scan_plan_checks"]}
        print(f"  scan plans verified (stacked executor, CPU): {plans}")
        print(f"  memory_analysis (per device): {mem} "
              f"fits {rl.HBM_BYTES:.0f} B: {cell['fits_hbm']}")
        print(f"  cost: {roof.flops:.3e} FLOP/dev, "
              f"{roof.bytes_hbm:.3e} B/dev, "
              f"{roof.collective.total_bytes:.3e} wire B "
              f"{dict(roof.collective.op_counts)}")
        print(f"  roofline ({rl.HARDWARE}): compute "
              f"{roof.compute_s*1e3:.2f} ms | memory "
              f"{roof.memory_s*1e3:.2f} ms | collective "
              f"{roof.collective_s*1e3:.2f} ms -> {roof.dominant}-bound; "
              f"useful/traced flops {roof.useful_flops_fraction:.2f}; "
              f"MFU bound {roof.mfu_bound:.2f}")
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(steps_lib.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, default=None,
                    metavar="PATH",
                    help=f"write the cells as JSON (default {DEFAULT_JSON})")
    ap.add_argument("--strategy", default="tp",
                    choices=["tp", "fsdp_sp", "decode_ws"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "dots"])
    ap.add_argument("--no-probes", action="store_true",
                    help="skip cost probes (whole-trace pass)")
    ap.add_argument("--exscan", default=None,
                    choices=["auto", "123", "1doubling", "two_op",
                             "native", "ring"])
    ap.add_argument("--profile-dir", default=None,
                    help="calibrated cost-profile store (default: "
                         "tune/profiles/torch or $REPRO_PROFILE_DIR)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        targets = [(a, s) for a in configs.ARCHITECTURES
                   for s in steps_lib.SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        targets = [(configs.canonical(args.arch), args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    overrides = (({"remat": False} if args.no_remat else {})
                 | ({"remat_policy": args.remat_policy}
                    if args.remat_policy != "nothing" else {})
                 | ({"scan": ScanSpec(kind="exclusive",
                                      algorithm=args.exscan)}
                    if args.exscan else {}))
    for multi_pod in meshes:
        for arch, shape in targets:
            try:
                cells.append(run_cell(
                    arch, shape, multi_pod, strategy=args.strategy,
                    probes=not args.no_probes,
                    profile_dir=args.profile_dir, **overrides))
            except Exception as e:  # noqa: BLE001 - record, run the rest
                failures += 1
                traceback.print_exc()
                cells.append({"arch": arch, "shape": shape,
                              "mesh": "2x16x16" if multi_pod else "16x16",
                              "strategy": args.strategy,
                              "status": "FAILED", "error": str(e)[:500]})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(cells, f, indent=1, default=str)
        print(f"wrote {args.json}")
    print(f"\n{sum(1 for c in cells if c['status'] == 'ok')} ok, "
          f"{sum(1 for c in cells if c['status'] == 'skipped')} skipped, "
          f"{failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
