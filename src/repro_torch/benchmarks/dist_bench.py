"""Multi-process hierarchical exscan bench: the correctness bridge
between the worker pool (``repro_torch.dist``) and the stacked executor.

Each config plans one two-level exscan over (proc, local), where the
per-tier cost models pick a DIFFERENT algorithm on the tier inside a
process ("ici") than on the tier across processes ("dci"), the paper's
motivating regime.  The composed schedule runs across a
:class:`~repro_torch.dist.WorkerPool` of ``nprocs`` processes holding
``p_intra`` ranks each, and is held against
:class:`~repro_torch.core.schedule.StackedExecutor` on the same device:

- every output bit for bit,
- rounds and ⊕ equal to the stacked run's and the plan's,
- measured per-round bytes equal to ``expected_round_bytes``,
- the two tiers chose different algorithms (else the config no longer
  exercises per-tier choice and must be repinned),
- messages crossed processes (cross bytes > 0, equal to
  ``expected_messages``' count for the block layout),
- each process launched the IR's round kernels (none on the CPU, where
  the plain versions run).

The plans are priced under a profile that copies the JAX package's
default tier constants as numbers (``REFERENCE_PROFILE``), so they equal
its plans step for step; ``--profile PATH`` takes a profile that
``python -m repro_torch.core.tune --dist N`` stored instead.

    PYTHONPATH=src python -m repro_torch.benchmarks.dist_bench [--device cpu]
        [--check] [--json PATH] [--profile PATH] [--backend nccl]

``--backend`` (repeatable; gloo by default) picks the pools' backends:
under ``gloo`` every process runs on ``--device``, its messages staged
through the host on the card; under ``nccl`` process k runs on card k
(the configs need 3 cards), with no staging, which the gate then
requires; ``--backend gloo --backend nccl`` writes both rows of each
config side by side.  ``--check`` turns any drift into a non-zero exit;
the rows land in ``BENCH_torch_dist.json``, whose meta names the card
and its power limit when the pool ran on one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.benchmarks.common import card_power
from repro_torch.core.scan_api import CostModel, CostProfile

DEFAULT_JSON = "BENCH_torch_dist.json"

# (nprocs, p_intra, nbytes), the JAX package's configs: pinned where the
# reference tiers split.  Under REFERENCE_PROFILE config 1 runs the
# halving block exscan inside each process and a ring (S = 2) across
# the 3 processes; config 2 halving inside and 123 across (dci's 10x
# alpha makes extra crossing rounds dear).
CONFIGS = (
    {"nprocs": 3, "p_intra": 4, "nbytes": 262_144},
    {"nprocs": 2, "p_intra": 4, "nbytes": 1_048_576},
)

# The JAX package's hand-guessed tier constants (its launch/mesh.py),
# written here as numbers: ici inside a process, dci across processes.
REFERENCE_PROFILE = CostProfile(
    tiers=(("dci", CostModel(alpha=10e-6, beta=1.0 / 12.5e9,
                             gamma=2.0 / 819e9)),
           ("ici", CostModel(alpha=1e-6, beta=1.0 / 50e9,
                             gamma=2.0 / 819e9))),
    source="default", axis_tiers=(("pod", "dci"),), default_tier="ici")

ROUND_KERNELS = ("combine", "exchange", "scan_reduce")


def _payload(p: int, nbytes: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 30,
                        size=(p, max(1, nbytes // 8))).astype(np.int64)


def run_config(cfg: dict, *, device=None,
               profile: CostProfile = REFERENCE_PROFILE, seed: int = 0,
               timeout: float = 120.0, backend: str = "gloo") -> dict:
    """One config through a pool over ``backend`` (gloo, which several
    processes on one card need, on ``device``; nccl, one process a
    card) and the stacked executor: its row."""
    import torch

    from repro_torch import device as device_lib
    from repro_torch.core import monoid as monoid_lib
    from repro_torch.core import schedule as sch
    from repro_torch.core import tune
    from repro_torch.core.scan_api import ScanSpec, plan_hierarchical
    from repro_torch.dist import WorkerPool, run_plan

    spec = ScanSpec(kind="exclusive", monoid="add")
    nprocs, P = cfg["nprocs"], cfg["p_intra"]
    pl = plan_hierarchical(spec, p_inter=nprocs, p_intra=P,
                           nbytes=cfg["nbytes"], cost_model=profile)
    inner, outer = pl.sub_plans[0], pl.sub_plans[-1]
    sched = pl.schedule()
    x = _payload(pl.p, cfg["nbytes"], seed)
    m = monoid_lib.get("add")
    with WorkerPool(nprocs, backend=backend,
                    device=device if backend == "gloo" else None,
                    timeout=timeout, p_intra=P) as pool:
        res = run_plan(pool, pl, x)
        # the raw "dci" latency evidence: one-way hop times at a small
        # and the config's payload size
        hops = tune.measure_hops(pool, sizes=(8, cfg["nbytes"]), repeats=5)
        dev = pool.device
    with sch.collect_stats() as st:
        want = device_lib.to_numpy(sch.StackedExecutor(dev).execute(
            sched, x, m))
    one = torch.from_numpy(x[0])
    bytes_expected = sch.expected_round_bytes(sched, one)
    msgs_expected, cross_expected = sch.expected_messages(
        sched, one, ranks_per_proc=P)
    ir = sched.kernel_launches(m.commutative, fused=True)
    launches = [sum(n for k in ROUND_KERNELS
                    for n in ln.get(k, {}).values()) for ln in res.launches]
    row = {
        "nprocs": nprocs, "p_intra": P, "p": pl.p,
        "nbytes": cfg["nbytes"], "device": str(dev), "backend": backend,
        "cards": pool.cards,
        "intra_algorithm": inner.algorithm,
        "intra_segments": inner.segments,
        "inter_algorithm": outer.algorithm,
        "inter_segments": outer.segments,
        "rounds_plan": pl.rounds, "rounds_dist": res.stats["rounds"],
        "rounds_stacked": st.rounds,
        "ops_plan": pl.op_applications,
        "ops_dist": res.stats["op_applications"],
        "ops_stacked": st.op_applications,
        "bytes_dist": sum(res.stats["bytes_per_round"]),
        "bytes_expected": bytes_expected,
        "cross_msgs": res.transport["msgs"],
        "cross_bytes": res.transport["bytes"],
        "cross_msgs_expected": msgs_expected,
        "cross_bytes_expected": cross_expected,
        "staged_copies": res.transport["staged_copies"],
        "kernel_launches_ir": ir,
        "kernel_launches_recorded": [s["kernel_launches"]
                                     for s in res.rank_stats],
        "round_kernel_launches": launches,
        "seconds": res.seconds[0],
        "rank_seconds": res.rank_seconds[0],
        "hop_timings": hops,
        "bit_identical": bool(np.array_equal(res.outputs, want)),
    }
    on_card = dev.type == "cuda"
    row["tiers_diverge"] = inner.algorithm != outer.algorithm
    row["launches_ok"] = (
        row["kernel_launches_recorded"] == [ir] * nprocs
        and launches == [ir if on_card else 0] * nprocs)
    row["ok"] = bool(
        row["bit_identical"]
        and row["rounds_dist"] == row["rounds_stacked"] == pl.rounds
        and row["ops_dist"] == row["ops_stacked"] == pl.op_applications
        and row["bytes_dist"] == bytes_expected
        and row["tiers_diverge"]
        and row["cross_bytes"] > 0
        and (row["cross_msgs"], row["cross_bytes"]) == (msgs_expected,
                                                        cross_expected)
        and row["launches_ok"]
        and (backend != "nccl" or row["staged_copies"] == 0))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the pools' device: the card by default, 'cpu' "
                         "for the host")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on any drift")
    ap.add_argument("--json", default=DEFAULT_JSON, metavar="PATH")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="plan under this stored profile instead of the "
                         "reference's tier constants")
    ap.add_argument("--backend", action="append", choices=("gloo", "nccl"),
                    help="the pools' backend, repeatable (default gloo; "
                         "nccl: one process a card)")
    args = ap.parse_args(argv)

    from repro_torch.core import tune
    from repro_torch.core.benchmeta import bench_metadata

    profile = REFERENCE_PROFILE if args.profile is None else \
        tune.load_profile_file(args.profile)
    rows = [run_config(cfg, device=args.device, profile=profile,
                       backend=backend)
            for cfg in CONFIGS for backend in args.backend or ["gloo"]]
    for r in rows:
        print(f"{r['backend']} p={r['p']} ({r['nprocs']}x{r['p_intra']}) "
              f"m={r['nbytes']}: intra={r['intra_algorithm']} "
              f"S={r['intra_segments']} / inter={r['inter_algorithm']} "
              f"S={r['inter_segments']} rounds={r['rounds_dist']} "
              f"(plan {r['rounds_plan']}) cross_msgs={r['cross_msgs']} "
              f"cross_bytes={r['cross_bytes']} "
              f"launches={r['round_kernel_launches']} "
              f"(IR {r['kernel_launches_ir']}) "
              f"staged={r['staged_copies']} seconds={r['seconds']:.4f} "
              f"identical={r['bit_identical']} ok={r['ok']}")
    if args.json:
        meta = bench_metadata()
        if any(r["device"].startswith("cuda") for r in rows):
            meta["card"] = card_power()
        meta["profile"] = profile.mesh_fingerprint or profile.source
        with open(args.json, "w") as f:
            json.dump({"meta": meta, "schema_version": 2,
                       "benchmark": "torch_dist", "rows": rows}, f,
                      indent=1, sort_keys=True)
        print(f"wrote {args.json}")
    bad = [r for r in rows if not r["ok"]]
    if args.check and bad:
        print(f"DIST DRIFT in {len(bad)} config(s): {bad}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
