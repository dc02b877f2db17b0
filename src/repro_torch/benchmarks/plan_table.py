"""Planner decision table: which algorithm ``"auto"`` picks per (p, m).

For each rank count p and payload size m the rows give the chosen
algorithm, its segment count S (the pipelined ring splits the payload
into S blocks and streams them through p−2+S neighbour rounds), the
predicted rounds and ⊕ and the cost-model latency under each tier of
the active profile, plus the rounds *measured* by executing the chosen
plan's schedule with :class:`~repro_torch.core.schedule.StackedExecutor`
on ``--device`` (the card by default; ``cpu`` for the host) against a
sequential reference: plan-against-measurement drift is in the table
and fails ``--check``.  The table and its gates are the JAX package's
``benchmarks/plan_table.py`` row for row.

Pricing: by default the port's profile, one "stacked" tier
(``launch.mesh.DEFAULT_PROFILE``, the ``CostModel`` defaults measured on
the card).  ``--profile PATH`` loads a calibrated
:class:`~repro_torch.core.scan_api.CostProfile` (a ``profile_*.json``
file, or a store directory whose latest profile wins; see ``python -m
repro_torch.core.tune``); ``cost_modeled_us`` then keeps the default
pricing beside ``cost_us``.  Under ``dist_bench.REFERENCE_PROFILE`` (the
JAX package's "ici"/"dci" constants as numbers) the rows equal the JAX
package's own table.

Decision-boundary sections:

  * ``crossover/…``: per tier and p, the smallest m (bytes, binary
    search) where the segmented ring's best plan beats 123-doubling,
    under the active and the default pricing;
  * ``winner_map…/…``: the auto winner over a ladder of m in bands;
    ``--check`` needs a mid-m builder (halving, quartering,
    reduce_scatter) to win a band at some p in every tier;
  * ``pin/…``: small-m cells where the default profile picks ``123``;
    ``--check`` fails if the active profile flips one of them;
  * ``plan2d/…`` (composed multi-axis plans, executed) and ``fused/…``
    (k concurrent scans fused against serial).

    PYTHONPATH=src python -m repro_torch.benchmarks.plan_table
        [--device cpu] [--check] [--verbose] [--profile PATH]
        [--json [PATH]]

``--verbose`` prints :func:`scan_api.plan_cache_info`.

The ``rounds_measured`` rows keep the JAX package's derived label
``simulator_executor`` so that the rows match its table row for row,
though here they are counted by ``StackedExecutor`` on ``--device``.
"""

from __future__ import annotations

import argparse
import os

from repro_torch.core import scan_api
from repro_torch.core import schedule as schedule_lib
from repro_torch.core import tune
from repro_torch.core.scan_api import ScanSpec, plan, plan_fused
from repro_torch.launch import mesh as mesh_lib

PS = (8, 36, 256, 512)
MS = (8, 1024, 65_536, 1_048_576, 16_777_216)  # payload bytes

# small-m cells eligible for the 123 decision pin (--check gate)
SMALL_MS = (8, 64)

# crossover search range: the smallest m where the ring beats 123
CROSSOVER_LO, CROSSOVER_HI = 8, 1 << 26

# winner-map m ladder (powers of two): the per-band winner table
# sweeps "auto" over these and collapses equal neighbours into bands
WINNER_MS = tuple(1 << e for e in range(3, 27))  # 8 B .. 64 MiB

# the mid-m band builders (gated in --check: each tier
# must show at least one p where one of them wins a band)
NEW_ALGS = ("halving", "quartering", "reduce_scatter")

# composed multi-axis cells: (major, minor) rank grids
PS_2D = ((2, 8), (2, 36), (4, 64))
MS_2D = (8, 65_536)

# fused cells: k concurrent same-axis scans of m bytes each
FUSED_K = 4
MS_FUSED = (8, 1024, 1_048_576)

DEFAULT_JSON = "BENCH_torch_plan_table.json"


def _load_profile(path: str | None):
    """--profile resolution: None -> the port's default; file -> that
    profile; directory -> the most recently written profile in it."""
    if path is None:
        return mesh_lib.DEFAULT_PROFILE
    if os.path.isdir(path):
        prof = tune.latest_profile(path)
        if prof is None:
            raise SystemExit(f"no readable profile_*.json under {path!r}")
        return prof
    return tune.load_profile_file(path)


def _tiers(active):
    """(tier, active_cm, default_cm) triples; tiers the port's default
    profile does not know (the reference's "ici" and "dci") fall back
    to the active kernel for both columns."""
    default = dict(mesh_lib.DEFAULT_PROFILE.tiers)
    return [(name, cm, default.get(name, cm)) for name, cm in
            active.tiers]


def crossover_m(p: int, cm, algo_a: str = "123", algo_b: str = "ring",
                lo: int = CROSSOVER_LO, hi: int = CROSSOVER_HI):
    """Smallest payload m (bytes) in [lo, hi] where ``algo_b``'s best
    plan costs less than ``algo_a``'s under ``cm`` (binary search on
    the monotone α/β trade-off), for ANY registered algorithm pair.

    Returns ``(m_star, qualifier)``: qualifier ``""`` marks an
    interior crossover (m_star is real); ``"<="`` means algo_b
    already wins at ``lo`` (the true crossover is at or below the
    range floor); ``">"`` means algo_a still wins at ``hi`` (no
    crossover in range — which is a legitimate answer when the pair's
    asymptotic byte slopes never cross, e.g. ring vs reduce_scatter
    at large p under the planner's segment cap).  Callers must
    surface the qualifier instead of reporting a saturated boundary
    as if it were a measured crossover."""
    sa = ScanSpec(kind="exclusive", monoid="add", algorithm=algo_a)
    sb = ScanSpec(kind="exclusive", monoid="add", algorithm=algo_b)

    def b_wins(m: int) -> bool:
        return plan(sb, p=p, nbytes=m, cost_model=cm).cost < \
            plan(sa, p=p, nbytes=m, cost_model=cm).cost

    if b_wins(lo):
        return lo, "<="
    if not b_wins(hi):
        return hi, ">"
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if b_wins(mid):
            hi = mid
        else:
            lo = mid
    return hi, ""


def _fmt_crossover(m_star: int, qualifier: str):
    """Row value: the bare integer for a real crossover, '<=LO' /
    '>HI' for a saturated search (never a silently clamped number)."""
    return f"{qualifier}{m_star}" if qualifier else m_star


def winner_map(p: int, cm):
    """Contiguous (m_lo, m_hi, algorithm) bands of the "auto" winner
    over the ``WINNER_MS`` ladder — the per-band winner table the
    mid-m story is measured by.  m_hi is the last ladder point the
    band holds (the final band extends beyond the ladder)."""
    spec = ScanSpec(kind="exclusive", monoid="add", algorithm="auto")
    bands: list = []
    for m in WINNER_MS:
        alg = plan(spec, p=p, nbytes=m, cost_model=cm).algorithm
        if bands and bands[-1][2] == alg:
            bands[-1] = (bands[-1][0], m, alg)
        else:
            bands.append((m, m, alg))
    return bands


def run(csv_rows: list, check: bool = False, profile=None,
        device=None) -> list:
    """Append the table's ``(name, value, derived)`` rows, priced under
    ``profile`` (the port's default when None), each chosen plan
    executed on ``device`` (None is the card; raises when there is
    none); with ``check``, raise ``SystemExit`` on any drift."""
    from repro_torch import device as device_lib

    device = device_lib.resolve(device)
    active = profile or mesh_lib.DEFAULT_PROFILE
    spec = ScanSpec(kind="exclusive", monoid="add", algorithm="auto")
    drift = []
    tiers = _tiers(active)
    csv_rows.append(("profile/source", active.source, "pricing"))
    csv_rows.append(("profile/fingerprint", active.fingerprint(),
                     "pricing"))
    for tier, cm, cm_default in tiers:
        for p in PS:
            for m in MS:
                pl = plan(spec, p=p, nbytes=m, cost_model=cm)
                pl_model = plan(spec, p=p, nbytes=m,
                                cost_model=cm_default)
                res = schedule_lib.verify_plan(pl, device=device)
                key = f"plan/{tier}/p{p}/m{m}"
                csv_rows.append((key + "/algorithm", pl.algorithm,
                                 "auto_choice"))
                csv_rows.append((key + "/segments", pl.segments,
                                 "pipeline_S"))
                csv_rows.append((key + "/rounds", pl.rounds, "rounds"))
                csv_rows.append((key + "/rounds_measured",
                                 res["rounds_measured"],
                                 "simulator_executor"))
                # monoid-aware ⊕ prediction (the add monoid elides the
                # redundant combine order in exchange/scan_reduce
                # rounds); verify_plan above drift-checks it against
                # the executed count
                csv_rows.append((key + "/ops", pl.op_applications,
                                 "oplus_commutative_elided"))
                csv_rows.append((key + "/cost_us", pl.cost * 1e6,
                                 f"us_{pl.cost_model_source}_abg"))
                csv_rows.append((key + "/cost_modeled_us",
                                 pl_model.cost * 1e6,
                                 "us_default_abg"))
                if pl_model.algorithm != pl.algorithm:
                    csv_rows.append((key + "/algorithm_modeled",
                                     pl_model.algorithm,
                                     "default_profile_choice"))
                if not res["ok"]:
                    drift.append((key, res))
    # paper-style crossover table: smallest m where the segmented ring
    # beats 123-doubling, measured (active profile) vs modeled — now
    # with explicit saturation qualifiers instead of silent clamping
    for tier, cm, cm_default in tiers:
        for p in PS:
            key = f"crossover/{tier}/p{p}"
            m_star, q_act = crossover_m(p, cm)
            m_model, q_mod = crossover_m(p, cm_default)
            csv_rows.append((key + "/m_star",
                             _fmt_crossover(m_star, q_act),
                             "min_m_ring_beats_123"))
            csv_rows.append((key + "/m_star_modeled",
                             _fmt_crossover(m_model, q_mod),
                             "min_m_ring_beats_123_default"))
    # per-band winner map (the mid-m payoff, measured not asserted):
    # the "auto" winner over the WINNER_MS ladder, collapsed into
    # bands, under the active ("") and default ("_modeled") pricing;
    # each adjacent band pair gets a binary-searched crossover whose
    # range is the two band edges — saturation there means the sweep
    # and the search disagree, a drift failure, never a clamped cell
    new_band_cells: dict = {}
    for tier, cm, cm_default in tiers:
        for which, kernel in (("", cm), ("_modeled", cm_default)):
            for p in PS:
                bands = winner_map(p, kernel)
                key = f"winner_map{which}/{tier}/p{p}"
                csv_rows.append((
                    key + "/bands",
                    " ".join(f"{alg}:{mlo}..{mhi}"
                             for mlo, mhi, alg in bands),
                    "auto_winner_per_m_band"))
                for (_, ahi, a), (blo, _, b) in zip(bands, bands[1:]):
                    m_star, qual = crossover_m(p, kernel, a, b,
                                               lo=ahi, hi=blo)
                    ckey = f"{key}/crossover/{a}-to-{b}"
                    csv_rows.append((ckey,
                                     _fmt_crossover(m_star, qual),
                                     "min_m_next_band_wins"))
                    if qual:
                        drift.append((ckey, {
                            "saturated": f"{qual}{m_star}",
                            "range": (ahi, blo)}))
                if {alg for _, _, alg in bands} & set(NEW_ALGS):
                    new_band_cells[(which, tier)] = \
                        new_band_cells.get((which, tier), 0) + 1
    # --check gate: every tier must have at least one p where a new
    # mid-m builder wins a band, under BOTH active and default pricing
    for tier, _, _ in tiers:
        for which in ("", "_modeled"):
            n = new_band_cells.get((which, tier), 0)
            csv_rows.append((f"winner_map{which}/{tier}/new_alg_cells",
                             n, "cells_where_mid_m_builder_wins"))
            if n == 0:
                drift.append((f"winner_map{which}/{tier}",
                              {"new_alg_cells": 0, "want": ">=1",
                               "new_algs": NEW_ALGS}))
    # pinned small-m decisions: wherever the default profile picks the
    # paper's 123-doubling, a fitted profile must not flip it
    for tier, cm, cm_default in tiers:
        for p in PS:
            for m in SMALL_MS:
                if plan(spec, p=p, nbytes=m,
                        cost_model=cm_default).algorithm != "123":
                    continue
                got = plan(spec, p=p, nbytes=m, cost_model=cm)
                key = f"pin/{tier}/p{p}/m{m}"
                csv_rows.append((key + "/algorithm", got.algorithm,
                                 "small_m_123_pin"))
                if got.algorithm != "123":
                    drift.append(
                        (key, {"pinned": "123",
                               "got": got.algorithm,
                               "profile": active.fingerprint()}))
    # composed multi-axis plans: one schedule, drift-checked like the
    # single-axis rows (kind "exclusive" and the fused "scan_total")
    spec2 = spec.over(("pod", "data"))
    for tier, cm, _ in tiers:
        for p1, p2 in PS_2D:
            for m in MS_2D:
                for kind in ("exclusive", "scan_total"):
                    pl = plan(spec2.over(spec2.axis_name, kind=kind),
                              p=(p1, p2), nbytes=m, cost_model=cm)
                    res = schedule_lib.verify_plan(pl, device=device)
                    key = f"plan2d/{tier}/{kind}/p{p1}x{p2}/m{m}"
                    csv_rows.append((key + "/algorithm", pl.algorithm,
                                     "composite"))
                    csv_rows.append((key + "/rounds", pl.rounds,
                                     "rounds"))
                    csv_rows.append((key + "/rounds_measured",
                                     res["rounds_measured"],
                                     "simulator_executor"))
                    if not res["ok"]:
                        drift.append((key, res))
    # fused vs serial: k concurrent small scans ride ONE schedule's
    # rounds when the α saving beats the packed payload's β cost
    for tier, cm, _ in tiers:
        for p in PS:
            for m in MS_FUSED:
                fp = plan_fused([spec] * FUSED_K, p, [m] * FUSED_K,
                                cost_model=cm)
                single = plan(spec, p=p, nbytes=m * FUSED_K,
                              cost_model=cm)
                key = f"fused/{tier}/p{p}/m{m}/k{FUSED_K}"
                csv_rows.append((key + "/fused", int(fp.fused),
                                 "fuse_decision"))
                csv_rows.append((key + "/rounds_fused", fp.rounds,
                                 "rounds_chosen"))
                csv_rows.append((key + "/rounds_serial",
                                 sum(pl.rounds for pl in fp.plans),
                                 "k_separate_scans"))
                csv_rows.append((key + "/round_counts",
                                 f"{fp.rounds}=={single.rounds}"
                                 if fp.fused else "serial",
                                 "fused_equals_single_scan"))
                if fp.fused and fp.rounds != single.rounds:
                    drift.append((key, {"fused_rounds": fp.rounds,
                                        "single_rounds": single.rounds}))
                if check:
                    res = fp.verify(device=device)
                    if not res["ok"]:
                        drift.append((key, res))
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
                    help="fail if any plan disagrees with its executed "
                         "schedule, a tier has no mid-m band, or the "
                         "active profile flips a pinned small-m 123 "
                         "decision")
    ap.add_argument("--verbose", action="store_true",
                    help="also print plan-cache hit/miss counters")
    ap.add_argument("--profile", default=None,
                    help="calibrated CostProfile: a profile_*.json "
                         "file or a store directory (latest wins)")
    common.add_json_arg(ap, DEFAULT_JSON)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    prof = _load_profile(args.profile)
    rows = run([], check=args.check, profile=prof, device=dev)
    common.print_csv(rows)
    if args.json:
        common.write_rows(args.json, "torch_plan_table", rows, dev,
                          profile=prof.provenance())
    if args.verbose:
        info = scan_api.plan_cache_info()
        print(f"plan_cache,hits={info['hits']},misses={info['misses']},"
              f"size={info['size']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
