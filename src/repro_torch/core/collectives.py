"""The algorithm registry behind ``scan_api``, and the theory helpers.

Every algorithm here is a schedule builder (:mod:`repro_torch.core
.schedule`) bound to the planner: it returns the round-by-round program
the stacked executor runs, and the planner counts its predictions off
the same IR.  The registrations are the JAX package's
``core/collectives.py`` one for one, so both planners choose among the
same candidates.

Registered exclusive-scan algorithms: "123" (the paper's 123-doubling,
q = ⌈log₂(p−1)+log₂(4/3)⌉ rounds, q−1 result-path ⊕), "1doubling",
"two_op", "native" (all-gather + local fold), "ring" (the pipelined
segmented ring, p−2+S rounds) and the block-distributed "halving",
"quartering" and "reduce_scatter".  Each also registers a
"scan_total" variant; "fused_doubling" is the round-optimal fused
(prefix, total) butterfly.
"""

from __future__ import annotations

from repro_torch.core import oracle
from repro_torch.core import scan_api
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.scan_api import register_algorithm

CollectiveStats = schedule_lib.CollectiveStats
collect_stats = schedule_lib.collect_stats

register_algorithm("123", kind="exclusive")(schedule_lib.build_123)
register_algorithm("1doubling",
                   kind="exclusive")(schedule_lib.build_1doubling)
register_algorithm("two_op", kind="exclusive")(schedule_lib.build_two_op)
register_algorithm("native", kind="exclusive")(schedule_lib.build_native)
register_algorithm("ring", kind="exclusive",
                   segmentable=True)(schedule_lib.build_ring)
# Block-distributed exscan family (mid-m band): vector-halving /
# quartering (Träff-2026 exclusive-scan variants) and the full
# reduce-scatter-depth exscan (Rabenseifner-style halving/doubling:
# ~2·(p−1)/p·m wire bytes in 2⌈log₂p⌉ rounds).  They split payload
# leaves into row blocks, so the monoid must be segmentable.
register_algorithm("halving", kind="exclusive",
                   requires_segmentable=True)(schedule_lib.build_halving)
register_algorithm(
    "quartering", kind="exclusive",
    requires_segmentable=True)(schedule_lib.build_quartering)
register_algorithm(
    "reduce_scatter", kind="exclusive",
    requires_segmentable=True)(schedule_lib.build_reduce_scatter)
register_algorithm("hillis_steele",
                   kind="inclusive")(schedule_lib.build_hillis_steele)
register_algorithm("butterfly",
                   kind="allreduce")(schedule_lib.build_butterfly)

# "scan_total": exclusive scan + allreduce of the same payload fused
# into ONE schedule (outputs (prefix, total)).  Every exclusive
# algorithm registers a with_total variant under its own name, so
# pinned specs keep comparing like for like; "fused_doubling" is the
# round-optimal fused butterfly (both results in ⌈log₂p⌉ rounds at
# power-of-two p) that "auto" picks in the small-m regime.


def _total_variant(base_build):
    def build(p, segments=None):
        sched = (base_build(p, segments) if segments is not None
                 else base_build(p))
        return schedule_lib.with_total(sched)

    return build


register_algorithm("123", kind="scan_total")(
    _total_variant(schedule_lib.build_123))
register_algorithm("1doubling", kind="scan_total")(
    _total_variant(schedule_lib.build_1doubling))
register_algorithm("two_op", kind="scan_total")(
    _total_variant(schedule_lib.build_two_op))
register_algorithm("native", kind="scan_total")(
    _total_variant(schedule_lib.build_native))
register_algorithm("ring", kind="scan_total", segmentable=True)(
    _total_variant(schedule_lib.build_ring))
register_algorithm("halving", kind="scan_total",
                   requires_segmentable=True)(
    _total_variant(schedule_lib.build_halving))
register_algorithm("quartering", kind="scan_total",
                   requires_segmentable=True)(
    _total_variant(schedule_lib.build_quartering))
register_algorithm("reduce_scatter", kind="scan_total",
                   requires_segmentable=True)(
    _total_variant(schedule_lib.build_reduce_scatter))
register_algorithm("fused_doubling",
                   kind="scan_total")(schedule_lib.build_scan_total)


def expected_rounds(algorithm: str, p: int, *,
                    kind: str = "exclusive", segments: int = 1) -> int:
    """Send-receive rounds of a registered algorithm, derived from its
    schedule builder — NOT a hand-maintained table, so it can never
    disagree with the IR the executors run (a drift test pins it to
    the closed-form oracle counts as well).

    Legacy exception: exclusive ``"native"`` reports 1 (its single
    all-gather) rather than the schedule's 0 rounds, preserving the
    historical convention of this helper.
    """
    if kind == "exclusive" and algorithm == "native":
        return 1  # one all-gather (but p·m bytes), zero rounds
    return scan_api.get_algorithm(kind, algorithm).schedule(
        p, segments).rounds


def expected_ops(algorithm: str, p: int, *, kind: str = "exclusive",
                 segments: int = 1, commutative: bool = False) -> int:
    """⊕ executions per device of a registered algorithm, derived
    from its schedule (``Schedule.op_count``), honouring the
    commutative-monoid elision in butterfly/scan_reduce rounds."""
    return scan_api.get_algorithm(kind, algorithm).schedule(
        p, segments).op_count(commutative)
