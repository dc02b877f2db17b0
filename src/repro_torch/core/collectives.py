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

The legacy string API (``exscan``/``inclusive_scan``/``allreduce``) is
kept as deprecated wrappers over ``scan_api``, as in the JAX package:
they emit a ``DeprecationWarning`` pointing at :class:`ScanSpec`.  Their
payload carries the ranks on its leading dimension, as ``scan`` takes
it; ``axis_name`` goes into the spec.
"""

from __future__ import annotations

import warnings

from repro_torch.core import monoid as monoid_lib
from repro_torch.core import oracle
from repro_torch.core import scan_api
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.scan_api import ScanSpec, register_algorithm, scan

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


# ---------------------------------------------------------------------------
# Legacy string API: deprecated wrappers over scan_api (new code builds a
# ScanSpec and calls scan_api.scan / scan_api.plan directly).
# ---------------------------------------------------------------------------

ALGORITHMS = scan_api.algorithms("exclusive")


def _deprecated(name: str):
    warnings.warn(
        f"collectives.{name}() is deprecated; build a "
        f"scan_api.ScanSpec and call scan_api.scan(x, spec) instead",
        DeprecationWarning, stacklevel=3)


def exscan(x, axis_name, m="add", algorithm: str = "123", *,
           executor=None):
    """DEPRECATED: exclusive prefix scan over the ranks of ``x``.

    Equivalent to ``scan(x, ScanSpec(kind="exclusive", monoid=m,
    algorithm=algorithm, axis_name=axis_name), executor=executor)``.

    Args:
      x: payload tree whose leaves carry the ranks on their leading
        dimension (one per axis of ``axis_name`` when it is a tuple).
      axis_name: an axis name, or a tuple of names ordered
        major→minor.
      m: a Monoid or registry name.
      algorithm: one of ``ALGORITHMS``, or ``"auto"``.
      executor: as ``scan``'s (the stacked executor on the card by
        default).

    Returns:
      The exclusive prefix ⊕_{i<r} V_i; rank 0 gets the identity.
    """
    _deprecated("exscan")
    return scan(x, ScanSpec(kind="exclusive", monoid=monoid_lib.get(m),
                            algorithm=algorithm, axis_name=axis_name),
                executor=executor)


def inclusive_scan(x, axis_name, m="add", *, executor=None):
    """DEPRECATED: Hillis-Steele inclusive scan (use a ScanSpec)."""
    _deprecated("inclusive_scan")
    return scan(x, ScanSpec(kind="inclusive", monoid=monoid_lib.get(m),
                            algorithm="hillis_steele",
                            axis_name=axis_name), executor=executor)


def allreduce(x, axis_name, m="add", *, executor=None):
    """DEPRECATED: butterfly all-reduce (use a ScanSpec)."""
    _deprecated("allreduce")
    return scan(x, ScanSpec(kind="allreduce", monoid=monoid_lib.get(m),
                            algorithm="butterfly", axis_name=axis_name),
                executor=executor)


# ---------------------------------------------------------------------------
# Theory helpers re-exported for benchmarks
# ---------------------------------------------------------------------------

q_123 = oracle.q_123
rounds_1doubling = oracle.rounds_1doubling
rounds_two_op = oracle.rounds_two_op
rounds_halving = oracle.rounds_halving
rounds_quartering = oracle.rounds_quartering
rounds_reduce_scatter = oracle.rounds_reduce_scatter


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
