"""The schedule IR of scan plans, and the stacked-rank executor.

A :class:`Schedule` is the explicit program of a scan algorithm: a
sequence of :class:`RoundStep` entries (peer offsets of each send-receive
round, receive masks, the ⊕ combine direction, identity fixups) over
per-rank payload :class:`Segment` blocks.  Registered algorithms *build*
schedules (``build_123`` …), the planner counts its predictions off the
IR, and the executor runs the same IR, so a plan's predicted rounds,
⊕ applications, bytes and kernel launches equal what
:func:`collect_stats` measures.  The IR half of this module is field
for field the JAX package's ``core/schedule.py`` (lines 106-1200), so
the two planners and executors share one program.

Three transforms extend single algorithms into programs:
:func:`segment` (the pipelined ring of S segments), :func:`compose` /
:func:`compose_total` (the multi-axis rewrite inlined into one
axis-tagged schedule) and :func:`fuse` (k payloads packed into one
buffer described by a :class:`PayloadLayout`).

:class:`StackedExecutor` runs a single-axis schedule on one device with
every payload leaf carrying a leading rank axis of size p.  It is the
unrolled form of the JAX package's ``SPMDExecutor`` with the rank index
as a device ``arange(p)`` and each peer exchange as a gather along the
rank axis (ranks that receive nothing get zero-fill, which the mask
discards).  Every ⊕ goes through the five executor hooks, which call
the round kernels of :mod:`repro_torch.kernels.scan_engine`.  No loop
runs over ranks, and nothing in the round loop reads a device value on
the host, so the rounds queue on the stream without a synchronisation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

import torch

from repro_torch import _tree
from repro_torch import device as device_lib
from repro_torch.core import monoid as monoid_lib
from repro_torch.core import oracle

# ---------------------------------------------------------------------------
# Execution-time instrumentation: the executor records rounds, ⊕
# applications, all-gathers, wire bytes and round-kernel launches here,
# so tests and benchmarks can hold the planner's predictions against the
# program that actually ran.  Counts follow the SPMD convention: per
# rank, as if each rank were its own device.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveStats:
    rounds: int = 0  # send-receive rounds
    op_applications: int = 0  # ⊕ applications per rank (lockstep)
    allgathers: int = 0
    bytes_per_round: list = dataclasses.field(default_factory=list)
    # round-kernel accounting (the IR's kernel_launches/kernel_passes
    # for the executor's mode; 0 for monoids the kernels do not serve)
    kernel_launches: int = 0
    hbm_passes: int = 0


_tls = threading.local()


@contextlib.contextmanager
def collect_stats():
    """Context manager capturing round/op counts of scans executed
    inside."""
    stats = CollectiveStats()
    prev = getattr(_tls, "stats", None)
    _tls.stats = stats
    try:
        yield stats
    finally:
        _tls.stats = prev


def _stats() -> CollectiveStats | None:
    return getattr(_tls, "stats", None)


def _nbytes(tree, lead: int = 1) -> int:
    """Bytes of ONE rank's part of a rank-stacked tree (``lead`` = 1)
    or of a per-rank tree (``lead`` = 0)."""
    total = 0
    for x in _tree.leaves(tree):
        n = x.numel() // (x.shape[0] or 1) if lead else x.numel()
        total += n * x.element_size()
    return total


def _record_round(tree, lead: int = 1):
    s = _stats()
    if s is not None:
        s.rounds += 1
        s.bytes_per_round.append(_nbytes(tree, lead))


def _record_op(n: int = 1):
    s = _stats()
    if s is not None:
        s.op_applications += n


def _record_allgather():
    s = _stats()
    if s is not None:
        s.allgathers += 1


def _record_kernel(launches: int, passes: int):
    s = _stats()
    if s is not None:
        s.kernel_launches += launches
        s.hbm_passes += passes


# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    """One of S contiguous blocks of the flattened per-rank payload.

    Each leaf is flattened and zero-padded to a multiple of ``count``;
    block ``index`` holds elements [index·k, (index+1)·k) with
    k = ceil(size/count).  ⊕ must combine aligned element blocks
    independently for this to be sound (``Monoid.segmentable``)."""

    index: int
    count: int


@dataclasses.dataclass(frozen=True)
class RoundStep:
    """One round of a schedule.

    kind:
      "shift"       — send r → r+skip; masked receive; combine.
      "seg_shift"   — pipelined-ring round ``t``: neighbour send of
                      one payload segment; rank r stores received
                      segment s = t+1−r (when 0 ≤ s < S) as its result
                      and, if ``prep``, forwards recv ⊕ V[s] next
                      round (1 ⊕).  ``seg`` carries S.
      "exchange"    — butterfly exchange r ↔ r^skip; two
                      order-preserving combines selected by the rank's
                      side bit.
      "block_exchange" — one round of the block-distributed exscan
                      family (halving/quartering/reduce_scatter): the
                      payload is split into ``seg`` = 2^t rows and the
                      round moves ``rows`` of them (the per-round byte
                      law ``rows · ceil(m/seg)`` the planner prices).
                      ``phase`` narrows the semantics: "fold" pairs off
                      the p mod 2^t surplus ranks, "up" halves the
                      owned row range against virtual partner v^skip
                      (saving both pre-combine halves for the down
                      sweep), "mid" runs a two-⊕ exscan over the
                      2^t-aligned windows on each rank's single owned
                      row, "down" doubles the row range back while
                      turning window prefixes into rank prefixes, and
                      "unfold" returns the folded pairs' results.
                      ``bound`` carries the fold count ρ, ``t`` the
                      phase round index.
      "scan_reduce" — fused exscan+allreduce butterfly round: exchange
                      the window total T with r^skip while the lower
                      side also folds the received total into the
                      exclusive prefix P (3 ⊕ in SPMD lockstep).  After
                      the run P is saved into register ``reg``.
      "allgather"   — all-gather of the input V.
      "fold"        — local left-fold of the gathered values below own
                      rank (``fold_count`` ⊕ executions).
      "bcast"       — broadcast rank ``root``'s value (via all-gather).
      "stage"       — control (no round): save W into register ``reg``
                      (if set), rebind the stage input X ← W when
                      ``src == "w"``, then reinit W per ``init``
                      ("identity" | "x" | "w" | a register name).
      "merge"       — control ⊕: W ← W ⊕ reg (reg "$x": the current
                      stage input); W covers the lower ranks.

    axis: mesh axis name this step runs over (None: the executor's
      default axis) — composed multi-axis schedules tag every step.
    send (shift only): "x" the input V, "w" the accumulator,
      "w_op_x" the prepared W ⊕ V (counts one ⊕).
    mask/bound (shift only): receive participation — "ge": r ≥ bound,
      "gt": r > bound.  Non-participants keep W (identity fixup).
    combine (shift only): "copy" W ← recv, or "op" W ← recv ⊕ W (the
      recv side always covers lower ranks — non-commutative safe).
    """

    kind: str
    skip: int = 0
    send: str = "w"
    mask: str = "ge"
    bound: int = 0
    combine: str = "none"
    t: int = -1  # seg_shift round index
    prep: bool = False  # seg_shift: forward-prep ⊕ this round
    fold_count: int = 0  # fold: ⊕ executions
    root: int = 0  # bcast source rank
    axis: Any = None  # mesh axis this step runs over (None: default)
    seg: int = 0  # seg_shift: segment count S of this run
    reg: str = ""  # stage save / merge source / scan_reduce prefix reg
    src: str = ""  # stage: "w" rebinds X ← W
    init: str = "identity"  # stage: new W ("identity"|"x"|"w"|register)
    phase: str = ""  # block_exchange: fold|up|mid|down|unfold
    rows: int = 0  # block_exchange: payload rows this round moves

    @property
    def is_round(self) -> bool:
        """Does this step cost one send-receive round?"""
        return self.kind in ("shift", "seg_shift", "exchange",
                             "scan_reduce", "block_exchange")

    @property
    def ops(self) -> int:
        """⊕ executions per device (SPMD lockstep) for this step,
        for a non-commutative monoid (the worst case)."""
        return self.op_count(commutative=False)

    def op_count(self, commutative: bool = False) -> int:
        """⊕ executions per device for this step.

        Commutative monoids elide the redundant combine order: a
        butterfly ``exchange`` computes one combine instead of both
        orders (2→1), and a fused ``scan_reduce`` round folds the
        window total once instead of twice (3→2).  The executors
        apply the same elision, so plans priced off this count match
        :func:`collect_stats` measurements for every monoid."""
        n = 0
        if self.kind == "shift":
            n += 1 if self.send == "w_op_x" else 0
            n += 1 if self.combine == "op" else 0
        elif self.kind == "seg_shift":
            n += 1 if self.prep else 0
        elif self.kind == "exchange":
            n += 1 if commutative else 2
        elif self.kind == "scan_reduce":
            n += 2 if commutative else 3
        elif self.kind == "block_exchange":
            if self.phase in ("fold", "unfold"):
                n += 1  # the folded pair's single combine
            elif self.phase == "up":
                # exchange-shaped: commutative elides the second order
                n += 1 if commutative else 2
            elif self.phase == "mid":
                # copy round carries no ⊕; later rounds prep the send
                # (P ⊕ T) and fold the received window prefix
                n += 0 if self.combine == "copy" else 2
            elif self.phase == "down":
                # lower half preps P ⊕ O_j, upper half adjusts P ⊕ S_j
                # (different operands: no commutative elision)
                n += 2
        elif self.kind == "fold":
            n += self.fold_count
        elif self.kind == "merge":
            n += 1
        return n

    def kernel_passes(self, commutative: bool = False, *,
                      fused: bool = True) -> int:
        """HBM passes over this round's payload on the round-kernel path.

        A "pass" is one sequential sweep of the payload: a kernel
        launch, or a select sweep the baseline path runs on a
        kernel's output.  ``fused=True`` is the engine's fused round
        path (one grid pass does the combine orders, the mask/side
        select and the store); ``fused=False`` is the per-round
        ``block_combine`` baseline (one launch per ⊕ plus host-graph
        selects).  Copy/gather rounds carry no ⊕ work and count 0 —
        the metric prices combine traffic, which both modes share
        otherwise.  The fusion wins: ring prep 2→1, non-commutative
        butterfly 3→1, scan_reduce 2→1 (commutative) / 5→1."""
        if self.kind == "shift":
            n = 1 if self.send == "w_op_x" else 0
            return n + (1 if self.combine == "op" else 0)
        if self.kind == "seg_shift":
            if not self.prep:
                return 0
            return 1 if fused else 2  # baseline: combine + valid-select
        if self.kind == "exchange":
            if commutative:
                return 1
            return 1 if fused else 3  # baseline: 2 orders + side select
        if self.kind == "scan_reduce":
            if fused:
                return 1  # (P, T) pair batched into one launch
            return 2 if commutative else 5  # 3 launches + 2 selects
        if self.kind == "block_exchange":
            if self.phase in ("fold", "unfold"):
                # one masked combine; baseline pays the mask select
                return 1 if fused else 2
            if self.phase == "up":
                if commutative:
                    return 1
                return 1 if fused else 3  # 2 orders + side select
            if self.phase == "mid":
                if self.combine == "copy":
                    return 0
                # prep combine + masked window combine (baseline pays
                # the window-mask select on the second)
                return 2 if fused else 3
            # down: two combines plus the side/adjust selects stay in
            # the host graph — no fused down-round kernel, both modes
            # sweep the half-payload four times
            return 4
        if self.kind == "fold":
            return self.fold_count
        if self.kind == "merge":
            return 1
        return 0

    def kernel_launches(self, commutative: bool = False, *,
                        fused: bool = True) -> int:
        """Round-kernel launches for this round
        (per payload dtype group; k same-dtype leaves batch into one
        launch on the fused path)."""
        if self.kind == "shift":
            n = 1 if self.send == "w_op_x" else 0
            return n + (1 if self.combine == "op" else 0)
        if self.kind == "seg_shift":
            return 1 if self.prep else 0
        if self.kind == "exchange":
            return 1 if (commutative or fused) else 2
        if self.kind == "scan_reduce":
            if fused:
                return 1
            return 2 if commutative else 3
        if self.kind == "block_exchange":
            if self.phase in ("fold", "unfold"):
                return 1
            if self.phase == "up":
                return 1 if (commutative or fused) else 2
            if self.phase == "mid":
                return 0 if self.combine == "copy" else 2
            return 2  # down: prep + adjust combines
        if self.kind == "fold":
            return self.fold_count
        if self.kind == "merge":
            return 1
        return 0

    def describe(self) -> str:
        at = f"  @{self.axis}" if self.axis is not None else ""
        if self.kind == "shift":
            send = {"x": "V", "w": "W", "w_op_x": "W⊕V"}[self.send]
            cmp_ = {"ge": ">=", "gt": ">"}[self.mask]
            comb = "W←recv" if self.combine == "copy" else "W←recv⊕W"
            return (f"shift +{self.skip:<4d} send={send:<4s} "
                    f"recv r{cmp_}{self.bound}  {comb}{at}")
        if self.kind == "seg_shift":
            tail = "; send←recv⊕V[s]" if self.prep else "  (drain)"
            return f"ring  t={self.t:<3d} seg s=t+1−r  W[s]←recv{tail}{at}"
        if self.kind == "exchange":
            return f"xchg  r↔r^{self.skip}  W←ordered(recv,W){at}"
        if self.kind == "scan_reduce":
            return (f"scrd  r↔r^{self.skip}  T←ordered(recv,T); "
                    f"low: P←recv⊕P{at}")
        if self.kind == "block_exchange":
            what = {
                "fold": "pair 2i→2i+1: Y←recv⊕V",
                "up": f"v↔v^{self.skip}: keep/swap half rows",
                "mid": ("window copy P←T[w−1]"
                        if self.combine == "copy"
                        else f"w→w+{self.skip}: P←recv⊕P"),
                "down": f"v↔v^{self.skip}: widen P, low sends P⊕O",
                "unfold": "pair 2i+1→2i: return E; odd: P⊕lo",
            }[self.phase]
            return (f"blk   {self.phase:<6s} rows={self.rows}/"
                    f"{self.seg}  {what}{at}")
        if self.kind == "allgather":
            return f"all-gather V{at}"
        if self.kind == "fold":
            return f"local fold of {self.fold_count + 1} gathered values"
        if self.kind == "bcast":
            return f"broadcast rank {self.root} (all-gather){at}"
        if self.kind == "stage":
            save = f" save W→{self.reg!r};" if self.reg else ""
            src = " X←W;" if self.src == "w" else ""
            return f"stage{save}{src} W←{self.init}"
        if self.kind == "merge":
            other = "X" if self.reg == "$x" else repr(self.reg)
            return f"merge W←W⊕{other}"
        return self.kind


@dataclasses.dataclass(frozen=True)
class Schedule:
    """An executable scan program: init state + ordered RoundSteps.

    ``axes`` names the mesh axes (major→minor, with sizes) of a
    composed multi-axis schedule; single-axis schedules leave it empty
    and run over the executor's axis.  ``outputs`` lists what
    ``execute`` returns — "$w" is the final accumulator, anything else
    a register name; more than one entry returns a tuple.  ``layout``
    (set by :func:`fuse`) packs a sequence of payloads into one
    flattened buffer around the run.
    """

    algorithm: str
    kind: str  # "exclusive" | "inclusive" | "allreduce" | "scan_total"
    p: int
    init: str = "identity"  # initial accumulator W: "identity" | "x"
    segments: tuple[Segment, ...] = (Segment(0, 1),)
    steps: tuple[RoundStep, ...] = ()
    axes: tuple = ()  # ((axis_name, size), ...) major→minor; composed
    outputs: tuple = ("$w",)
    layout: "PayloadLayout | None" = None

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def rounds(self) -> int:
        return sum(1 for s in self.steps if s.is_round)

    @property
    def op_applications(self) -> int:
        """⊕ executions for a non-commutative monoid (worst case);
        use :meth:`op_count` for the monoid-aware number."""
        return self.op_count(commutative=False)

    def op_count(self, commutative: bool = False) -> int:
        """⊕ executions per device, honouring the commutative-monoid
        elision in butterfly/scan_reduce rounds."""
        return sum(s.op_count(commutative) for s in self.steps)

    def kernel_passes(self, commutative: bool = False, *,
                      fused: bool = True) -> int:
        """Total HBM passes of the schedule's ⊕ work on the round-kernel
        path (see :meth:`RoundStep.kernel_passes`); what
        ``collect_stats().hbm_passes`` measures under the stacked
        executor in the matching mode."""
        return sum(s.kernel_passes(commutative, fused=fused)
                   for s in self.steps)

    def kernel_launches(self, commutative: bool = False, *,
                        fused: bool = True) -> int:
        """Total round-kernel launches."""
        return sum(s.kernel_launches(commutative, fused=fused)
                   for s in self.steps)

    @property
    def allgathers(self) -> int:
        return sum(1 for s in self.steps
                   if s.kind in ("allgather", "bcast"))

    def describe(self) -> str:
        """Round-by-round human-readable listing (no tracing needed)."""
        head = (f"{self.kind} [{self.algorithm}] p={self.p} "
                f"S={self.n_segments} rounds={self.rounds} "
                f"⊕={self.op_applications} "
                f"allgathers={self.allgathers} (W₀={self.init})")
        if self.axes:
            head += " axes=" + "x".join(
                f"{name}:{size}" for name, size in self.axes)
        lines = [head]
        rnd = 0
        for st in self.steps:
            tag = f"r{rnd}" if st.is_round else "--"
            rnd += 1 if st.is_round else 0
            lines.append(f"  {tag:>4s}: {st.describe()}")
        return "\n".join(lines)


def _segs(S: int) -> tuple[Segment, ...]:
    return tuple(Segment(i, S) for i in range(S))


# ---------------------------------------------------------------------------
# Per-round byte laws, priced off the IR.  The planner, the calibration
# features and ``expected_round_bytes`` all read these, so a schedule
# whose rounds move less than the full payload (the segmented ring's
# m/S segments, the block family's row slices) is priced exactly as the
# executors transmit it.
# ---------------------------------------------------------------------------


def step_wire_bytes(st: RoundStep, nbytes: int,
                    default_seg: int = 1) -> int:
    """Bytes one round of ``st`` puts on the wire for an ``nbytes``
    payload: a ceil(m/S) segment per pipelined ring round,
    rows·ceil(m/2^t) for a block-exchange round, the full payload
    otherwise.  Non-round steps move nothing here (all-gathers are
    priced separately, as in ``ScanPlan.bytes_on_wire``)."""
    if not st.is_round:
        return 0
    if st.kind == "seg_shift":
        return -(-nbytes // (st.seg or default_seg))
    if st.kind == "block_exchange":
        return st.rows * -(-nbytes // st.seg)
    return nbytes


def wire_bytes(sched: "Schedule", nbytes: int) -> int:
    """Total round wire bytes of the schedule under the per-round law
    (excluding all-gather traffic)."""
    return sum(step_wire_bytes(st, nbytes, sched.n_segments)
               for st in sched.steps)


def op_wire_bytes(sched: "Schedule", nbytes: int,
                  commutative: bool = False) -> int:
    """⊕-traffic bytes: each step's ⊕ count times the bytes one of its
    ⊕ touches.  For uniform schedules this equals
    ``op_count · ceil(m/S)`` (the legacy planner law); block-exchange
    steps combine only the rows they move."""
    seg = _max_seg(sched)
    total = 0
    for st in sched.steps:
        n = st.op_count(commutative)
        if not n:
            continue
        if st.kind == "block_exchange":
            total += n * st.rows * -(-nbytes // st.seg)
        else:
            total += n * -(-nbytes // seg)
    return total


def pass_wire_bytes(sched: "Schedule", nbytes: int,
                    commutative: bool = False, *,
                    fused: bool = True) -> int:
    """Kernel-pass traffic bytes (the gamma_pass cost-model term):
    each step's HBM passes times the bytes one pass sweeps."""
    seg = _max_seg(sched)
    total = 0
    for st in sched.steps:
        n = st.kernel_passes(commutative, fused=fused)
        if not n:
            continue
        if st.kind == "block_exchange":
            total += n * st.rows * -(-nbytes // st.seg)
        else:
            total += n * -(-nbytes // seg)
    return total


# ---------------------------------------------------------------------------
# Builders: one per registered algorithm.  The planner counts rounds/⊕/
# all-gathers off these schedules, so by construction plans predict what
# the executors measure.
# ---------------------------------------------------------------------------


def build_123(p: int) -> Schedule:
    """Algorithm 1 (123-doubling): skip schedule 1, 2, 3·2^(k−2);
    q = ⌈log₂(p−1)+log₂(4/3)⌉ rounds, q−1 result-path ⊕."""
    steps: list[RoundStep] = []
    if p >= 2:
        steps.append(RoundStep("shift", skip=1, send="x", mask="ge",
                               bound=1, combine="copy"))
    if p >= 3:
        # Round 1 (skip 2): send W ⊕ V (rank 0's W is the identity, so
        # it sends plain V exactly as in the paper); combine iff r >= 2.
        steps.append(RoundStep("shift", skip=2, send="w_op_x", mask="ge",
                               bound=2, combine="op"))
        for s in oracle.skips_123(p)[2:]:
            # rank complete once its window bottoms out (paper: 0 < f)
            steps.append(RoundStep("shift", skip=s, send="w", mask="gt",
                                   bound=s, combine="op"))
    return Schedule("123", "exclusive", p, steps=tuple(steps))


def build_1doubling(p: int) -> Schedule:
    """Shift + straight doubling: 1 + ⌈log₂(p−1)⌉ rounds."""
    steps: list[RoundStep] = []
    if p >= 2:
        steps.append(RoundStep("shift", skip=1, send="x", mask="ge",
                               bound=1, combine="copy"))
        for s in oracle.skips_1doubling(p)[1:]:
            steps.append(RoundStep("shift", skip=s, send="w", mask="gt",
                                   bound=s, combine="op"))
    return Schedule("1doubling", "exclusive", p, steps=tuple(steps))


def build_two_op(p: int) -> Schedule:
    """Two-⊕ doubling: ⌈log₂ p⌉ rounds, two ⊕ per round after the first."""
    steps: list[RoundStep] = []
    if p >= 2:
        steps.append(RoundStep("shift", skip=1, send="x", mask="ge",
                               bound=1, combine="copy"))
        k = 1
        while (1 << k) < p:
            s = 1 << k
            steps.append(RoundStep("shift", skip=s, send="w_op_x",
                                   mask="ge", bound=s, combine="op"))
            k += 1
    return Schedule("two_op", "exclusive", p, steps=tuple(steps))


def build_native(p: int) -> Schedule:
    """Library baseline: all-gather everyone's V, fold locally below own
    rank — zero send-receive rounds but p·m wire bytes and p−1 local ⊕."""
    steps: tuple[RoundStep, ...] = ()
    if p >= 2:
        steps = (RoundStep("allgather"),
                 RoundStep("fold", fold_count=p - 1))
    return Schedule("native", "exclusive", p, steps=steps)


def build_ring(p: int, segments: int = 1) -> Schedule:
    """Pipelined segmented neighbour ring: p−2+S rounds of one
    m/S-byte segment each (S=1: the plain p−1-round ring).

    Round t: rank r receives segment s = t+1−r (its exclusive prefix
    for that block, complete on arrival) and forwards recv ⊕ V[s] —
    one ⊕ per non-final round, p−3+S total."""
    S = max(1, int(segments))
    if p <= 1:
        return Schedule("ring", "exclusive", p, segments=_segs(S))
    n = p - 2 + S
    steps = tuple(RoundStep("seg_shift", skip=1, t=t, prep=(t < n - 1),
                            seg=S)
                  for t in range(n))
    return Schedule("ring", "exclusive", p, segments=_segs(S),
                    steps=steps)


def _build_block(name: str, p: int, depth: int) -> Schedule:
    """The block-distributed exscan family (vector halving/doubling).

    The payload is split into R = 2^t elementwise rows
    (t = min(depth, ⌊log₂p⌋)) and the scan runs in five phases over
    M = p − ρ *virtual* ranks (ρ = p mod 2^t surplus ranks pair off in
    a fold pre-round and rejoin in an unfold post-round):

      up    — t butterfly rounds halve each rank's owned row range
              against virtual partner v^2^k, so after round k every
              2^(k+1)-rank window's fold is block-distributed over it;
      mid   — a two-⊕ exscan over the M/2^t windows, each rank
              carrying only its single owned row;
      down  — t rounds double the row range back, converting window
              prefixes into per-rank exclusive prefixes: the lower
              sibling sends P ⊕ O_k (its saved pre-combine half), the
              upper adjusts its own rows by the saved received half.

    Round/byte laws (power-of-two p): 2(1−2^−t)·m + (q−t)/2^t·m wire
    bytes over q+t rounds (q = ⌈log₂p⌉) — t=1 ≈ (q+1)/2·m in q+1
    rounds, t=2 ≈ (q+4)/4·m in q+2, t=q ≈ 2(1−1/p)·m in 2q rounds —
    a graded ladder between the doubling schedules (q·m) and the
    segmented ring (→m as S grows).  ρ≠0 adds the fold/unfold round
    pair.  Rows combine elementwise, so these schedules require a
    segmentable monoid (like :func:`segment`)."""
    steps: list[RoundStep] = []
    if p >= 2:
        t = max(1, min(depth, p.bit_length() - 1))
        R = 1 << t
        rho = p % R
        n_w = (p - rho) >> t
        common = dict(seg=R, bound=rho)
        if rho:
            steps.append(RoundStep("block_exchange", phase="fold",
                                   rows=R, skip=1, t=0, **common))
        for k in range(t):
            steps.append(RoundStep("block_exchange", phase="up",
                                   rows=R >> (k + 1), skip=1 << k, t=k,
                                   **common))
        if n_w >= 2:
            steps.append(RoundStep("block_exchange", phase="mid",
                                   rows=1, skip=1, t=0, combine="copy",
                                   **common))
            i = 1
            while (1 << i) < n_w:
                steps.append(RoundStep("block_exchange", phase="mid",
                                       rows=1, skip=1 << i, t=i,
                                       combine="op", **common))
                i += 1
        for j in reversed(range(t)):
            steps.append(RoundStep("block_exchange", phase="down",
                                   rows=R >> (j + 1), skip=1 << j, t=j,
                                   **common))
        if rho:
            steps.append(RoundStep("block_exchange", phase="unfold",
                                   rows=R, skip=1, t=0, **common))
    return Schedule(name, "exclusive", p, steps=tuple(steps))


def build_halving(p: int) -> Schedule:
    """Träff-2026 exclusive scan, depth-1 halving: ⌈log₂p⌉+1 rounds
    (power-of-two p) of ≈(⌈log₂p⌉+1)/2·m total wire bytes."""
    return _build_block("halving", p, 1)


def build_quartering(p: int) -> Schedule:
    """Träff-2026 exclusive scan, depth-2 quartering: ⌈log₂p⌉+2
    rounds (power-of-two p) of ≈(⌈log₂p⌉+4)/4·m total wire bytes."""
    return _build_block("quartering", p, 2)


def build_reduce_scatter(p: int) -> Schedule:
    """Full-depth reduce-scatter (vector halving/doubling) exscan:
    2⌈log₂p⌉ rounds of ≈2·(p−1)/p·m total wire bytes."""
    return _build_block("reduce_scatter", p, max(1, p.bit_length()))


def build_hillis_steele(p: int) -> Schedule:
    """Hillis-Steele inclusive scan: ⌈log₂ p⌉ rounds, one ⊕ each."""
    steps = tuple(RoundStep("shift", skip=s, send="w", mask="ge",
                            bound=s, combine="op")
                  for s in oracle.skips_two_op(p))
    return Schedule("hillis_steele", "inclusive", p, init="x",
                    steps=steps)


def build_butterfly(p: int) -> Schedule:
    """Recursive-doubling all-reduce: ⌈log₂ p⌉ exchange rounds for
    power-of-two p; otherwise inclusive scan + broadcast of the last
    rank (order-preserving for non-commutative monoids)."""
    if p <= 1:
        return Schedule("butterfly", "allreduce", p, init="x")
    if p & (p - 1):  # non-power-of-two
        incl = build_hillis_steele(p)
        steps = incl.steps + (RoundStep("bcast", root=p - 1),)
        return Schedule("butterfly", "allreduce", p, init="x",
                        steps=steps)
    steps = []
    k = 0
    while (1 << k) < p:
        steps.append(RoundStep("exchange", skip=1 << k))
        k += 1
    return Schedule("butterfly", "allreduce", p, init="x",
                    steps=tuple(steps))


def with_total(base: Schedule) -> Schedule:
    """Fuse an allreduce of the input onto an exclusive-scan schedule.

    After the exscan the last rank alone holds the full prefix, so one
    local ⊕ with its own V completes the total, and one broadcast
    distributes it — no second collective sweep.  Returns a
    "scan_total" schedule with ``outputs = (prefix, total)``.
    """
    if base.kind != "exclusive":
        raise ValueError(
            f"with_total composes over exclusive schedules, "
            f"not {base.kind!r}")
    steps = base.steps + (
        RoundStep("stage", reg="prefix", init="w"),
        RoundStep("merge", reg="$x"),
    )
    if base.p >= 2:
        steps = steps + (RoundStep("bcast", root=base.p - 1),)
    return Schedule(f"{base.algorithm}+total", "scan_total", base.p,
                    init=base.init, segments=base.segments, steps=steps,
                    outputs=("prefix", "$w"))


def build_scan_total(p: int) -> Schedule:
    """Fused exscan+allreduce ("scan_total"): for power-of-two p a
    single (prefix, total) butterfly — each round exchanges the window
    total T with r^2^k while the lower side folds the received total
    into its exclusive prefix P — computes BOTH in ⌈log₂ p⌉ rounds,
    the allreduce's round count.

    Non-power-of-two p (where the r^2^k pairing no longer closes)
    reroutes at plan level to an exscan+``with_total`` variant: the
    cheaper, by (rounds, ⊕), of the 123-doubling and two-⊕-doubling
    exscans plus one local ⊕ and a broadcast — the 123 variant wins
    every tie (equal rounds, strictly fewer result-path ⊕), but the
    reroute keeps the choice explicit rather than assumed.
    ``outputs = (prefix, total)``."""
    if p >= 2 and not (p & (p - 1)):
        steps = []
        k = 0
        while (1 << k) < p:
            steps.append(RoundStep("scan_reduce", skip=1 << k,
                                   reg="prefix"))
            k += 1
        return Schedule("fused_doubling", "scan_total", p, init="x",
                        steps=tuple(steps), outputs=("prefix", "$w"))
    sched = min((with_total(build_123(p)), with_total(build_two_op(p))),
                key=lambda s: (s.rounds, s.op_applications))
    return dataclasses.replace(sched, algorithm="fused_doubling")


def segment(schedule: Schedule, S: int) -> Schedule:
    """The segmentation transform: split the payload into S row-blocks
    and stream them through p−2+S neighbour rounds.

    Only schedules made of neighbour rounds (the ring) pipeline this
    way; doubling schedules have data dependencies across non-neighbour
    peers and raise (including their trivially-empty p <= 1 forms)."""
    if schedule.algorithm != "ring" or not all(
            s.kind == "seg_shift" for s in schedule.steps):
        raise ValueError(
            f"only neighbour-ring schedules are segmentable, "
            f"not {schedule.algorithm!r}")
    return build_ring(schedule.p, S)


# ---------------------------------------------------------------------------
# Multi-axis composition (DESIGN §5 as a schedule transform)
# ---------------------------------------------------------------------------


_STAGE_INITS = ("identity", "x", "w")


def _tag_axis(steps, axis):
    """Tag untagged steps with ``axis`` (control steps stay axis-free)."""
    out = []
    for st in steps:
        if st.axis is None and st.kind not in ("stage", "merge"):
            st = dataclasses.replace(st, axis=axis)
        out.append(st)
    return tuple(out)


def _ns_regs(steps, ns: str):
    """Namespace every register reference so inlined sub-schedules
    cannot collide with the composing schedule's own registers."""
    out = []
    for st in steps:
        rep = {}
        if st.reg and st.reg != "$x":
            rep["reg"] = ns + st.reg
        if st.kind == "stage" and st.init not in _STAGE_INITS:
            rep["init"] = ns + st.init
        out.append(dataclasses.replace(st, **rep) if rep else st)
    return tuple(out)


def _ns_outputs(outputs, ns: str):
    return tuple(o if o == "$w" else ns + o for o in outputs)


def _outer_parts(outer: Schedule, outer_axis):
    """Inlineable (steps, axes) of the outer schedule: already-composed
    outers carry their own axis tags; single-axis ones get tagged."""
    steps = _ns_regs(outer.steps, "o:")
    if outer.axes:
        return steps, outer.axes
    if outer_axis is None:
        raise ValueError("outer_axis is required for a single-axis "
                         "outer schedule")
    return _tag_axis(steps, outer_axis), ((outer_axis, outer.p),)


def compose(inner: Schedule, reduce_: Schedule, outer: Schedule, *,
            minor_axis, outer_axis=None) -> Schedule:
    """Inline the DESIGN §5 multi-axis exscan rewrite into ONE schedule.

        exscan(x, (A, B)) = exscan(total_B(x), A) ⊕ exscan(x, B)

    ``inner`` (exclusive) and ``reduce_`` (allreduce) run over the
    minor axis, ``outer`` (exclusive; possibly itself composed) over
    the major axes, stitched by register control steps:  the inner
    prefix is saved, the minor-axis total becomes the outer stage's
    input, and one final ``merge`` applies the combining ⊕.  Every
    step is axis-tagged, so the result lowers/simulates/executes like
    any single-axis schedule.
    """
    if inner.kind != "exclusive" or outer.kind != "exclusive":
        raise ValueError("compose() takes exclusive inner/outer "
                         f"schedules, got {inner.kind!r}/{outer.kind!r}")
    if reduce_.kind != "allreduce":
        raise ValueError(f"compose() needs an allreduce middle "
                         f"schedule, got {reduce_.kind!r}")
    if reduce_.p != inner.p:
        raise ValueError("inner exscan and minor-axis allreduce must "
                         f"share p ({inner.p} != {reduce_.p})")
    o_steps, o_axes = _outer_parts(outer, outer_axis)
    steps = (
        _tag_axis(inner.steps, minor_axis)
        + (RoundStep("stage", reg="inner", init=reduce_.init),)
        + _tag_axis(_ns_regs(reduce_.steps, "r:"), minor_axis)
        + (RoundStep("stage", src="w", init=outer.init),)
        + o_steps
        + (RoundStep("merge", reg="inner"),)
    )
    name = (f"composite({inner.algorithm}+{reduce_.algorithm}"
            f"+{outer.algorithm})")
    return Schedule(name, "exclusive", inner.p * outer.p,
                    init=inner.init, steps=steps,
                    axes=o_axes + ((minor_axis, inner.p),))


def compose_total(inner: Schedule, outer: Schedule, *,
                  minor_axis, outer_axis=None) -> Schedule:
    """Multi-axis "scan_total": the §5 rewrite where the minor-axis
    allreduce IS the inner scan_total's total — no separate reduce
    stage.  Both sub-schedules must be "scan_total" (prefix in
    register ``prefix``, total in W); the result keeps that contract,
    so composition nests for any number of axes."""
    for s, who in ((inner, "inner"), (outer, "outer")):
        if s.kind != "scan_total":
            raise ValueError(f"compose_total needs scan_total "
                             f"sub-schedules; {who} is {s.kind!r}")
    o_steps, o_axes = _outer_parts(outer, outer_axis)
    steps = (
        _tag_axis(_ns_regs(inner.steps, "i:"), minor_axis)
        # W now holds the minor-axis total: it is the outer stage input
        + (RoundStep("stage", src="w", init=outer.init),)
        + o_steps
        # W = grand total; stash it, combine the two partial prefixes,
        # then restore the (prefix in reg, total in W) contract
        + (RoundStep("stage", reg="total", init="o:prefix"),
           RoundStep("merge", reg="i:prefix"),
           RoundStep("stage", reg="prefix", init="total"))
    )
    name = f"composite({inner.algorithm}+{outer.algorithm})"
    return Schedule(name, "scan_total", inner.p * outer.p,
                    init=inner.init, steps=steps,
                    axes=o_axes + ((minor_axis, inner.p),),
                    outputs=("prefix", "$w"))


# ---------------------------------------------------------------------------
# Payload fusion: k concurrent same-kind scans packed into one buffer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PayloadLayout:
    """Packing of k pytree payloads into one flat buffer per leaf slot.

    All payloads share ``treedef``; per leaf slot j the packed buffer
    concatenates every payload's flattened leaf j (``dtypes[j]`` must
    agree across payloads so ⊕ applies uniformly).  ``offsets[i][j]``/
    ``shapes[i][j]`` locate payload i's leaf j inside buffer j;
    ``totals[j]`` is buffer j's element count.  Sound for monoids that
    combine aligned element positions independently
    (``Monoid.segmentable``)."""

    treedef: Any
    dtypes: tuple  # per slot: numpy dtype str, shared by all payloads
    shapes: tuple  # per payload: per slot leaf shape
    offsets: tuple  # per payload: per slot element offset
    totals: tuple  # per slot: total packed elements

    @property
    def n(self) -> int:
        """Number of packed payloads."""
        return len(self.shapes)


def make_layout(xs, *, lead: int = 1) -> PayloadLayout:
    """Build the :class:`PayloadLayout` packing payloads ``xs``
    (``lead`` leading axes, the rank axis by default, are excluded from
    the per-payload shapes).  ``dtypes`` holds numpy's dtype strings
    ("<i4", ...; "bfloat16" for bf16)."""
    if not xs:
        raise ValueError("make_layout needs at least one payload")
    _, treedef = _tree.flatten(xs[0])
    dtypes = None
    shapes, offsets = [], []
    offs = None
    for x in xs:
        leaves, td = _tree.flatten(x)
        if td != treedef:
            raise ValueError(
                f"fused payloads must share one tree structure "
                f"({td} != {treedef})")
        if dtypes is None:
            dtypes = tuple(device_lib.dtype_str(lf.dtype) for lf in leaves)
            offs = [0] * len(leaves)
        row_s, row_o = [], []
        for j, lf in enumerate(leaves):
            if device_lib.dtype_str(lf.dtype) != dtypes[j]:
                raise ValueError(
                    f"fused payloads must share leaf dtypes; slot {j} "
                    f"has {device_lib.dtype_str(lf.dtype)} vs {dtypes[j]}")
            shp = tuple(int(d) for d in lf.shape[lead:])
            row_s.append(shp)
            row_o.append(offs[j])
            offs[j] += math.prod(shp)
        shapes.append(tuple(row_s))
        offsets.append(tuple(row_o))
    return PayloadLayout(treedef=treedef, dtypes=dtypes,
                         shapes=tuple(shapes), offsets=tuple(offsets),
                         totals=tuple(offs))


def pack_payloads(layout: PayloadLayout, xs, *, lead: int = 1):
    """Pack tensor payloads into the layout's flat buffers (one tree
    with the shared treedef whose leaves are the packed buffers)."""
    flat = [_tree.flatten(x)[0] for x in xs]
    if len(flat) != layout.n:
        raise ValueError(f"layout packs {layout.n} payloads, "
                         f"got {len(flat)}")
    bufs = []
    for j in range(len(layout.dtypes)):
        parts = [flat[i][j].reshape(tuple(flat[i][j].shape[:lead]) + (-1,))
                 for i in range(layout.n)]
        bufs.append(torch.cat(parts, dim=lead) if len(parts) > 1
                    else parts[0])
    return _tree.unflatten(layout.treedef, bufs)


def unpack_payloads(layout: PayloadLayout, packed, *, lead: int = 1):
    """Slice the packed buffers back into the k original payloads."""
    bufs = _tree.flatten(packed)[0]
    outs = []
    for i in range(layout.n):
        leaves = []
        for j, buf in enumerate(bufs):
            off = layout.offsets[i][j]
            shp = layout.shapes[i][j]
            sl = buf[..., off:off + math.prod(shp)]
            leaves.append(sl.reshape(tuple(buf.shape[:lead]) + shp))
        outs.append(_tree.unflatten(layout.treedef, leaves))
    return outs


def fuse(schedules, layout: PayloadLayout) -> Schedule:
    """Fuse k concurrent same-axis/same-kind scans into one schedule:
    the packed payload (per ``layout``) rides the rounds of the
    cheapest compatible schedule, so k scans cost one scan's α·q.

    All schedules must agree on (kind, p, axes) and on their output
    list; executors pack the payload sequence on entry and unpack the
    results on exit — multi-output schedules (scan_total's
    (prefix, total)) unpack to one output tuple per payload."""
    if not schedules:
        raise ValueError("fuse() needs at least one schedule")
    base = min(schedules, key=lambda s: (s.rounds, s.op_applications))
    for s in schedules:
        if (s.kind, s.p, s.axes) != (base.kind, base.p, base.axes):
            raise ValueError(
                "fused schedules must share kind/p/axes; got "
                f"{(s.kind, s.p, s.axes)} vs "
                f"{(base.kind, base.p, base.axes)}")
        if s.outputs != base.outputs:
            raise ValueError(
                "fused schedules must share outputs; got "
                f"{s.outputs} vs {base.outputs}")
        if s.layout is not None:
            raise ValueError("schedule is already fused")
    return dataclasses.replace(
        base, layout=layout,
        algorithm=f"fused[{layout.n}]({base.algorithm})")


def unpack_fused_outputs(layout: PayloadLayout, out, n_outputs: int = 1,
                         *, lead: int = 1):
    """Unpack a fused execution's result back into per-payload results.

    ``n_outputs`` is ``len(schedule.outputs)`` — it cannot be inferred
    from ``out``'s type because tuple-leaf payloads (affine) make a
    single output a tuple too.  Single-output schedules return the
    list of k unpacked payloads; multi-output schedules (scan_total)
    return one tuple per payload — payload i gets
    ``(output0_i, output1_i, ...)``, so a fused scan_total hands every
    request its own (prefix, total)."""
    if n_outputs > 1:
        per_out = [unpack_payloads(layout, o, lead=lead) for o in out]
        return [tuple(po[i] for po in per_out)
                for i in range(layout.n)]
    return unpack_payloads(layout, out, lead=lead)


# ---------------------------------------------------------------------------
# Stage-run decomposition shared by the executors: a schedule's steps
# split into control steps (stage/merge) and maximal runs of compute
# steps over one axis (seg_shift and scan_reduce runs kept homogeneous,
# since they carry run-level auxiliary state).
# ---------------------------------------------------------------------------


_STATEFUL = ("seg_shift", "scan_reduce", "block_exchange")


def _stage_runs(steps):
    runs: list = []
    cur: list = []

    def flush():
        nonlocal cur
        if cur:
            runs.append(cur)
            cur = []

    for st in steps:
        if st.kind in ("stage", "merge"):
            flush()
            runs.append(st)
            continue
        if cur and (cur[0].axis != st.axis
                    or (cur[0].kind in _STATEFUL) !=
                    (st.kind in _STATEFUL)
                    or (st.kind in _STATEFUL
                        and cur[0].kind != st.kind)):
            flush()
        cur.append(st)
    flush()
    return runs


# ---------------------------------------------------------------------------
# Rank-axis data motion: the stacked executor's peer exchanges.  Every
# leaf is (p, ...); a round's send-receive is a gather along the rank
# axis, and ranks that receive nothing get zero-fill, which the round's
# mask discards (or, for idle ranks, which is never observed).
# ---------------------------------------------------------------------------


def _bmask(mask, t):
    """A (p,) mask as a bool tensor broadcastable against leaf ``t``."""
    return (mask != 0).view((-1,) + (1,) * (t.dim() - 1))


def _select(mask, a, b):
    """where(mask[rank], a, b), leaf by leaf."""
    return _tree.tree_map(lambda x, y: torch.where(_bmask(mask, x), x, y),
                          a, b)


def _i32(mask):
    return mask.to(torch.int32)


def _shift_rows(tree, skip: int):
    """Rank r receives rank r−skip's row; ranks below ``skip`` get 0."""
    def one(t):
        out = torch.empty_like(t)
        n = max(t.shape[0] - skip, 0)
        out[:t.shape[0] - n].zero_()
        if n:
            out[t.shape[0] - n:].copy_(t[:n])
        return out

    return _tree.tree_map(one, tree)


def _permute(tree, src, valid=None):
    """Rank r receives row ``src[r]``; where ``valid`` is false it
    receives zero-fill instead."""
    def one(t):
        out = t.index_select(0, src)
        if valid is not None:
            out.masked_fill_(~_bmask(valid, out), 0)
        return out

    return _tree.tree_map(one, tree)


def _split(a, S: int):
    """(p, *shape) -> (p, S, ceil(size/S)): each rank's part flattened
    and zero-padded (``Monoid.segmentable`` makes this sound)."""
    p = a.shape[0]
    flat = a.reshape(p, -1)
    n = flat.shape[1]
    k = -(-n // S)
    if S * k > n:
        flat = torch.cat([flat, flat.new_zeros((p, S * k - n))], dim=1)
    return flat.reshape(p, S, k)


def _unsplit(seg, like):
    p = like.shape[0]
    n = like[0].numel() if p else 0
    return seg.reshape(p, -1)[:, :n].reshape(like.shape)


def _halves(tree, bit, half: int):
    """Rank r's half ``bit[r]`` (0 low, 1 high) of its 2·half rows."""
    def one(t):
        p = t.shape[0]
        ar = torch.arange(p, device=t.device)
        return t.reshape((p, 2, half) + tuple(t.shape[2:]))[ar, bit]

    return _tree.tree_map(one, tree)


def _store_rows(R, seg, valid, r, sc):
    """R[r, sc[r]] ← seg[r] where valid[r] (in place on R, a buffer the
    executor owns)."""
    def one(acc, s):
        acc[r, sc] = torch.where(_bmask(valid, s), s, acc[r, sc])
        return acc

    return _tree.tree_map(one, R, seg)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


class StackedExecutor:
    """Runs a single-axis schedule on one device, ranks stacked on the
    leading axis of every payload leaf.

    ``device`` defaults to the CUDA card (``"cpu"`` runs the round
    kernels' plain PyTorch versions).  ``fused=True`` runs each round's
    combine orders, mask or side select and store in ONE round-kernel
    launch per payload dtype group; ``fused=False`` is the baseline of
    one ``block_combine`` launch per ⊕ and leaf with the selects in
    PyTorch.  Either mode records the IR's ``kernel_launches`` and
    ``kernel_passes`` into :func:`collect_stats`; on the card the fused
    mode launches exactly that many round kernels.

    Stats follow the SPMD convention of the JAX package: one round per
    send-receive, ⊕ counted per rank, ``bytes_per_round`` one rank's
    payload.  The five ⊕ hooks (``combine``, ``masked_combine``,
    ``exchange_combine``, ``scan_reduce_combine``, ``prep_combine``)
    are where the round kernels plug in; matmul, which no round kernel
    serves, runs through ``torch.matmul``.

    Multi-axis (composed, hierarchical) schedules are not executed on
    one card yet and raise ``NotImplementedError``.
    """

    def __init__(self, device=None, *, fused: bool = True):
        self.device = device_lib.resolve(device)
        self.fused = bool(fused)
        self._tables: dict = {}  # (kind, p, skip) -> int32 row table

    @staticmethod
    def _engine():
        from repro_torch.kernels import scan_engine

        return scan_engine

    # -- the ⊕ hooks ----------------------------------------------------

    def combine(self, m: monoid_lib.Monoid, lo, hi):
        """⊕ with ``lo`` covering the lower ranks; either may be a
        peer's rows (``scan_engine.Rows``), gathered where no fused
        kernel reads it in place."""
        se = self._engine()
        if se.supports(m) and (self.fused or m.leaf_op is None):
            out = se.tree_combine(m, lo, hi)
            if out is not None:
                return out
        lo, hi = se.gather_rows(lo), se.gather_rows(hi)
        if se.supports(m) and not self.fused and m.leaf_op is not None:
            return _tree.tree_map(
                lambda a, b: se.block_combine(a, b, m.name), lo, hi)
        return m.op(lo, hi)

    def masked_combine(self, m: monoid_lib.Monoid, keep, lo, hi):
        """where(keep, lo ⊕ hi, hi): one select on the combine output;
        ``lo`` may be zero-fill on non-kept ranks."""
        se = self._engine()
        if se.supports(m):
            if self.fused:
                out = se.tree_combine(m, lo, hi, keep=keep)
                if out is not None:
                    return out
            elif m.leaf_op is not None:
                return _tree.tree_map(
                    lambda a, b: se.block_combine(a, b, m.name, keep=keep),
                    se.gather_rows(lo), hi)
        return _select(keep, self.combine(m, lo, hi), hi)

    def exchange_combine(self, m: monoid_lib.Monoid, recv, w, low_side):
        """Non-commutative butterfly update: both orders, selected by
        the rank's side bit."""
        if self.fused and self._engine().supports(m):
            out = self._engine().tree_exchange(m, recv, w, low_side)
            if out is not None:
                return out
        recv = self._engine().gather_rows(recv)
        return _select(low_side, self.combine(m, recv, w),
                       self.combine(m, w, recv))

    def scan_reduce_combine(self, m: monoid_lib.Monoid, recv, w, prefix,
                            low_side):
        """One fused exscan+allreduce round's (T, P) update."""
        if self.fused and self._engine().supports(m):
            out = self._engine().tree_scan_reduce(m, recv, w, prefix,
                                                  low_side)
            if out is not None:
                return out
        recv = self._engine().gather_rows(recv)
        if m.commutative:
            prefix = self.masked_combine(m, low_side, recv, prefix)
            return self.combine(m, recv, w), prefix
        new_p = self.combine(m, recv, prefix)
        t_lo = self.combine(m, recv, w)
        t_hi = self.combine(m, w, recv)
        return (_select(low_side, t_lo, t_hi),
                _select(low_side, new_p, prefix))

    def prep_combine(self, m: monoid_lib.Monoid, valid, recv, seg, ident):
        """The ring's forward prep: recv ⊕ V[s] where valid, else V[s]."""
        if self.fused:
            return self.masked_combine(m, valid, recv, seg)
        return self.combine(m, _select(valid, recv, ident), seg)

    def _fold_combine(self, m, take, acc, row):
        """acc ⊕ row on ranks where ``take``, acc elsewhere; ``row`` is
        one gathered row broadcast to every rank."""
        se = self._engine()
        if self.fused and se.supports(m):
            out = se.tree_combine(m, acc, row, keep=take, else_lo=True)
            if out is not None:
                return out
        return _select(take, self.combine(m, acc, row), acc)

    def _peer(self, m: monoid_lib.Monoid, tree, r, *, skip: int,
              xor: bool = False):
        """What rank r receives in a shift by ``skip`` (rank r−skip's
        row, zeros below ``skip``) or, with ``xor``, in the butterfly
        (rank r^skip's row).  Where a fused round kernel takes the ⊕,
        it reads the peer's row in place through a row table
        (``scan_engine.Rows``); otherwise the rows are gathered."""
        se = self._engine()
        if not (self.fused and se.supports(m)):
            return _permute(tree, r ^ skip) if xor else \
                _shift_rows(tree, skip)
        p = r.shape[0]
        key = ("xor" if xor else "shift", p, skip)
        table = self._tables.get(key)
        if table is None:  # a negative entry reads zeros
            lo = 0 if xor else -skip
            table = torch.arange(lo, lo + p, dtype=torch.int32,
                                 device=r.device)
            if xor:
                table ^= skip
            self._tables[key] = table
        return se.Rows(tree, table)

    def _note_round_kernels(self, st: RoundStep, m: monoid_lib.Monoid):
        if self._engine().supports(m):
            _record_kernel(
                st.kernel_launches(m.commutative, fused=self.fused),
                st.kernel_passes(m.commutative, fused=self.fused))

    # -- execution ------------------------------------------------------

    def execute(self, sched: Schedule, x, m):
        """Run ``sched`` on ``x`` (leaves (p, ...); numpy leaves are
        moved to the executor's device).  A fused schedule takes the
        list of its payloads and returns the list of their results."""
        m = monoid_lib.get(m)
        if sched.axes:
            raise NotImplementedError(
                "executing multi-axis (composed or hierarchical) "
                "schedules on one card is not ported yet; see ROADMAP.md")
        x = device_lib.to_torch(x, self.device)
        if sched.layout is not None:
            packed = pack_payloads(sched.layout, list(x), lead=1)
            out = self._execute(sched, packed, m)
            return unpack_fused_outputs(sched.layout, out,
                                        len(sched.outputs), lead=1)
        return self._execute(sched, x, m)

    def _execute(self, sched: Schedule, x, m):
        p = sched.p
        for leaf in _tree.leaves(x):
            if leaf.dim() < 1 or leaf.shape[0] != p:
                raise ValueError(f"payload leaves need a leading rank axis "
                                 f"of {p}; got shape {tuple(leaf.shape)}")
        r = torch.arange(p, device=self.device)
        regs: dict = {}
        w = x if sched.init == "x" else m.identity_like(x)
        for run in _stage_runs(sched.steps):
            if isinstance(run, RoundStep):  # control step
                st = run
                if st.kind == "stage":
                    if st.reg:
                        regs[st.reg] = w
                    if st.src == "w":
                        x = w
                    if st.init == "identity":
                        w = m.identity_like(x)
                    elif st.init == "x":
                        w = x
                    elif st.init != "w":
                        w = regs[st.init]
                else:  # merge
                    other = x if st.reg == "$x" else regs[st.reg]
                    w = self.combine(m, w, other)
                    _record_op()
                    self._note_round_kernels(st, m)
                continue
            kind = run[0].kind
            if kind == "seg_shift":
                w = self._run_segmented(run, x, m, p, r,
                                        run[0].seg or sched.n_segments)
            elif kind == "scan_reduce":
                w, prefix = self._run_scan_reduce(run, x, w, m, r)
                if run[-1].reg:
                    regs[run[-1].reg] = prefix
            elif kind == "block_exchange":
                w = self._run_block(run, x, m, p, r)
            else:
                w = self._run_steps(run, x, w, m, r)
        outs = tuple(w if o == "$w" else regs[o] for o in sched.outputs)
        return outs[0] if len(outs) == 1 else outs

    def _run_steps(self, steps, x, w, m, r):
        gathered = None
        for st in steps:
            if st.kind == "shift":
                if st.send == "x":
                    src = x
                elif st.send == "w":
                    src = w
                else:  # "w_op_x": rank 0's W is the identity -> sends V
                    src = self.combine(m, w, x)
                    _record_op()
                _record_round(src)
                has = (r >= st.bound) if st.mask == "ge" else \
                    (r > st.bound)
                if st.combine == "op":
                    recv = self._peer(m, src, r, skip=st.skip)
                    w = self.masked_combine(m, _i32(has), recv, w)
                    _record_op()
                else:  # "copy"
                    w = _select(has, _shift_rows(src, st.skip), w)
            elif st.kind == "exchange":
                _record_round(w)
                recv = self._peer(m, w, r, skip=st.skip, xor=True)
                if m.commutative:
                    w = self.combine(m, recv, w)
                    _record_op()
                else:
                    low_side = _i32((r & st.skip) != 0)
                    w = self.exchange_combine(m, recv, w, low_side)
                    _record_op(2)
            elif st.kind == "allgather":
                _record_allgather()
                gathered = x  # every rank's V is already on the rank axis
            elif st.kind == "fold":
                _record_op(st.fold_count)
                acc = m.identity_like(x)
                for i in range(st.fold_count):
                    row = _tree.tree_map(lambda g: g[i:i + 1], gathered)
                    acc = self._fold_combine(m, _i32(r > i), acc, row)
                w = acc
            elif st.kind == "bcast":
                _record_allgather()
                w = _tree.tree_map(
                    lambda t: t[st.root:st.root + 1].expand_as(t).clone(),
                    w)
            self._note_round_kernels(st, m)
        return w

    def _run_scan_reduce(self, steps, x, w, m, r):
        """The fused exscan+allreduce butterfly: W carries the window
        total T, the auxiliary P the exclusive prefix."""
        prefix = m.identity_like(x)
        for st in steps:
            _record_round(w)
            recv = self._peer(m, w, r, skip=st.skip, xor=True)
            low_side = _i32((r & st.skip) != 0)
            w, prefix = self.scan_reduce_combine(m, recv, w, prefix,
                                                 low_side)
            _record_op(2 if m.commutative else 3)
            self._note_round_kernels(st, m)
        return w, prefix

    def _run_segmented(self, steps, x, m, p, r, S):
        """The pipelined ring, unrolled: in round t rank r stores the
        received segment s = t+1−r and forwards recv ⊕ V[s]."""
        V = _tree.tree_map(lambda a: _split(a, S), x)
        R = m.identity_like(V)
        cur = _tree.tree_map(lambda a: a[:, 0], V)  # rank 0 sends V[0]
        ident = m.identity_like(cur)  # built once, outside the rounds
        for st in steps:
            _record_round(cur)
            if st.prep:
                _record_op()
            self._note_round_kernels(st, m)
        for st in steps:
            s_recv = st.t + 1 - r
            valid = (r >= 1) & (s_recv >= 0) & (s_recv < S)
            sc = s_recv.clamp(0, S - 1)
            recv = _shift_rows(cur, 1)
            R = _store_rows(R, recv, valid, r, sc)
            if st.prep:
                seg = _tree.tree_map(lambda a: a[r, sc], V)
                cur = self.prep_combine(m, _i32(valid), recv, seg, ident)
        return _tree.tree_map(_unsplit, R, x)

    def _run_block(self, steps, x, m, p, r):
        """The block-distributed exscan family (see :func:`_build_block`):
        the payload lives split into R = 2^t rows; per-rank row offsets
        and partners are index tensors, so no loop runs over ranks.
        The fold's even partners idle through the core phases and their
        garbage is never observed."""
        st0 = steps[0]
        R = st0.seg
        t_eff = R.bit_length() - 1
        rho = st0.bound
        Y = _tree.tree_map(lambda a: _split(a, R), x)
        folded = r < 2 * rho
        odd_folded = folded & (r % 2 == 1)
        even_folded = folded & (r % 2 == 0)
        is_rep = ~even_folded
        v = torch.where(folded, r // 2, r - rho)  # virtual rank

        def rep(u):  # virtual -> physical representative
            return torch.where(u < rho, 2 * u + 1, u + rho)

        lo_in = None  # fold: the received pair value
        O_saved: dict = {}  # up round k: own pre-combine kept half
        S_saved: dict = {}  # up round k: received partner half
        T = P = None
        for st in steps:
            if st.phase == "fold":
                _record_round(Y)
                recv = _permute(Y, (r - 1).clamp(min=0), odd_folded)
                lo_in = recv
                Y = self.masked_combine(m, _i32(odd_folded), recv, Y)
            elif st.phase == "up":
                k = st.t
                half = R >> (k + 1)
                bit = (v >> k) & 1
                kept = _halves(Y, bit, half)
                sent = _halves(Y, 1 - bit, half)
                _record_round(sent)
                recv = _permute(sent, rep(v ^ (1 << k)), is_rep)
                O_saved[k], S_saved[k] = kept, recv
                if m.commutative:
                    Y = self.combine(m, recv, kept)
                else:  # bit set: the partner covers lower virtual ranks
                    Y = self.exchange_combine(m, recv, kept, _i32(bit))
            elif st.phase == "mid":
                if T is None:
                    T = Y  # the own-row window fold
                    P = m.identity_like(T)
                s = st.skip  # window stride
                d = s << t_eff  # virtual-rank distance
                has = (v >> t_eff) >= s
                src = rep((v - d).clamp(min=0))
                arrives = is_rep & (v >= d)
                if st.combine == "copy":
                    _record_round(T)
                    P = _select(has, _permute(T, src, arrives), P)
                else:
                    # window 0's P is the identity, so it sends plain T
                    send = self.combine(m, P, T)
                    _record_round(send)
                    recv = _permute(send, src, arrives)
                    P = self.masked_combine(m, _i32(has), recv, P)
            elif st.phase == "down":
                j = st.t
                if P is None:  # single window: no mid rounds ran
                    P = m.identity_like(Y)
                lower = ((v >> j) & 1) == 0
                send = _select(lower, self.combine(m, P, O_saved[j]), P)
                _record_round(send)
                recv = _permute(send, rep(v ^ (1 << j)), is_rep)
                own = _select(lower, P, self.combine(m, P, S_saved[j]))
                # widen: own rows keep their side of the doubled range,
                # the received sibling rows fill the other
                P = _tree.tree_map(
                    lambda o, c: torch.cat(
                        [torch.where(_bmask(lower, o), o, c),
                         torch.where(_bmask(lower, o), c, o)], dim=1),
                    own, recv)
            else:  # unfold
                _record_round(P)
                recv = _permute(P, (r + 1).clamp(max=p - 1), even_folded)
                adj = self.combine(m, P, lo_in)
                P = _select(odd_folded, adj, _select(even_folded, recv, P))
            _record_op(st.op_count(m.commutative))
            self._note_round_kernels(st, m)
        if P is None:
            P = Y
        return _tree.tree_map(_unsplit, P, x)


# ---------------------------------------------------------------------------
# Host-side plan verification on the CPU
# ---------------------------------------------------------------------------


def _witness_payload(name: str, p: int, n0: int, seed: int):
    """The JAX package's witness payloads (numpy, from ``seed``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if name == "affine":
        return (rng.standard_normal((p, n0)),
                rng.standard_normal((p, n0)))
    if name == "matmul":
        return rng.standard_normal((p, 4, 4)) * 0.5
    if name in ("add", "xor"):
        return rng.integers(0, 1 << 30, size=(p, n0)).astype(np.int64)
    return rng.standard_normal((p, n0))


def _host_reference(kind: str, x, m: monoid_lib.Monoid, p: int):
    """Sequential rank-by-rank fold: the independent reference."""
    if kind == "scan_total":
        return (_host_reference("exclusive", x, m, p),
                _host_reference("allreduce", x, m, p))
    V = [_tree.tree_map(lambda a: a[q], x) for q in range(p)]
    acc = m.identity_like(V[0])
    out = []
    for q in range(p):
        if kind == "exclusive":
            out.append(acc)
        acc = m.op(acc, V[q])
        if kind == "inclusive":
            out.append(acc)
    if kind == "allreduce":
        out = [acc] * p
    return _tree.tree_map(lambda *ws: torch.stack(ws, 0), *out)


def _max_seg(sched: Schedule) -> int:
    return max((st.seg or sched.n_segments for st in sched.steps
                if st.kind == "seg_shift"), default=1)


def expected_round_bytes(sched: Schedule, per_rank) -> int:
    """The schedule's per-round byte law summed over its rounds, for a
    per-rank payload tree (no rank axis)."""
    sizes = [(t.numel(), t.element_size()) for t in _tree.leaves(per_rank)]
    total = 0
    for st in sched.steps:
        if not st.is_round:
            continue
        if st.kind == "seg_shift":
            S = st.seg or sched.n_segments
            total += sum(-(-n // S) * b for n, b in sizes)
        elif st.kind == "block_exchange":
            total += sum(st.rows * -(-n // st.seg) * b for n, b in sizes)
        else:
            total += sum(n * b for n, b in sizes)
    return total


def _close(got, want) -> bool:
    return all(torch.allclose(g.double(), w.double(), rtol=1e-10,
                              atol=1e-12)
               for g, w in zip(_tree.leaves(got), _tree.leaves(want)))


def verify_plan(plan, *, rank_elems: int = 2, seed: int = 0) -> dict:
    """Execute ``plan``'s schedule with the stacked executor on the CPU
    against a sequential reference; returns measured-vs-predicted
    stats."""
    m = monoid_lib.get(plan.spec.monoid)
    sched = plan.schedule()
    n0 = max(_max_seg(sched), 1) * rank_elems
    x = device_lib.to_torch(_witness_payload(m.name, plan.p, n0, seed),
                            "cpu")
    with collect_stats() as st:
        got = StackedExecutor("cpu").execute(sched, x, m)
    close = _close(got, _host_reference(plan.spec.kind, x, m, plan.p))
    per_rank = _tree.tree_map(lambda a: a[0], x)
    bytes_expected = expected_round_bytes(sched, per_rank)
    res = {
        "algorithm": plan.algorithm, "p": plan.p,
        "segments": plan.segments,
        "rounds_predicted": plan.rounds, "rounds_measured": st.rounds,
        "ops_predicted": plan.op_applications,
        "ops_measured": st.op_applications,
        "allgathers_predicted": plan.allgathers,
        "allgathers_measured": st.allgathers,
        "bytes_expected": bytes_expected,
        "bytes_measured": sum(st.bytes_per_round),
        "correct": bool(close),
    }
    res["ok"] = bool(
        close
        and st.rounds == plan.rounds
        and st.op_applications == plan.op_applications
        and st.allgathers == plan.allgathers
        and sum(st.bytes_per_round) == bytes_expected)
    return res
