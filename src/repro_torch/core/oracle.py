"""Pure-Python message-schedule oracle for the paper's scan algorithms.

This module simulates, rank by rank and round by round, the exact
communication schedules of the three exclusive-scan algorithms from the
paper (plus the Hillis-Steele inclusive scan), counting

  * communication rounds (simultaneous send-receive steps),
  * per-rank applications of ``op`` split into receive-path combines and
    send-side preparations,

so that tests can check Theorem 1 and the costs claimed for the
baselines.  It is written in the paper's own terms (skips, Send∥Recv
pairs, per-rank W/T buffers), not in terms of the masked rounds the
stacked-rank executor runs, and uses no tensors at all.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence


@dataclasses.dataclass
class ScheduleStats:
    algorithm: str
    p: int
    rounds: int
    # per-rank counts, length p
    combines: list  # ⊕ applications on the rank's own result path
    preps: list  # ⊕ applications preparing a value to send
    messages: int  # total point-to-point messages

    @property
    def max_ops(self) -> int:
        return max(c + s for c, s in zip(self.combines, self.preps))

    @property
    def result_path_ops(self) -> int:
        """⊕ count of the last rank (the critical rank) — Theorem 1's q-1."""
        return self.combines[-1] + self.preps[-1]


def q_123(p: int) -> int:
    """Theorem 1 round count: ceil(log2(p-1) + log2(4/3)) (p >= 2)."""
    if p <= 1:
        return 0
    if p == 2:
        return 1
    return math.ceil(math.log2(p - 1) + math.log2(4.0 / 3.0))


def rounds_1doubling(p: int) -> int:
    if p <= 1:
        return 0
    if p == 2:
        return 1
    return 1 + math.ceil(math.log2(p - 1))


def rounds_two_op(p: int) -> int:
    if p <= 1:
        return 0
    return math.ceil(math.log2(p))


def _block_params(p: int, depth: int) -> tuple[int, int, int]:
    """(t, rho, n_w) of the block-distributed exscan family.

    ``t`` is the effective halving depth (clamped to ⌊log₂p⌋), ``rho``
    the number of folded pairs (p mod 2^t), ``n_w`` the window count
    the mid-phase two-⊕ exscan runs over.
    """
    t = max(1, min(depth, p.bit_length() - 1))
    rho = p % (1 << t)
    return t, rho, (p - rho) >> t


def rounds_block(p: int, depth: int) -> int:
    """Closed-form round count of the block-distributed exscan family:
    (2 if p mod 2^t else 0) fold/unfold + 2t halving/doubling +
    ⌈log₂ n_w⌉ mid-phase rounds."""
    if p <= 1:
        return 0
    t, rho, n_w = _block_params(p, depth)
    return (2 if rho else 0) + 2 * t + rounds_two_op(n_w)


def rounds_halving(p: int) -> int:
    return rounds_block(p, 1)


def rounds_quartering(p: int) -> int:
    return rounds_block(p, 2)


def rounds_reduce_scatter(p: int) -> int:
    """Full vector-halving depth: 2⌈log₂p⌉ rounds at power-of-two p."""
    if p <= 1:
        return 0
    return rounds_block(p, p.bit_length())


def skips_123(p: int) -> list[int]:
    """The 123-doubling skip schedule s_0=1, s_1=2, s_k=3*2^(k-2)."""
    if p <= 1:
        return []
    if p == 2:
        return [1]
    skips = [1, 2]
    k = 2
    while 3 * (1 << (k - 2)) < p - 1:
        skips.append(3 * (1 << (k - 2)))
        k += 1
    return skips


def skips_1doubling(p: int) -> list[int]:
    if p <= 1:
        return []
    skips = [1]
    k = 1
    while (1 << (k - 1)) < p - 1:
        skips.append(1 << (k - 1))
        k += 1
    return skips


def skips_two_op(p: int) -> list[int]:
    if p <= 1:
        return []
    skips = [1]
    k = 1
    while (1 << k) < p:
        skips.append(1 << k)
        k += 1
    return skips


def _exscan_reference(inputs: Sequence[Any], op: Callable, identity: Any):
    """Sequential exclusive fold: out[r] = V_0 ⊕ … ⊕ V_{r-1}; out[0]=identity."""
    out = [identity]
    acc = None
    for v in inputs[:-1]:
        acc = v if acc is None else op(acc, v)
        out.append(acc)
    return out


def simulate_123(inputs: Sequence[Any], op: Callable, identity: Any):
    """Faithful rank-by-rank execution of the paper's Algorithm 1.

    Returns (results, ScheduleStats).  ``results[0]`` is ``identity``
    (the exclusive prefix of rank 0 is empty).
    """
    p = len(inputs)
    V = list(inputs)
    W: list[Any] = [identity] * p
    combines = [0] * p
    preps = [0] * p
    messages = 0
    if p <= 1:
        return W, ScheduleStats("123", p, 0, combines, preps, 0)

    # Round 0: skip 1 — rank r sends V_r to r+1, receives V_{r-1} into W.
    sent = {r: V[r] for r in range(p - 1)}
    for r in range(1, p):
        W[r] = sent[r - 1]  # copy, no ⊕
    messages += p - 1
    rounds = 1
    if p == 2:
        return W, ScheduleStats("123", p, rounds, combines, preps, messages)

    # Round 1: skip 2 — rank r sends W ⊕ V (rank 0 sends plain V), receiver
    # combines W ← T ⊕ W.  Rank 0 is done after this round.
    sent = {}
    for r in range(p - 2):
        if r == 0:
            sent[r] = V[r]  # rank 0 has no W; sends its input
        else:
            sent[r] = op(W[r], V[r])
            preps[r] += 1
        messages += 1
    recv = {r + 2: w for r, w in sent.items()}
    for r in range(2, p):
        W[r] = op(recv[r], W[r])
        combines[r] += 1
    rounds += 1

    # Rounds k >= 2: skip s_k = 3 * 2^(k-2); plain doubling on W.
    k = 2
    while True:
        s = 3 * (1 << (k - 2))
        if s >= p - 1:
            break
        sent = {}
        for r in range(1, p - s):  # rank 0 returned after round 1
            sent[r] = W[r]
            messages += 1
        for r in range(1 + s, p):
            f = r - s
            # paper: receive while 0 < f (rank already complete once f<=0)
            W[r] = op(sent[f], W[r])
            combines[r] += 1
        rounds += 1
        k += 1

    return W, ScheduleStats("123", p, rounds, combines, preps, messages)


def simulate_1doubling(inputs: Sequence[Any], op: Callable, identity: Any):
    """Shift + straight doubling on p-1 ranks (1-doubling)."""
    p = len(inputs)
    V = list(inputs)
    W: list[Any] = [identity] * p
    combines = [0] * p
    preps = [0] * p
    messages = 0
    if p <= 1:
        return W, ScheduleStats("1doubling", p, 0, combines, preps, 0)

    # Round 0: shift V to rank+1.
    for r in range(1, p):
        W[r] = V[r - 1]
    messages += p - 1
    rounds = 1

    # Rounds k >= 1: skip s_k = 2^(k-1); W ← W_{r-s} ⊕ W while r - s > 0.
    k = 1
    while True:
        s = 1 << (k - 1)
        if s >= p - 1:
            break
        sent = {r: W[r] for r in range(1, p - s)}
        messages += len(sent)
        for r in range(1 + s, p):
            W[r] = op(sent[r - s], W[r])
            combines[r] += 1
        rounds += 1
        k += 1

    return W, ScheduleStats("1doubling", p, rounds, combines, preps, messages)


def simulate_two_op(inputs: Sequence[Any], op: Callable, identity: Any):
    """Two-⊕ doubling: invariant W_r = ⊕_{max(0,r-s_k+1)}^{r-1}, s_k = 2^k."""
    p = len(inputs)
    V = list(inputs)
    W: list[Any] = [identity] * p
    combines = [0] * p
    preps = [0] * p
    messages = 0
    if p <= 1:
        return W, ScheduleStats("two_op", p, 0, combines, preps, 0)

    # Round 0 (k=0, skip 1): send V, receive-copy into W.
    for r in range(1, p):
        W[r] = V[r - 1]
    messages += p - 1
    rounds = 1

    k = 1
    while (1 << k) < p:
        s = 1 << k
        sent = {}
        for r in range(p - s):
            sent[r] = op(W[r], V[r]) if r >= 1 else V[r]
            if r >= 1:
                preps[r] += 1
            messages += 1
        for r in range(s, p):
            if r - s + 1 > 0:  # not yet complete
                W[r] = op(sent[r - s], W[r])
                combines[r] += 1
        rounds += 1
        k += 1

    return W, ScheduleStats("two_op", p, rounds, combines, preps, messages)


def simulate_inclusive(inputs: Sequence[Any], op: Callable, identity: Any):
    """Hillis-Steele inclusive scan (for completeness / tests)."""
    p = len(inputs)
    W = list(inputs)
    combines = [0] * p
    preps = [0] * p
    messages = 0
    rounds = 0
    k = 0
    while (1 << k) < p:
        s = 1 << k
        sent = {r: W[r] for r in range(p - s)}
        messages += len(sent)
        for r in range(s, p):
            W[r] = op(sent[r - s], W[r])
            combines[r] += 1
        rounds += 1
        k += 1
    return W, ScheduleStats("inclusive", p, rounds, combines, preps, messages)


SIMULATORS = {
    "123": simulate_123,
    "1doubling": simulate_1doubling,
    "two_op": simulate_two_op,
}


def verify(p: int, algorithm: str = "123") -> ScheduleStats:
    """Run a schedule on distinguishable inputs and assert correctness.

    Uses the free monoid (tuple concatenation) — the most discriminating
    associative operator: any reordering, duplication or omission of an
    input is detected, and commutativity is NOT assumed.
    """
    inputs = [(r,) for r in range(p)]
    op = lambda lo, hi: lo + hi
    identity = ()
    expect = _exscan_reference(inputs, op, identity)
    got, stats = SIMULATORS[algorithm](inputs, op, identity)
    assert got == expect, (
        f"{algorithm} p={p}: wrong result\n got={got}\n want={expect}"
    )
    return stats
