"""The port's scan kernels: the executor's round kernels and the
chunked-scan engine.

Round kernels: one round's masked ⊕ on the card.

On one card the p ranks of a schedule sit on a leading rank axis, so a
round's ⊕ is one pass over (p, n) rows with a per-rank int32 mask:

  * :func:`combine`      o = a⊕b, or keep[r] ? a⊕b : b (``else_a``: : a)
  * :func:`exchange`     o = low[r] ? r⊕w : w⊕r
  * :func:`scan_reduce`  w' = r⊕w (commutative) or low ? r⊕w : w⊕r,
                         p' = low ? r⊕p : p

each over the elementwise ⊕ (add, mul, max, min, xor) at int32, int64,
fp32, fp64 and bf16, and over the affine (a, b) pair at fp32 and fp64.
They are the CUDA kernels of ``csrc/round_kernels.cu`` and replace the
Pallas round bodies of the JAX package's ``kernels/scan_engine.py``
(``_combine_kernel`` :245, ``_masked_combine_kernel`` :249,
``_exchange_kernel`` :254, ``_scan_reduce_kernel`` :263 and the
``_affine_*`` twins :276-312, launched through ``_round_call`` :331).

Each wrapper launches its kernel for CUDA tensors, or raises; it runs
the plain PyTorch version (``*_plain``, same signature) only when the
tensors lie on the CPU.  ``launches`` on each wrapper counts the kernel
launches, and nothing else.  All three kernels are bound by bytes:
combine and exchange move 3·p·n·itemsize, scan_reduce 5·p·n·itemsize,
and the affine instances twice those.

An operand is a (1 or p, n) tensor (a tuple of two for affine); a
leading 1 broadcasts that row to every rank through a zero rank stride,
which is how the native algorithm's fold step combines one gathered row
into every rank without expanding it.  An operand may also be a
:class:`Rows`: rank r then reads row ``src[r]`` of it, or zeros where
``src[r] < 0``.  That is a round's peer exchange (a shift by ``skip``,
or the butterfly's r ^ skip) read in place by the kernel, instead of
gathered into a copy that the kernel then reads; on the CPU the
wrappers gather it (:func:`gather_rows`) and run the plain versions.

The tree-level entry points (:func:`tree_combine`, :func:`tree_exchange`,
:func:`tree_scan_reduce`, :func:`block_combine`) are the executor's ⊕
hooks, as in the JAX package: a round's same-dtype payload leaves are
concatenated along the row so each dtype group costs one launch.

The chunked-scan engine (``csrc/chunked_scan.cu``) replaces the JAX
package's Pallas ``chunked_scan`` (body ``_scan_body`` :109): a single
pass along the row axis of (T, D) or (G, T, D) operands.  Two kernels:

  * :func:`monoid_chunk`  an elementwise ⊕ scan, exclusive or inclusive,
                          from an init row or the identity
                          (:func:`monoid_exscan` is its exclusive use), in
                          one of two regimes (:func:`monoid_chunk_regime`):
                          A, a look-back scan over 4096-element tiles for
                          an integer ⊕ at D = 1; B, column strips streamed
                          through shared memory, each column folded left;
  * :func:`affine_chunk`  the affine recurrence h_t = a_t·h_{t-1} + b_t
                          with A_t = a_t·A_{t-1}
                          (:func:`affine_chunk_scan`,
                          :func:`affine_chunk_summary`);

and :func:`chunked_scan`, the JAX engine's general entry, over both.
The affine kernel keeps one thread per (group, column) with the carry
in a register.  Both are bound by bytes: each input is read once and
each output written once.  Their plain versions (``*_plain``) fold the
rows in order, so floats round exactly as the kernels do.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _tree
from repro_torch.core import monoid as monoid_lib

_OP_CODES = {"add": 0, "mul": 1, "max": 2, "min": 3, "xor": 4, "affine": 5}
_DT_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
             torch.float64: 3, torch.bfloat16: 4}
_INT_DTYPES = (torch.int32, torch.int64)
_FLOAT_DTYPES = (torch.float32, torch.float64)

PLAIN_OPS = {"add": torch.add, "mul": torch.mul, "max": torch.maximum,
             "min": torch.minimum, "xor": torch.bitwise_xor}


def leaf_identity(name: str, dtype: torch.dtype):
    """Identity scalar of an elementwise monoid at ``dtype``."""
    if name in ("add", "xor"):
        return 0
    if name == "mul":
        return 1
    if name in ("max", "min"):
        return monoid_lib.extreme(dtype, name == "max")
    raise KeyError(f"no identity scalar for monoid {name!r}")


def supports(m: monoid_lib.Monoid) -> bool:
    """Do the round kernels serve this monoid?  Elementwise monoids and
    the affine pair; matmul stays with ``torch.matmul``."""
    return m.leaf_op is not None or m.name == "affine"


def kernel_serves(op: str, dtype: torch.dtype) -> bool:
    """Is there a kernel instance for ⊕ ``op`` at ``dtype``?"""
    if op == "affine":
        return dtype in _FLOAT_DTYPES
    if op == "xor":
        return dtype in _INT_DTYPES
    return op in _OP_CODES and dtype in _DT_CODES


class Rows:
    """A round operand read through a row table: rank r reads row
    ``src[r]`` of ``tree`` (each leaf (p, ...)), or zeros where
    ``src[r] < 0``.  ``src`` is an int32 (p,) tensor on the payload's
    device with entries below p: on the card an entry of p or more
    stops the kernel (a device-side trap, as PyTorch's index asserts
    do), on the CPU the gather raises ``IndexError``."""

    __slots__ = ("tree", "src")

    def __init__(self, tree, src: torch.Tensor):
        self.tree = tree
        self.src = src


def gather_rows(x):
    """``x`` as the rows it reads: a :class:`Rows` becomes the gathered
    copy (``index_select``, then zeros where the table is negative);
    anything else is returned as it is."""
    if not isinstance(x, Rows):
        return x
    src = x.src.long()
    idx, zero = src.clamp(min=0), src < 0

    def one(t):
        out = t.index_select(0, idx)
        return out.masked_fill_(zero.view((-1,) + (1,) * (out.dim() - 1)), 0)

    return _tree.tree_map(one, x.tree)


def _unrows(x):
    """(tree, row table or None) of an operand."""
    return (x.tree, x.src) if isinstance(x, Rows) else (x, None)


def _rerows(x, src):
    return x if src is None else Rows(x, src)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path; the card's yardstick of equality)
# ---------------------------------------------------------------------------


def _op_fn(op: str):
    if op == "affine":
        return monoid_lib.affine_combine
    return PLAIN_OPS[op]


def _where(cond, x, y):
    if isinstance(x, tuple):
        return tuple(torch.where(cond, a, b) for a, b in zip(x, y))
    return torch.where(cond, x, y)


def _cond(mask):
    return (mask != 0).view(-1, 1)


def combine_plain(op: str, a, b, *, mask=None, else_a: bool = False):
    c = _op_fn(op)(a, b)
    if mask is None:
        return c
    return _where(_cond(mask), c, a if else_a else b)


def exchange_plain(op: str, r, w, low):
    f = _op_fn(op)
    return _where(_cond(low), f(r, w), f(w, r))


def scan_reduce_plain(op: str, r, w, pf, low, *, commutative: bool):
    f = _op_fn(op)
    cond = _cond(low)
    new_w = f(r, w) if commutative else _where(cond, f(r, w), f(w, r))
    return new_w, _where(cond, f(r, pf), pf)


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels import _build

        lib = _build.load("round_kernels")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ins = (vp, vp, ll, vp)  # leaf0, leaf1, row stride, row table
        lib.rk_combine.argtypes = ((ci, ci) + ins * 2
                                   + (vp, vp, vp, ci, ll, ll, vp))
        lib.rk_exchange.argtypes = ((ci, ci) + ins * 2
                                    + (vp, vp, vp, ll, ll, vp))
        lib.rk_scan_reduce.argtypes = ((ci, ci) + ins * 3
                                       + (vp, vp, vp, vp, vp, ci, ll, ll, vp))
        for fn in (lib.rk_combine, lib.rk_exchange, lib.rk_scan_reduce):
            fn.restype = ci
        _lib_handle = lib
    return _lib_handle


def _leaves(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _is_cuda(x) -> bool:
    return _leaves(_unrows(x)[0])[0].device.type == "cuda"


def _operand(x, p: int, n: int, dtype, device):
    """(ptr0, ptr1, rank_stride, row table) of one (1 or p, n) operand,
    or of a :class:`Rows` over a (p, n) one."""
    x, src = _unrows(x)
    if src is not None and (
            src.dtype != torch.int32 or src.device != device
            or tuple(src.shape) != (p,) or not src.is_contiguous()
            or _leaves(x)[0].shape[0] != p):
        raise ValueError(f"a row table must be a contiguous int32 ({p},) "
                         f"tensor on {device} over ({p}, {n}) rows")
    ptrs = []
    rs = None
    for t in _leaves(x):
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"operand {t.dtype}@{t.device} does not match "
                             f"{dtype}@{device}")
        if t.dim() != 2 or t.shape[1] != n or t.shape[0] not in (1, p):
            raise ValueError(f"operand shape {tuple(t.shape)} is not "
                             f"({p} or 1, {n})")
        if n > 1 and t.stride(1) != 1:
            raise ValueError("operand rows must be contiguous")
        stride = 0 if (t.shape[0] == 1 and p > 1) else t.stride(0)
        if rs is not None and stride != rs:
            raise ValueError("affine leaves must share one rank stride")
        rs = stride
        ptrs.append(t.data_ptr())
    if len(ptrs) == 1:
        ptrs.append(None)
    return ptrs[0], ptrs[1], rs, _ptr(src)


def _rank_rows(x) -> int:
    x, src = _unrows(x)
    return _leaves(x)[0].shape[0] if src is None else src.shape[0]


def _geometry(op: str, operands, mask):
    first = _leaves(_unrows(operands[0])[0])[0]
    dtype, device = first.dtype, first.device
    if op not in _OP_CODES:
        raise ValueError(f"no round kernel for ⊕ {op!r}")
    if not kernel_serves(op, dtype):
        raise TypeError(f"no {op!r} round kernel instance at {dtype}")
    n = first.shape[-1]
    p = max(_rank_rows(x) for x in operands)
    if mask is not None:
        if (mask.dtype != torch.int32 or mask.device != device
                or tuple(mask.shape) != (p,) or not mask.is_contiguous()):
            raise ValueError(f"mask must be a contiguous int32 ({p},) "
                             f"tensor on {device}")
    return dtype, device, p, n


def _new_out(op: str, p: int, n: int, dtype, device):
    leaves = tuple(torch.empty((p, n), dtype=dtype, device=device)
                   for _ in range(2 if op == "affine" else 1))
    return leaves, [t.data_ptr() for t in leaves] + [None] * (2 - len(leaves))


def _check(rc: int, name: str):
    if rc:
        raise RuntimeError(f"round kernel {name} failed with code {rc}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _wrap(op: str, leaves):
    return leaves if op == "affine" else leaves[0]


def combine(op: str, a, b, *, mask=None, else_a: bool = False):
    """o = a⊕b; with ``mask``: keep[r] ? a⊕b : (``else_a`` ? a : b).
    ``a`` and ``b`` may be :class:`Rows`."""
    if not _is_cuda(a):
        return combine_plain(op, gather_rows(a), gather_rows(b), mask=mask,
                             else_a=else_a)
    dtype, device, p, n = _geometry(op, (a, b), mask)
    outs, optr = _new_out(op, p, n, dtype, device)
    rc = _lib().rk_combine(
        _OP_CODES[op], _DT_CODES[dtype], *_operand(a, p, n, dtype, device),
        *_operand(b, p, n, dtype, device), *optr,
        None if mask is None else mask.data_ptr(), int(else_a), p, n,
        _stream(device))
    _check(rc, "combine")
    combine.launches += 1
    _count_op(combine, op)
    return _wrap(op, outs)


def exchange(op: str, r, w, low):
    """o = low[r] ? r⊕w : w⊕r (one butterfly round, both orders)."""
    if not _is_cuda(r):
        return exchange_plain(op, gather_rows(r), gather_rows(w), low)
    dtype, device, p, n = _geometry(op, (r, w), low)
    outs, optr = _new_out(op, p, n, dtype, device)
    rc = _lib().rk_exchange(
        _OP_CODES[op], _DT_CODES[dtype], *_operand(r, p, n, dtype, device),
        *_operand(w, p, n, dtype, device), *optr, low.data_ptr(), p, n,
        _stream(device))
    _check(rc, "exchange")
    exchange.launches += 1
    _count_op(exchange, op)
    return _wrap(op, outs)


def scan_reduce(op: str, r, w, pf, low, *, commutative: bool):
    """The fused exscan+allreduce round: returns (w', p')."""
    if not _is_cuda(r):
        return scan_reduce_plain(op, gather_rows(r), gather_rows(w),
                                 gather_rows(pf), low,
                                 commutative=commutative)
    dtype, device, p, n = _geometry(op, (r, w, pf), low)
    w_outs, wptr = _new_out(op, p, n, dtype, device)
    p_outs, pptr = _new_out(op, p, n, dtype, device)
    rc = _lib().rk_scan_reduce(
        _OP_CODES[op], _DT_CODES[dtype], *_operand(r, p, n, dtype, device),
        *_operand(w, p, n, dtype, device), *_operand(pf, p, n, dtype, device),
        *wptr, *pptr, low.data_ptr(), int(commutative), p, n,
        _stream(device))
    _check(rc, "scan_reduce")
    scan_reduce.launches += 1
    _count_op(scan_reduce, op)
    return _wrap(op, w_outs), _wrap(op, p_outs)


KERNELS = {"combine": combine, "exchange": exchange,
           "scan_reduce": scan_reduce}


def _count_op(fn, op: str) -> None:
    fn.launches_by_op[op] = fn.launches_by_op.get(op, 0) + 1


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches`` and ``launches_by_op`` (the
    same launches split by ⊕, so the affine instances read apart)."""
    for fn in KERNELS.values():
        fn.launches = 0
        fn.launches_by_op = {}


reset_launch_counts()


# ---------------------------------------------------------------------------
# Tree-level ⊕ hooks: a round's payload leaves, one launch per dtype group
# ---------------------------------------------------------------------------


def _rows(t):
    """(lead, -1) row view of a leaf whose leading axis is the rank."""
    lead = t.shape[0] if t.dim() else 1
    v = t.reshape(lead, -1)
    if v.shape[1] > 1 and v.stride(1) != 1:
        v = v.contiguous()
    return v


def _mask(keep):
    if keep is None or keep.dtype == torch.int32:
        return keep
    return keep.to(torch.int32)


def _batched(launch, trees, n_out: int):
    """Run an elementwise kernel over every leaf of ``trees``; all the
    leaves of one dtype share one launch (concatenated along the row,
    so element j of a rank's row stays that rank's).  A :class:`Rows`
    tree passes its row table on with each group."""
    flat, srcs = [], []
    treedef = None
    for t in trees:
        t, src = _unrows(t)
        lv, td = _tree.flatten(t)
        if treedef is not None and td != treedef:
            raise ValueError(f"payload trees differ: {treedef} vs {td}")
        treedef = td
        flat.append(lv)
        srcs.append(src)
    n_leaves = len(flat[0])
    groups: dict = {}
    for i, leaf in enumerate(flat[0]):
        groups.setdefault(leaf.dtype, []).append(i)
    outs = [[None] * n_leaves for _ in range(n_out)]
    for idxs in groups.values():
        ins = []
        for lv, src in zip(flat, srcs):
            rows = [_rows(lv[i]) for i in idxs]
            ins.append(_rerows(
                rows[0] if len(rows) == 1 else torch.cat(rows, dim=1), src))
        res = launch(*ins)
        res = res if isinstance(res, tuple) else (res,)
        p = res[0].shape[0]
        sizes = [_rows(flat[0][i]).shape[1] for i in idxs]
        for k, buf in enumerate(res):
            parts = torch.split(buf, sizes, dim=1) if len(idxs) > 1 \
                else (buf,)
            for i, part in zip(idxs, parts):
                shape = (p,) + tuple(flat[0][i].shape[1:])
                outs[k][i] = part.reshape(shape)
    return tuple(_tree.unflatten(treedef, o) for o in outs)


def _flat_pair(tree):
    """The affine payload the kernels serve: an (a, b) pair of tensors
    of one shape and dtype.  Returns (a, b) or None."""
    if isinstance(tree, (tuple, list)) and len(tree) == 2:
        a, b = tree
        if (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype):
            return a, b
    return None


def _pairs(*trees):
    """The flat (a, b) pairs of ``trees``, or None where one is not such
    a pair (the executor then applies ⊕ itself) — on the CPU only: on
    the card an affine payload the kernels do not serve raises."""
    pairs = [_flat_pair(t) for t in trees]
    if all(pr is not None for pr in pairs):
        return pairs
    if any(t.device.type == "cuda" for t in _tree.leaves(trees)):
        raise TypeError("the affine round kernels take an (a, b) pair of "
                        "tensors of one shape and dtype")
    return None


def _pair_rows(pair):
    """(a, b) as row views; the kernels read both leaves with one rank
    stride, so leaves whose views disagree are made contiguous."""
    rows = tuple(_rows(t) for t in pair)
    if rows[0].stride(0) != rows[1].stride(0):
        rows = tuple(r.contiguous() for r in rows)
    return rows


def _affine_operands(*trees):
    """Each tree's (a, b) rows as the kernels take them, with its row
    table where it is a :class:`Rows`; None as :func:`_pairs` says."""
    split = [_unrows(t) for t in trees]
    pairs = _pairs(*(t for t, _ in split))
    if pairs is None:
        return None
    return [_rerows(_pair_rows(pr), src) for pr, (_, src) in zip(pairs, split)]


def _pair_out(like, rows, p: int):
    a, b = _flat_pair(like)
    out = tuple(r.reshape((p,) + tuple(t.shape[1:]))
                for r, t in zip(rows, (a, b)))
    return list(out) if isinstance(like, list) else out


def tree_combine(m, lo, hi, *, keep=None, else_lo: bool = False):
    """where(keep, lo ⊕ hi, else_lo ? lo : hi) over payload trees (plain
    ⊕ when ``keep`` is None), one launch per dtype group; either tree
    may be a :class:`Rows`.  Returns None when the round kernels do not
    serve the monoid (matmul), or on the CPU the payload."""
    mask = _mask(keep)
    if m.leaf_op is not None:
        out, = _batched(
            lambda a, b: combine(m.name, a, b, mask=mask, else_a=else_lo),
            (lo, hi), 1)
        return out
    if m.name == "affine":
        ops = _affine_operands(lo, hi)
        if ops is None:
            return None
        res = combine("affine", *ops, mask=mask, else_a=else_lo)
        p = res[0].shape[0]
        lo, hi = _unrows(lo)[0], _unrows(hi)[0]
        return _pair_out(hi if hi[0].shape[0] == p else lo, res, p)
    return None


def tree_exchange(m, recv, w, low):
    """Non-commutative butterfly update: low ? recv⊕w : w⊕recv."""
    mask = _mask(low)
    if m.leaf_op is not None:
        out, = _batched(lambda r, x: exchange(m.name, r, x, mask),
                        (recv, w), 1)
        return out
    if m.name == "affine":
        ops = _affine_operands(recv, w)
        if ops is None:
            return None
        res = exchange("affine", *ops, mask)
        return _pair_out(_unrows(w)[0], res, res[0].shape[0])
    return None


def tree_scan_reduce(m, recv, w, prefix, low):
    """The fused exscan+allreduce round: returns (w', prefix')."""
    mask = _mask(low)
    if m.leaf_op is not None:
        return _batched(
            lambda r, x, pf: scan_reduce(m.name, r, x, pf, mask,
                                         commutative=m.commutative),
            (recv, w, prefix), 2)
    if m.name == "affine":
        ops = _affine_operands(recv, w, prefix)
        if ops is None:
            return None
        w2, p2 = scan_reduce("affine", *ops, mask, commutative=False)
        p = w2[0].shape[0]
        return (_pair_out(_unrows(w)[0], w2, p),
                _pair_out(_unrows(prefix)[0], p2, p))
    return None


def block_combine(a, b, op: str, *, keep=None):
    """a ⊕ b (or where(keep, a ⊕ b, b)) for one leaf: one launch, the
    unfused per-leaf baseline."""
    out = combine(op, _rows(a), _rows(b), mask=_mask(keep))
    p = out.shape[0]
    return out.reshape((p,) + tuple(a.shape[1:]))


# ---------------------------------------------------------------------------
# The chunked-scan engine: one pass along the row axis
# ---------------------------------------------------------------------------
#
# A (T, D) operand is one group; a (G, T, D) operand is G groups scanned
# apart in one launch (on the stacked paths G is ranks × batch).  Final
# rows and init rows are (G, D), so (1, D) for a (T, D) operand, as in
# the JAX package.  Operands must be contiguous.


_chunk_handle = None


def _chunk_lib():
    global _chunk_handle
    if _chunk_handle is None:
        from repro_torch.kernels import _build

        lib = _build.load("chunked_scan")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.cs_monoid.argtypes = (ci, ci, ci, vp, vp, vp, vp, ci, ll, ll,
                                  ll, vp, vp)
        lib.cs_monoid_scratch_bytes.argtypes = (ci, ll, ll, ll)
        lib.cs_monoid_scratch_bytes.restype = ll
        lib.cs_affine.argtypes = ((ci,) + (vp,) * 8 + (ci, ll, ll, ll, vp))
        for fn in (lib.cs_monoid, lib.cs_affine):
            fn.restype = ci
        _chunk_handle = lib
    return _chunk_handle


def _groups(x: torch.Tensor) -> torch.Tensor:
    """The (G, T, D) view of a (T, D) or (G, T, D) operand."""
    if x.dim() == 2:
        return x.unsqueeze(0)
    if x.dim() == 3:
        return x
    raise ValueError(f"chunked scan operand must be (T, D) or (G, T, D), "
                     f"got {tuple(x.shape)}")


def _row(r, G: int, D: int, like: torch.Tensor, what: str):
    """An init row as a (G, D) tensor of ``like``'s dtype and device."""
    if r is None:
        return None
    if r.dtype != like.dtype or r.device != like.device \
            or r.numel() != G * D:
        raise ValueError(f"{what} must hold {G}x{D} {like.dtype} on "
                         f"{like.device}, got {tuple(r.shape)} {r.dtype} "
                         f"on {r.device}")
    return r.reshape(G, D)


def _chunk_operands(xs, rows, what):
    g = [_groups(x) for x in xs]
    G, T, D = g[0].shape
    for x in g:
        if x.shape != g[0].shape or x.dtype != g[0].dtype \
                or x.device != g[0].device:
            raise ValueError(f"{what} operands differ in shape, dtype or "
                             f"device")
    r = [_row(v, G, D, g[0], f"{what} init") for v in rows]
    return g, r, (G, T, D)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _contiguous(ts, what: str):
    for t in ts:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what} operands must be contiguous")


def _empty_or_none(want: bool, shape, like):
    return torch.empty(shape, dtype=like.dtype, device=like.device) \
        if want else None


def _doubling_scan(f, x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of (G, T, D) along T by recursive doubling: exact
    for the integer monoids, whose ⊕ is associative bit for bit."""
    k = 1
    while k < x.shape[1]:
        x = torch.cat([x[:, :k], f(x[:, :-k], x[:, k:])], dim=1)
        k *= 2
    return x


def monoid_chunk_plain(x, op: str, *, init=None, exclusive: bool = True,
                       traj: bool = True, final: bool = False):
    """The plain version of :func:`monoid_chunk`: a left fold over the
    rows for floats (the order fixes the rounding), recursive doubling
    for integers (exact in any order)."""
    (g,), (carry,), (G, T, D) = _chunk_operands((x,), (init,), "monoid")
    f = PLAIN_OPS[op]
    if carry is None:
        carry = torch.full((G, D), leaf_identity(op, g.dtype),
                           dtype=g.dtype, device=g.device)
    if T == 0:
        out = g.clone()
    elif g.dtype.is_floating_point:
        rows = []
        for t in range(T):
            nxt = f(carry, g[:, t])
            rows.append(carry if exclusive else nxt)
            carry = nxt
        out = torch.stack(rows, dim=1)
    else:
        incl = f(carry.unsqueeze(1), _doubling_scan(f, g))
        out = (torch.cat([carry.unsqueeze(1), incl[:, :-1]], dim=1)
               if exclusive else incl)
        carry = incl[:, -1]
    return (out.reshape(x.shape) if traj else None,
            carry.clone() if final else None)


_REGIME_CODES = {"A": 0, "B": 1}


def monoid_chunk_regime(op: str, dtype: torch.dtype, D: int) -> str:
    """The design :func:`monoid_chunk` runs on the card for ⊕ ``op`` at
    ``dtype`` over rows of ``D`` columns: "A", the single-pass look-back
    scan, for an integer ⊕ at D = 1 (these ⊕ wrap exactly, so any
    association is bit-identical to the left fold); "B", the column
    strips streamed through shared memory and folded left, for every
    float ⊕ and every D >= 2 (float max/min stay here: max(+0, -0)
    depends on the operand order)."""
    return "A" if (D == 1 and dtype in _INT_DTYPES and op in PLAIN_OPS) \
        else "B"


def monoid_chunk(x, op: str, *, init=None, exclusive: bool = True,
                 traj: bool = True, final: bool = False):
    """Scan ``x`` along its row axis under the elementwise ⊕ ``op``,
    from ``init`` (the identity when None).  Returns (trajectory or
    None, final rows or None); ``exclusive`` writes the carry before
    each row is folded in, else after.  One launch, in the regime
    :func:`monoid_chunk_regime` names."""
    if not x.is_cuda:
        return monoid_chunk_plain(x, op, init=init, exclusive=exclusive,
                                  traj=traj, final=final)
    if op not in PLAIN_OPS or not kernel_serves(op, x.dtype):
        raise TypeError(f"no monoid_chunk kernel for ⊕ {op!r} at {x.dtype}")
    (g,), (r,), (G, T, D) = _chunk_operands((x,), (init,), "monoid")
    _contiguous((g, r), "monoid_chunk")
    out = _empty_or_none(traj, g.shape, g)
    fin = _empty_or_none(final, (G, D), g)
    lib = _chunk_lib()
    regime = _REGIME_CODES[monoid_chunk_regime(op, g.dtype, D)]
    nbytes = lib.cs_monoid_scratch_bytes(regime, G, T, D)
    scratch = (torch.zeros(nbytes, dtype=torch.uint8, device=g.device)
               if nbytes else None)  # the look-back's tile counter, status
    rc = lib.cs_monoid(
        _OP_CODES[op], _DT_CODES[g.dtype], regime, g.data_ptr(), _ptr(r),
        _ptr(out), _ptr(fin), int(exclusive), G, T, D, _ptr(scratch),
        _stream(g.device))
    _check(rc, "monoid_chunk")
    monoid_chunk.launches += 1
    _count_op(monoid_chunk, op)
    return (None if out is None else out.reshape(x.shape)), fin


def affine_chunk_plain(a, b, *, a0=None, h0=None, exclusive: bool = False,
                       a_traj: bool = False, h_traj: bool = True,
                       a_final: bool = False, h_final: bool = False):
    """The plain version of :func:`affine_chunk`: a loop over the rows,
    the product and the sum rounded apart."""
    (ga, gb), (A, h), (G, T, D) = _chunk_operands((a, b), (a0, h0),
                                                  "affine")
    A = torch.ones((G, D), dtype=ga.dtype, device=ga.device) \
        if A is None else A
    h = torch.zeros((G, D), dtype=ga.dtype, device=ga.device) \
        if h is None else h
    a_rows, h_rows = [], []
    for t in range(T):
        at = ga[:, t]
        if exclusive:
            a_rows.append(A)
            h_rows.append(h)
        h = at * h + gb[:, t]
        A = at * A
        if not exclusive:
            a_rows.append(A)
            h_rows.append(h)

    def stacked(rows):
        return (torch.stack(rows, dim=1) if rows
                else torch.empty_like(ga)).reshape(a.shape)

    return (stacked(a_rows) if a_traj else None,
            stacked(h_rows) if h_traj else None,
            A.clone() if a_final else None, h.clone() if h_final else None)


def affine_chunk(a, b, *, a0=None, h0=None, exclusive: bool = False,
                 a_traj: bool = False, h_traj: bool = True,
                 a_final: bool = False, h_final: bool = False):
    """Scan the affine pairs (a_t, b_t) along the row axis from the
    carry (a0, h0) (the identity (1, 0) where None): h_t = a_t·h_{t-1}
    + b_t and A_t = a_t·A_{t-1}.  Returns (A trajectory, h trajectory,
    A final, h final), each None unless asked for."""
    if not a.is_cuda:
        return affine_chunk_plain(
            a, b, a0=a0, h0=h0, exclusive=exclusive, a_traj=a_traj,
            h_traj=h_traj, a_final=a_final, h_final=h_final)
    if not kernel_serves("affine", a.dtype):
        raise TypeError(f"no affine_chunk kernel at {a.dtype}")
    (ga, gb), (ra, rh), (G, T, D) = _chunk_operands((a, b), (a0, h0),
                                                    "affine")
    _contiguous((ga, gb, ra, rh), "affine_chunk")
    outs = (_empty_or_none(a_traj, ga.shape, ga),
            _empty_or_none(h_traj, ga.shape, ga),
            _empty_or_none(a_final, (G, D), ga),
            _empty_or_none(h_final, (G, D), ga))
    rc = _chunk_lib().cs_affine(
        _DT_CODES[ga.dtype], ga.data_ptr(), gb.data_ptr(), _ptr(ra),
        _ptr(rh), *(_ptr(o) for o in outs), int(exclusive), G, T, D,
        _stream(ga.device))
    _check(rc, "affine_chunk")
    affine_chunk.launches += 1
    _count_op(affine_chunk, "affine")
    a_out, h_out, a_fin, h_fin = outs
    return (None if a_out is None else a_out.reshape(a.shape),
            None if h_out is None else h_out.reshape(a.shape), a_fin, h_fin)


KERNELS.update(monoid_chunk=monoid_chunk, affine_chunk=affine_chunk)
reset_launch_counts()


def chunked_scan(xs, init, monoid, *, exclusive: bool = False,
                 traj=(0,), final=()):
    """Single-pass scan along the row axis of a leaf tuple ``xs`` under
    an elementwise monoid (one leaf) or affine ((a, b)), from the carry
    ``init`` (one row per leaf and group).  ``traj`` selects the leaves
    whose trajectories are returned, ``final`` the leaves whose last
    carries come back as (G, D) rows.  Returns (trajectories, finals),
    as the JAX package's ``chunked_scan``."""
    m = monoid_lib.get(monoid)
    if m.leaf_op is not None:
        (x,), (r,) = xs, init
        out, fin = monoid_chunk(x, m.name, init=r, exclusive=exclusive,
                                traj=0 in traj, final=0 in final)
        trajs, fins = (out,), (fin,)
    elif m.name == "affine":
        (a, b), (a0, h0) = xs, init
        a_out, h_out, a_fin, h_fin = affine_chunk(
            a, b, a0=a0, h0=h0, exclusive=exclusive, a_traj=0 in traj,
            h_traj=1 in traj, a_final=0 in final, h_final=1 in final)
        trajs, fins = (a_out, h_out), (a_fin, h_fin)
    else:
        raise ValueError(f"monoid {m.name!r} has no chunked-scan kernel")
    return tuple(trajs[j] for j in traj), tuple(fins[j] for j in final)


def monoid_exscan(x, monoid: str = "add"):
    """Exclusive scan of (T, D) or (G, T, D) rows under an elementwise
    monoid: row 0 is the identity, row t the ⊕ of rows [0, t)."""
    m = monoid_lib.get(monoid)
    if m.leaf_op is None:
        raise ValueError(f"monoid {monoid!r} is not elementwise")
    out, _ = monoid_chunk(x, m.name, exclusive=True)
    return out


def affine_chunk_scan(a, b, h0):
    """h_t = a_t·h_{t-1} + b_t from ``h0`` ((1, D), or (G, D) for
    (G, T, D) operands).  Returns (h, h_final (G, D))."""
    _, h, _, h_fin = affine_chunk(a, b, h0=h0, h_final=True)
    return h, h_fin


def affine_chunk_summary(a, b):
    """The whole slice's affine summary (A_total, B_total), each (G, D):
    h_out = A_total·h_in + B_total, in one pass."""
    _, _, a_tot, b_tot = affine_chunk(a, b, h_traj=False, a_final=True,
                                      h_final=True)
    return a_tot, b_tot
