"""Round kernels of the scan executor: one round's masked ⊕ on the card.

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
into every rank without expanding it.

The tree-level entry points (:func:`tree_combine`, :func:`tree_exchange`,
:func:`tree_scan_reduce`, :func:`block_combine`) are the executor's ⊕
hooks, as in the JAX package: a round's same-dtype payload leaves are
concatenated along the row so each dtype group costs one launch.
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
        ins = (vp, vp, ll)
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
    return _leaves(x)[0].device.type == "cuda"


def _operand(x, p: int, n: int, dtype, device):
    """(ptr0, ptr1, rank_stride) of one (1 or p, n) operand."""
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
    return ptrs[0], ptrs[1], rs


def _geometry(op: str, operands, mask):
    first = _leaves(operands[0])[0]
    dtype, device = first.dtype, first.device
    if op not in _OP_CODES:
        raise ValueError(f"no round kernel for ⊕ {op!r}")
    if not kernel_serves(op, dtype):
        raise TypeError(f"no {op!r} round kernel instance at {dtype}")
    n = first.shape[-1]
    p = max(_leaves(x)[0].shape[0] for x in operands)
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
    """o = a⊕b; with ``mask``: keep[r] ? a⊕b : (``else_a`` ? a : b)."""
    if not _is_cuda(a):
        return combine_plain(op, a, b, mask=mask, else_a=else_a)
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
        return exchange_plain(op, r, w, low)
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
        return scan_reduce_plain(op, r, w, pf, low, commutative=commutative)
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
    so element j of a rank's row stays that rank's)."""
    flat = []
    treedef = None
    for t in trees:
        lv, td = _tree.flatten(t)
        if treedef is not None and td != treedef:
            raise ValueError(f"payload trees differ: {treedef} vs {td}")
        treedef = td
        flat.append(lv)
    n_leaves = len(flat[0])
    groups: dict = {}
    for i, leaf in enumerate(flat[0]):
        groups.setdefault(leaf.dtype, []).append(i)
    outs = [[None] * n_leaves for _ in range(n_out)]
    for idxs in groups.values():
        ins = []
        for lv in flat:
            rows = [_rows(lv[i]) for i in idxs]
            ins.append(rows[0] if len(rows) == 1 else torch.cat(rows, dim=1))
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


def _pair_out(like, rows, p: int):
    a, b = _flat_pair(like)
    out = tuple(r.reshape((p,) + tuple(t.shape[1:]))
                for r, t in zip(rows, (a, b)))
    return list(out) if isinstance(like, list) else out


def tree_combine(m, lo, hi, *, keep=None, else_lo: bool = False):
    """where(keep, lo ⊕ hi, else_lo ? lo : hi) over payload trees (plain
    ⊕ when ``keep`` is None), one launch per dtype group.  Returns None
    when the round kernels do not serve the monoid (matmul), or on the
    CPU the payload."""
    mask = _mask(keep)
    if m.leaf_op is not None:
        out, = _batched(
            lambda a, b: combine(m.name, a, b, mask=mask, else_a=else_lo),
            (lo, hi), 1)
        return out
    if m.name == "affine":
        pairs = _pairs(lo, hi)
        if pairs is None:
            return None
        plo, phi = pairs
        res = combine("affine", _pair_rows(plo), _pair_rows(phi), mask=mask,
                      else_a=else_lo)
        p = res[0].shape[0]
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
        pairs = _pairs(recv, w)
        if pairs is None:
            return None
        pr, pw = pairs
        res = exchange("affine", _pair_rows(pr), _pair_rows(pw), mask)
        return _pair_out(w, res, res[0].shape[0])
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
        pairs = _pairs(recv, w, prefix)
        if pairs is None:
            return None
        pr, pw, pp = pairs
        w2, p2 = scan_reduce("affine", _pair_rows(pr), _pair_rows(pw),
                             _pair_rows(pp), mask, commutative=False)
        p = w2[0].shape[0]
        return _pair_out(w, w2, p), _pair_out(prefix, p2, p)
    return None


def block_combine(a, b, op: str, *, keep=None):
    """a ⊕ b (or where(keep, a ⊕ b, b)) for one leaf: one launch, the
    unfused per-leaf baseline."""
    out = combine(op, _rows(a), _rows(b), mask=_mask(keep))
    p = out.shape[0]
    return out.reshape((p,) + tuple(a.shape[1:]))
