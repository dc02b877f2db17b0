"""The parts of a model's split leaves that one program computes, and
how their partials meet (``params.plan_split``'s split over "model").

The layers loop over ``shards.ids``: each id's part of a split leaf
(``of``) and of a split cache (``cache_of``: attention's k and v,
RWKV6's state, Mamba's conv and h) gives that model rank's product, a
row-split product's partials are summed by ``reduce`` and the
vocabulary's columns joined by ``gather``.

- :data:`WHOLE`: one part, the leaf whole; ``reduce`` and ``gather``
  return it.  Every layer the split does not cover, and every model
  with no split (one "model" rank, a training or a meta tree).
- :class:`ProcessShards`: process k of a (data, model) grid, model rank
  j = k mod tp, holding its part (``params.shard_params``); ``reduce``
  is ``SPMDExecutor.all_reduce`` over "model", ``gather`` its
  all-gather.
- :class:`StackedShards`: all tp parts in one program, each split leaf
  and cache holding them stacked on a leading axis
  (``params.stack_parts``), part j contiguous as process j holds it,
  so each part's products have that process's shapes and strides;
  ``reduce`` sums the partials in the all-reduce's order
  (``schedule.sum_in_order``) and ``gather`` joins them in rank order.
  Its bits are then the processes'.

Over "data" a process holds a slice of each leaf's "embed" dim
(``params.data_cuts``, FSDP), and :func:`gather_data` gives a layer its
leaves back whole over "data", as the model ranks' parts above read
them, in one all-gather; one program holding every data rank holds the
leaves whole and gathers nothing.

Under decode_ws the weights stay sliced over "data" and the activations'
d is split instead (``DSlices``): ``WHOLE_D`` is one slice, the plain
computation of every other strategy; :class:`ProcessSlice` a process's
d-slice, each product from d reduced over "data"; :class:`StackedSlices`
every slice in one program, reduced in the same order, so its bits are
the processes'.  The layers take it as ``dsl`` beside ``shards``.

Under autograd (training over processes) the split has its backward,
the tensor-parallel pair: ``enter`` marks where a split layer reads the
replicated stream (identity forward; the input's gradient, of which
each model process holds its part's share, all-reduced over "model"
backward), ``reduce`` is the "leave" (all-reduce forward, identity
backward: every model process holds the whole gradient of the sum) and
``gather``'s backward takes the process's own columns.  Between an
enter and a leave a model process computes its part alone; elsewhere
the model processes compute alike, and so do the gradients of the
leaves they hold whole.  :func:`gather_data`'s backward is one
reduce-scatter over "data" a bucket: each data process computes on its
own rows, so each holds a part of a gathered leaf's gradient, and its
slice's gradient is their sum.  ``WHOLE`` and ``StackedShards`` enter
as the identity.
"""

from __future__ import annotations

import torch

from repro_torch.core.schedule import sum_in_order
from repro_torch.models.common import swiglu


class Shards:
    """One part, the leaf whole (:data:`WHOLE`)."""

    ids: tuple = (0,)
    stacked = False  # the leaves and caches hold their parts stacked

    def of(self, p: dict, name: str, j: int) -> torch.Tensor:
        """Part j of leaf ``p[name]`` (a layer's or the top's)."""
        return p[name][j] if self.stacked else p[name]

    def cache_of(self, c: torch.Tensor, j: int) -> torch.Tensor:
        """Part j of a split cache, a view written in place."""
        return c[j] if self.stacked else c

    def enter(self, *xs: torch.Tensor):
        """``xs`` as the parts read them (one tensor, or a tuple)."""
        return xs[0] if len(xs) == 1 else xs

    def reduce(self, parts: list) -> torch.Tensor:
        """The sum of the parts' partials."""
        return parts[0]

    def gather(self, parts: list) -> torch.Tensor:
        """The parts side by side on the last dim, in rank order."""
        return parts[0]

    def swiglu(self, x, p: dict, gate: str, up: str, down: str,
               dsl=None):
        """``common.swiglu`` over the parts (columns of gate and up, rows
        of down), the partials reduced; ``dsl`` (a :class:`DSlices`) as
        the activations hold d."""
        x = self.enter(x)
        return self.reduce([swiglu(x, self.of(p, gate, j), self.of(p, up, j),
                                   self.of(p, down, j), dsl)
                            for j in self.ids])


WHOLE = Shards()


class ProcessShards(Shards):
    """Model rank j's part, held by this process of ``executor``."""

    def __init__(self, executor, j: int):
        self.ex, self.ids = executor, (j,)

    def enter(self, *xs: torch.Tensor):
        return self.ex.enter(*xs, axis="model")

    def reduce(self, parts: list) -> torch.Tensor:
        return self.ex.all_reduce(parts[0], "model")

    def gather(self, parts: list) -> torch.Tensor:
        return torch.cat(self.ex.all_gather(parts[0], "model").unbind(0),
                         dim=-1)


class StackedShards(Shards):
    """All ``tp`` parts, stacked in the leaves and caches."""

    stacked = True

    def __init__(self, tp: int):
        self.ids = tuple(range(tp))

    def reduce(self, parts: list) -> torch.Tensor:
        return sum_in_order(torch.stack(parts))

    def gather(self, parts: list) -> torch.Tensor:
        return torch.cat(parts, dim=-1)


def gather_data(ex, p: dict, dims: dict, axis: str | None = "data") -> dict:
    """``p`` (a layer's or the top's leaves) with each leaf named in
    ``dims`` (its data-cut dim) gathered over the processes along
    ``axis`` of ``ex`` ("data"; None, every process, for fsdp_sp's FSDP
    over the whole grid, ``params.fsdp_axis``): the slices go out as
    ONE flat bucket (``SPMDExecutor.
    all_gather``, counted as "fsdp_gather"; one collective a layer,
    since a collective's fixed cost dominates a slice's bytes), and each
    leaf is rebuilt, contiguous, by joining the n slices along its dim
    in data order.  Exact: the gathered leaf is the whole leaf's bits.
    The result holds the gathered leaves until the caller drops it.
    The leaves share one dtype (a config's).  Under autograd the
    backward is the transpose: ONE reduce-scatter of the bucket's
    gradient over the same processes (counted as "fsdp_scatter"), each
    process's slices summed over them in their order."""
    names = [k for k in dims if k in p]
    if not names:
        return p
    flat = torch.cat([p[k].reshape(-1) for k in names])
    got = ex.all_gather(flat, axis, kind="fsdp_gather",
                        scatter="fsdp_scatter")
    del flat
    n = got.shape[0]
    out = dict(p)
    off = 0
    for k in names:
        v, dim = p[k], dims[k]
        parts = got[:, off:off + v.numel()].reshape(n, *v.shape)
        shape = (*v.shape[:dim], n * v.shape[dim], *v.shape[dim + 1:])
        out[k] = parts.movedim(0, dim).reshape(shape).contiguous()
        off += v.numel()
    return out


class DSlices:
    """d over "data", one slice: the activations whole in d.  Every
    strategy but decode_ws, and decode_ws where one data rank holds the
    whole of d (:data:`WHOLE_D`): each method is the plain computation,
    so those paths keep their bits."""

    n = 1
    ids: tuple = (0,)

    def chan(self, t: torch.Tensor) -> torch.Tensor:
        """A (..., d) tensor whole in d (a norm's scale, a token shift's
        μ, a product summed over "data") as the activations hold d."""
        return t

    def dots(self, pairs: list) -> list:
        """``x @ w`` for each (x, w) of ``pairs``, each x the
        activations (..., d) and w (d, N); a pair (x, w, True) takes w
        stored as (N, d) and multiplies by its transpose."""
        return [pr[0] @ (pr[1].T if len(pr) > 2 else pr[1]) for pr in pairs]

    def out(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``h @ w``, w (N, d): a product into d, as the activations
        hold d."""
        return h @ w

    def sum_sq(self, x32: torch.Tensor) -> torch.Tensor:
        """Σ x² over the whole of d, keepdim, fp32."""
        return torch.sum(x32 * x32, dim=-1, keepdim=True)

    def blocks(self, B: int) -> list:
        """The row ranges [lo, hi) of a batch of B that this program
        runs a mixer's core on (attention's, the wkv scan, Mamba's conv
        and scan), each against the rows of the cache it holds."""
        return [(0, B)]

    def rows_of(self, c: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """The cache rows [lo, hi) of a mixer's cache ``c`` (batch on
        dim 0), a view written in place."""
        return c

    def join_rows(self, parts: list, B: int) -> torch.Tensor:
        """The cores' outputs of :meth:`blocks`' ranges of a batch of B
        as the whole batch's."""
        return parts[0]


WHOLE_D = DSlices()


class ProcessSlice(DSlices):
    """decode_ws over processes: process (i, j) of the (data, model)
    grid holds the activations' d-slice i of n (d/n channels of every
    row; the batch replicated over "data") and data slice i of every
    weight's "embed" dim (``params.data_cuts``), which never moves.  A
    product from d is a partial over "data": ONE ``all_reduce`` over
    "data" (counted as "ws_reduce") sums the partials of a call's
    products of one input group, side by side; a product into d gives
    this slice directly; a norm's sum of squares is reduced over "data"
    the same way.  A mixer's core runs on the rows data rank i's cache
    holds (``moe.held_rows``: B/n of them where n divides B, else all),
    and its output comes back to every row in one ``all_gather`` over
    "data" (counted as "ws_gather")."""

    def __init__(self, ex, i: int, n: int):
        self.ex, self.i, self.n, self.ids = ex, i, n, (i,)

    def chan(self, t):
        w = t.shape[-1] // self.n
        return t[..., self.i * w:(self.i + 1) * w].contiguous()

    def dots(self, pairs):
        parts = WHOLE_D.dots(pairs)
        if len(parts) == 1:
            return [self.ex.all_reduce(parts[0], "data", kind="ws_reduce")]
        widths = [t.shape[-1] for t in parts]
        got = self.ex.all_reduce(torch.cat(parts, dim=-1), "data",
                                 kind="ws_reduce")
        return list(got.split(widths, dim=-1))

    def sum_sq(self, x32):
        return self.ex.all_reduce(super().sum_sq(x32), "data",
                                  kind="ws_reduce")

    def _split(self, B: int) -> bool:
        return B % self.n == 0

    def blocks(self, B):
        if not self._split(B):
            return [(0, B)]
        m = B // self.n
        return [(self.i * m, (self.i + 1) * m)]

    def join_rows(self, parts, B):
        (got,) = parts
        if not self._split(B):
            return got
        return torch.cat(self.ex.all_gather(got, "data", kind="ws_gather")
                         .unbind(0))


class StackedSlices(DSlices):
    """decode_ws on one program holding every data rank (the stacked
    twin of :class:`ProcessSlice`): the activations whole in d, the
    weights whole over "data", and each product from d computed slice
    by slice, its n partials summed in data order in fp32 and cast once
    (``schedule.sum_in_order``, the all-reduce's order); each product
    into d slice by slice and joined; each norm's sums of squares by
    slice, summed so; each mixer's core a data rank's rows at a time
    against those rows of the whole cache.  Each slice of a weight or
    an activation is copied out contiguous, as a process holds it, so
    every product has a process's operands and its bits."""

    def __init__(self, n: int):
        self.n, self.ids = n, tuple(range(n))

    def _cut(self, t, dim: int, i: int):
        w = t.shape[dim] // self.n
        return t.narrow(dim, i * w, w).contiguous()

    def dots(self, pairs):
        out = []
        for pr in pairs:
            x, w, t = pr[0], pr[1], len(pr) > 2
            out.append(sum_in_order(torch.stack([
                self._cut(x, -1, i) @ (self._cut(w, 1, i).T if t
                                       else self._cut(w, 0, i))
                for i in self.ids])))
        return out

    def out(self, h, w):
        return torch.cat([h @ self._cut(w, -1, i) for i in self.ids],
                         dim=-1)

    def sum_sq(self, x32):
        return sum_in_order(torch.stack([
            super(StackedSlices, self).sum_sq(self._cut(x32, -1, i))
            for i in self.ids]))

    def blocks(self, B):
        if B % self.n:
            return [(0, B)]
        m = B // self.n
        return [(i * m, (i + 1) * m) for i in self.ids]

    def rows_of(self, c, lo, hi):
        return c[lo:hi]

    def join_rows(self, parts, B):
        return parts[0] if len(parts) == 1 else torch.cat(parts)


class SeqShard:
    """This process's positions [lo, hi) of a sequence of S split over
    the tp "model" processes of ``ex`` (fsdp_sp: "seq" over "model"),
    model rank m holding the m-th S/tp, and the messages the layers need
    from the other shards.  Each is an all-gather over "model"
    (``SPMDExecutor.all_gather``) whose backward is the reduce-scatter
    of its gradient: every model process computes on its own positions,
    so each holds a part of a gathered tensor's gradient, and a shard's
    is their sum."""

    def __init__(self, ex, S: int, tp: int, m: int):
        self.ex, self.S, self.tp, self.m = ex, S, tp, m
        self.lo, self.hi = m * S // tp, (m + 1) * S // tp

    def prev_row(self, x: torch.Tensor) -> torch.Tensor:
        """The row before this shard's first position of x (B, S/tp,
        d): the previous shard's last, zeros at model rank 0 (the token
        shift's carry-in).  Every shard's last row is gathered (counted
        as "seq_shift"); rank 0 scales what it reads by zero, so every
        process runs the same graph and meets the backward's
        reduce-scatter."""
        got = self.ex.all_gather(x[:, -1:].contiguous(), "model",
                                 kind="seq_shift",
                                 scatter="seq_shift_scatter")
        return got[(self.m - 1) % self.tp] * float(self.m > 0)

    def gather_kv(self, k: torch.Tensor, v: torch.Tensor):
        """Every shard's k and v (B, S/tp, KV, hd), after RoPE, as the
        whole sequence's (B, S, KV, hd): ONE all-gather of the pair over
        "model" (counted as "seq_kv")."""
        got = self.ex.all_gather(torch.stack([k, v]), "model",
                                 kind="seq_kv", scatter="seq_kv_scatter")
        n, _, B, s = got.shape[:4]
        both = got.movedim(0, 2).reshape(2, B, n * s, *got.shape[4:])
        return both[0], both[1]
