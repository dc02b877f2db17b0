"""Top-k gradient compression with error feedback, from the JAX
package's ``optim/compression.py``.

Data-parallel gradient sync exchanging only the top-k magnitude entries
per rank (EF-SGD style): the residual is carried in an error-feedback
buffer so the compression is unbiased over time.  Buffers are
fixed-size (k_max) for static shapes; each rank may use fewer slots
(threshold crossing) and the *compact* layout offsets — where rank r's
entries start in the concatenated global value array — are the
exclusive prefix sums of per-rank counts, computed with the paper's
exscan.  One offset exscan is needed PER LEAF GROUP; they are k
concurrent scalar scans over the same axis, so they route through
``scan_api.fused_scan``: the planner packs them into one payload and
all k ride a single schedule's rounds (α·q once, not k·α·q).

As everywhere in the port the p data ranks sit on a leading axis of
one card's tensors: each leaf is (p, ...), the all-gather of the
reference's shard_map body is the stacked tensor itself, and its
scatter-add is ``index_add_``.
"""

from __future__ import annotations

import torch

from repro_torch import _tree
from repro_torch.core.scan_api import ScanSpec, fused_scan
from repro_torch.core.schedule import StackedExecutor

# Per-rank slot counts are a tiny int vector — the paper's small-m
# regime, where "auto" picks the round-optimal schedule for the p at
# hand.
OFFSETS_SPEC = ScanSpec(kind="exclusive", monoid="add", algorithm="auto")


def leaf_slot_counts(sizes, k_fraction: float) -> list[int]:
    """Per-leaf compact slot counts: the top-k budget each rank
    contributes to leaf group i is ``max(1, int(sizes[i] *
    k_fraction))``.  Shared by :func:`sparse_gradient_sync` (the slot
    math and the offset exscans) and the serve subsystem's compression
    request generator (``repro_torch.serve.workloads``), so the traffic
    the scan service benches is this module's."""
    return [max(1, int(int(n) * k_fraction)) for n in sizes]


def _topk_sparsify(g: torch.Tensor, k: int):
    """Each rank's k largest-magnitude entries of its flat slice of g
    (p, ...): (values (p, k), indices (p, k) int32, dense contribution
    of g's shape), the picks in ``torch.topk``'s order (by magnitude,
    largest first, as ``lax.top_k``)."""
    flat = g.reshape(g.shape[0], -1)
    _, idx = torch.topk(flat.abs(), k, dim=1)
    picked = torch.gather(flat, 1, idx)
    dense = torch.zeros_like(flat).scatter_(1, idx, picked)
    return picked, idx.to(torch.int32), dense.reshape(g.shape)


def sparse_gradient_sync(grads, err, *, k_fraction: float = 0.01,
                         spec: ScanSpec | None = None,
                         algorithm: str | None = None, executor=None):
    """One EF-top-k gradient exchange over the p data ranks stacked on
    every leaf's leading axis.

    Args:
      grads: tree of per-rank (unreduced) gradients, each leaf (p, ...).
      err: the matching error-feedback tree (``init_error_feedback``,
        zeros at step 0).
      k_fraction: each rank's top-k budget per leaf
        (``leaf_slot_counts``).
      spec / algorithm: the offsets' exscan (default ``OFFSETS_SPEC``;
        ``algorithm`` the legacy alias of a pinned one).
      executor: where the offsets' exscans run (default
        ``StackedExecutor`` on the leaves' device).

    Returns (synced, new_err, stats): ``synced`` the mean over ranks of
    every rank's picks, on every rank (leaves (p, ...) fp32), ``new_err``
    each rank's residual, and ``stats["compact_offsets"]`` the
    compact-layout offsets, (n_leaves, p) int32 from one fused exscan.
    """
    flat_g, treedef = _tree.flatten(grads)
    flat_e = _tree.leaves(err)
    if len(flat_e) != len(flat_g):
        raise ValueError(f"err has {len(flat_e)} leaves, grads "
                         f"{len(flat_g)}")
    p = flat_g[0].shape[0]
    ks = leaf_slot_counts([g[0].numel() for g in flat_g], k_fraction)
    synced, new_err = [], []
    for g, e, k in zip(flat_g, flat_e, ks):
        if g.shape[0] != p or e.shape != g.shape:
            raise ValueError(f"leaf {tuple(g.shape)} with error "
                             f"{tuple(e.shape)}: every leaf must carry the "
                             f"{p} ranks on its leading axis")
        g = g.float() + e
        vals, idx, mine = _topk_sparsify(g, k)
        new_err.append(g - mine)
        del mine
        # every rank's picks, gathered: the stacked (p, k) themselves
        dense = torch.zeros(g[0].numel(), dtype=torch.float32,
                            device=g.device)
        dense.index_add_(0, idx.reshape(-1).long(), vals.reshape(-1))
        synced.append((dense / p).reshape(g.shape[1:]).expand(g.shape)
                      .contiguous())
    ospec = spec if spec is not None else OFFSETS_SPEC
    if algorithm is not None:  # legacy string path
        ospec = ospec.over(ospec.axis_name, algorithm=algorithm)
    ospec = ospec.over(ospec.axis_name, kind="exclusive", monoid="add")
    dev = flat_g[0].device
    if executor is None:
        executor = StackedExecutor(dev)
    counts = [torch.full((p,), k, dtype=torch.int32, device=dev)
              for k in ks]
    offs = fused_scan([(c, ospec) for c in counts], executor=executor)
    return (_tree.unflatten(treedef, synced),
            _tree.unflatten(treedef, new_err),
            {"compact_offsets": torch.stack(offs)})


def init_error_feedback(grads):
    """Zeros in fp32 of every leaf's shape: the error feedback before the
    first step."""
    return _tree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads)
