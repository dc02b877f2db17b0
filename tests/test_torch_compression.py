"""EF top-k gradient sync on stacked ranks against the JAX package's
``optim/compression.py``, on the CPU.

The reference's ``sparse_gradient_sync`` runs inside ``shard_map`` over
p devices (its ``ppermute`` asserts on the axis size under
``jax.vmap``), so its cases are held here as its own test
(``tests/test_compression.py``) holds them: exact at k = 1.0 (the dense
mean, zero error) and EF convergence at k = 0.1 on the same quadratic
and schedule; and against its parts in process: ``_topk_sparsify`` on
each rank's leaf, and the compact offsets against its fused exscan
plan run on ``SimulatorExecutor``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan_api as rsa
from repro.core import schedule as rsch
from repro.optim import compression as rcomp
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch
from repro_torch.optim import compression as tcomp
from repro_torch.optim import init_error_feedback, sparse_gradient_sync


def _tree(p: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((p, 64)).astype(np.float32),
            "blocks": ({"a": rng.standard_normal((p, 3, 50))
                        .astype(np.float32)},
                       {"b": rng.standard_normal((p, 7)).astype(np.float32)})}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_torch(v) for v in tree)
    return torch.from_numpy(tree)


def _np_leaves(tree) -> list:
    """Leaves in the trees' order: dict keys sorted, as jax's."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _np_leaves(v)]
    return [tree]


@pytest.mark.parametrize("p", [2, 3, 8])
def test_exact_at_k_one(p):
    """k = 1.0 picks every entry: every rank gets the dense mean (rtol
    1e-6, as the reference's test; atol 1e-6 of the leaf's scale, the
    rounding of a sum of p entries that may cancel) and the error is 0."""
    tree = _tree(p, seed=p)
    tg = _torch(tree)
    synced, err, stats = sparse_gradient_sync(tg, init_error_feedback(tg),
                                              k_fraction=1.0)
    for g, s, e in zip(_np_leaves(tree), _tree_leaves(synced),
                       _tree_leaves(err)):
        assert s.shape == g.shape and s.dtype == torch.float32
        mean = g.mean(axis=0)
        for r in range(p):
            np.testing.assert_allclose(s[r].numpy(), mean, rtol=1e-6,
                                       atol=1e-6 * np.abs(g).max())
        assert float(e.abs().max()) == 0.0
    sizes = [g[0].size for g in _np_leaves(tree)]
    want = np.stack([np.arange(p) * n for n in sizes]).astype(np.int32)
    assert stats["compact_offsets"].dtype == torch.int32
    np.testing.assert_array_equal(stats["compact_offsets"].numpy(), want)


def _tree_leaves(tree) -> list:
    from repro_torch import _tree as tt

    return tt.leaves(tree)


def test_ef_convergence_at_k_tenth():
    """The reference's case: distributed SGD on f(w) = mean_r ||w -
    t_r||² over p = 8 ranks, 32 floats, k = 0.1 (3 entries a rank),
    2500 steps, lr 0.08 divided by 4 at steps 1000 and 1800."""
    p = 8
    rng = np.random.default_rng(0)
    rng.standard_normal((p, 64))  # the reference's k = 1.0 case's draw
    targets = torch.from_numpy(rng.standard_normal((p, 32))
                               .astype(np.float32))
    w = torch.zeros(32)
    err = {"w": torch.zeros((p, 1, 32))}
    opt = targets.mean(dim=0)
    init_dist = float(torch.linalg.norm(w - opt))
    lr = 0.08
    ex = tsch.StackedExecutor("cpu")
    for it in range(2500):
        grad = 2 * (w[None] - targets)  # each rank's gradient
        synced, err, _ = sparse_gradient_sync(
            {"w": grad[:, None]}, err, k_fraction=0.1, executor=ex)
        w = w - lr * synced["w"][0, 0]
        if it in (1000, 1800):
            lr /= 4
    final = float(torch.linalg.norm(w - opt))
    assert final < 0.15 and final < 0.1 * init_dist, (init_dist, final)


@pytest.mark.parametrize("k", [1, 5, 64])
def test_picks_match_reference_topk(k):
    """Each rank's (values, indices, dense contribution) equal to the
    reference's ``_topk_sparsify`` on that rank's leaf."""
    p = 4
    rng = np.random.default_rng(k)
    g = rng.standard_normal((p, 8, 16)).astype(np.float32)
    vals, idx, dense = tcomp._topk_sparsify(torch.from_numpy(g), k)
    assert vals.shape == (p, k) and idx.dtype == torch.int32
    assert dense.shape == g.shape
    for r in range(p):
        rv, ri, rd = rcomp._topk_sparsify(jnp.asarray(g[r]), k)
        np.testing.assert_array_equal(vals[r].numpy(), np.asarray(rv))
        np.testing.assert_array_equal(idx[r].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(dense[r].numpy(), np.asarray(rd))


@pytest.mark.parametrize("k_fraction", [0.1, 0.3])
def test_sync_is_the_mean_of_each_rank_picks(k_fraction):
    """synced = the mean over ranks of every rank's picks from g + e,
    and new_err = g + e less the rank's own picks."""
    p = 5
    tree = _tree(p, seed=7)
    tg = _torch(tree)
    e0 = _torch(_tree(p, seed=8))
    e0 = {"w": e0["w"] * 0.1, "blocks": tuple(
        {k: v * 0.1 for k, v in b.items()} for b in e0["blocks"])}
    synced, err, _ = sparse_gradient_sync(tg, e0, k_fraction=k_fraction)
    for g, e, s, ne in zip(_tree_leaves(tg), _tree_leaves(e0),
                           _tree_leaves(synced), _tree_leaves(err)):
        full = g + e
        (k,) = tcomp.leaf_slot_counts([g[0].numel()], k_fraction)
        picks = []
        for r in range(p):
            rv, ri, rd = rcomp._topk_sparsify(jnp.asarray(full[r].numpy()),
                                              k)
            picks.append(np.asarray(rd))
            np.testing.assert_allclose(ne[r].numpy(),
                                       full[r].numpy() - np.asarray(rd),
                                       rtol=0, atol=0)
        want = np.sum(picks, axis=0) / p
        for r in range(p):
            np.testing.assert_allclose(s[r].numpy(), want, rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("algo", [None, "123", "1doubling", "two_op"])
@pytest.mark.parametrize("p", [2, 3, 5, 8])
def test_offsets_match_reference_fused_scan(p, algo):
    """The compact offsets: one fused exscan of the per-leaf counts,
    equal to the reference's fused plan on ``SimulatorExecutor`` and to
    numpy's exclusive cumsum; its rounds and ⊕ are the fused plan's."""
    tree = _tree(p, seed=p + 1)
    tg = _torch(tree)
    sizes = [g[0].size for g in _np_leaves(tree)]
    counts = tcomp.leaf_slot_counts(sizes, 0.1)
    with tsch.collect_stats() as st:
        _, _, stats = sparse_gradient_sync(
            tg, init_error_feedback(tg), k_fraction=0.1, algorithm=algo)
    got = stats["compact_offsets"].numpy()
    assert got.shape == (len(sizes), p) and got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.stack([np.arange(p) * c for c in counts]))
    rspec = rcomp.OFFSETS_SPEC
    if algo is not None:
        rspec = rspec.over("data", algorithm=algo)
    rspec = rspec.over("data", kind="exclusive", monoid="add")
    xs = [np.full((p,), c, np.int32) for c in counts]
    rfp = rsa.plan_fused([rspec] * len(xs), p, [4] * len(xs))
    want = rfp.execute(xs, executor=rsch.SimulatorExecutor())
    np.testing.assert_array_equal(got, np.stack([np.asarray(w)
                                                 for w in want]))
    tspec = tcomp.OFFSETS_SPEC if algo is None else \
        tcomp.OFFSETS_SPEC.over(None, algorithm=algo)
    tfp = tsa.plan_fused([tspec] * len(xs), p, [4] * len(xs))
    assert tfp.fused and rfp.fused  # four 4-byte scans ride one schedule
    assert (st.rounds, st.op_applications) == (
        tfp.rounds, tfp.packed.op_applications)
    assert tfp.rounds == rfp.rounds


def test_init_error_feedback_and_bad_trees():
    tg = {"a": torch.ones((2, 3), dtype=torch.bfloat16),
          "b": torch.ones((2, 4))}
    err = init_error_feedback(tg)
    assert all(e.dtype == torch.float32 and not bool(e.any())
               for e in _tree_leaves(err))
    assert err["a"].shape == (2, 3)
    synced, _, _ = sparse_gradient_sync(tg, err, k_fraction=1.0)
    assert synced["a"].dtype == torch.float32
    np.testing.assert_array_equal(synced["a"].numpy(), np.ones((2, 3)))
    with pytest.raises(ValueError, match="leaves"):
        sparse_gradient_sync(tg, {"a": err["a"]})
    with pytest.raises(ValueError, match="leading axis"):
        sparse_gradient_sync({"a": torch.ones(2, 3), "b": torch.ones(3, 3)},
                             {"a": torch.zeros(2, 3),
                              "b": torch.zeros(3, 3)})
