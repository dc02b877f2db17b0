"""MoE routing against the JAX package, on the CPU (the kernel's plain
PyTorch version).  Integers throughout, so every comparison is exact:
against ``kernels.ops.moe_routing`` in Pallas interpret mode and against
the ``kernels.ref`` oracle.  Ids are drawn in [0, E): ids outside it are
outside the contract (the two JAX versions disagree there)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import moe_routing as tmr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scan_engine as tse

SHAPES = [(16, 2, 4), (300, 4, 60), (256, 8, 40), (100, 2, 128), (1, 1, 2),
          (1000, 3, 61)]


def _assign(T, K, E, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, E, (T, K)).astype(np.int32)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T,K,E", SHAPES)
def test_moe_routing_shapes(T, K, E):
    assign = _assign(T, K, E, T * 7 + K * 3 + E)
    pos, counts = tops.moe_routing(assign, E, device="cpu")
    pw, cw = rops.moe_routing(jnp.asarray(assign), E, interpret=True)
    _eq(pos, pw)
    _eq(counts, cw)
    pr, cr = rref.moe_routing_ref(jnp.asarray(assign), E)
    _eq(pos, pr)
    _eq(counts, cr)


@pytest.mark.parametrize("seed", range(6))
def test_moe_routing_oracles_agree(seed):
    rng = np.random.default_rng(seed)
    T, K, E = (int(v) for v in rng.integers(1, (400, 9, 130)))
    assign = _assign(T, K, E, seed)
    pos, counts = tref.moe_routing_ref(torch.from_numpy(assign), E)
    pr, cr = rref.moe_routing_ref(jnp.asarray(assign), E)
    _eq(pos, pr)
    _eq(counts, cr)
    kp, kc = tmr.moe_routing(torch.from_numpy(assign), num_experts=E)
    _eq(kp, pr)
    _eq(kc[0], cr)


def test_moe_routing_groups_route_apart():
    """A (G, T, K) assignment: each group as its own (T, K) call; the
    kernel-level counts are (G, E), (1, E) for one group."""
    G, T, K, E = 4, 50, 3, 20
    assign = np.stack([_assign(T, K, E, g) for g in range(G)])
    pos, counts = tmr.moe_routing(torch.from_numpy(assign), num_experts=E)
    assert pos.shape == (G, T, K) and counts.shape == (G, E)
    for g in range(G):
        pw, cw = rops.moe_routing(jnp.asarray(assign[g]), E, interpret=True)
        _eq(pos[g], pw)
        _eq(counts[g], cw)
    one_pos, one_counts = tmr.moe_routing(torch.from_numpy(assign[0]),
                                          num_experts=E)
    assert one_pos.shape == (T, K) and one_counts.shape == (1, E)
    gp, gc = tops.moe_routing(assign, E, device="cpu")
    _eq(gp, pos)
    _eq(gc, counts)


def test_moe_routing_counts_no_launch_on_the_cpu():
    before = tse.launch_counts()
    tops.moe_routing(_assign(8, 2, 4, 0), 4, device="cpu")
    assert tse.launch_counts() == before
    assert "moe_routing" in tse.KERNELS


def test_moe_routing_refuses_other_int_types():
    with pytest.raises(TypeError):
        tmr.moe_routing(torch.zeros((4, 2), dtype=torch.int64),
                        num_experts=4)


# ---------------------------------------------------------------------------
# The cluster kernel's decomposition, checked here where it cannot run
# ---------------------------------------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize("G,n,want", [
    (64, 4096 * 4, 8),     # moe_dispatch: p = 64 ranks of 4096 tokens, top-4
    (1, 4096 * 4, 8),      # the ops phase's one (4096, 4) assignment
    (64, 64 * 4, 1),       # a serve payload: 64 ranks of 64 tokens
    (64, 65536 * 4, 8),    # 16x moe_dispatch's tokens
    (3, 1000 * 3, 4),
    (1, 0, 1),
])
def test_routing_cluster_at_the_path_shapes(G, n, want):
    assert tmr.routing_cluster(G, n, H100_SMS) == want


@pytest.mark.parametrize("sms", (1, 8, 66, 132, 144))
def test_routing_cluster_rules(sms):
    per, cap = tmr.BLOCK_ENTRIES, tmr.CLUSTER_SIZES[-1]
    assert cap == 8  # the portable maximum: no non-portable cluster size
    for n, G in itertools.product(
            (0, 1, 511, 1023, 1024, 5000, 16384, 10**6), (1, 3, 64, 1000)):
        cl = tmr.routing_cluster(G, n, sms)
        assert cl in tmr.CLUSTER_SIZES
        if n < 2 * per:
            assert cl == 1  # a short group runs without a cluster
        if cl > 1:
            assert n >= cl * per            # every block keeps its entries
            assert G * (cl // 2) < 2 * sms  # half would not fill the card
        # the least such size: doubling stops at the card, the entries or
        # the cap
        assert cl == cap or G * cl >= 2 * sms or n < 2 * cl * per


@pytest.mark.parametrize("cluster", (0, 3, 16, 32))
def test_moe_routing_refuses_other_cluster_sizes(cluster):
    with pytest.raises(ValueError):
        tmr.moe_routing(torch.zeros((4, 2), dtype=torch.int32),
                        num_experts=4, _cluster=cluster)


def _split_routing(ids, E, cl, warps=8, steps=8):
    """The kernel's arithmetic in numpy, one group at a time: chunk r of
    the group (bounds on multiples of 4) gets the counts of chunks < r as
    its base; inside the chunk, rounds of warps·32·s entries (s = steps,
    for a short chunk the least power of two that holds it), each warp a
    contiguous stretch of s steps of 32 lanes.  A lane's rank is the
    count of equal ids on lower lanes of its step plus the warp's running
    bin; an exclusive scan over the warps per expert, on top of the
    carry, gives each warp's offset."""
    ids = np.asarray(ids)
    G = ids.shape[0]
    flat = ids.reshape(G, -1)
    n = flat.shape[1]
    pos = np.zeros_like(flat)
    counts = np.zeros((G, E), np.int32)
    chunk = (-(-n // cl) + 3) // 4 * 4
    for g in range(G):
        x = np.where((flat[g] >= 0) & (flat[g] < E), flat[g], E)
        bounds = [(min(n, r * chunk), min(n, min(n, r * chunk) + chunk))
                  for r in range(cl)]
        hists = [np.bincount(x[lo:hi], minlength=E + 1)[:E]
                 for lo, hi in bounds]
        base = np.cumsum([np.zeros(E, np.int64)] + hists, axis=0)
        for r, (lo, hi) in enumerate(bounds):
            carry = base[r].copy()
            q, s = -(-(hi - lo) // (32 * warps)), 1
            while s < q and s < steps:  # a power of two, up to steps
                s *= 2
            s = min(s, steps)
            span = 32 * warps * s
            b = lo
            while b < hi:
                bins = np.zeros((warps, E + 1), np.int64)
                rank = {}
                for w in range(warps):
                    for st in range(s):
                        at = b + 32 * (s * w + st)
                        lanes = [i for i in range(at, at + 32) if i < hi]
                        for lane, i in enumerate(lanes):
                            below = sum(x[j] == x[i] for j in lanes[:lane])
                            rank[i] = (w, bins[w, x[i]] + below)
                        for i in lanes:
                            bins[w, x[i]] += 1
                offs = carry + np.cumsum(bins[:, :E], axis=0) - bins[:, :E]
                for i, (w, rk) in rank.items():
                    pos[g, i] = offs[w, x[i]] + rk if x[i] < E else 0
                carry = carry + bins[:, :E].sum(axis=0)
                b += span
            if r == cl - 1:
                counts[g] = carry
    return pos.reshape(ids.shape), counts


# every cluster size the kernel takes, and 16: the split holds for any
@pytest.mark.parametrize("cl", (1, 2, 4, 8, 16))
@pytest.mark.parametrize("G,T,K,E,lo,hi", [
    (2, 300, 4, 61, 0, 61),     # ragged: no multiple of 4·CL or of a round
    (1, 1100, 3, 16, 0, 16),    # several rounds per chunk at CL <= 2
    (2, 7, 1, 8, 0, 8),         # n < 4·CL: empty chunks
    (2, 0, 4, 8, 0, 8),         # n = 0
    (1, 257, 4, 40, -3, 45),    # ids outside [0, E)
])
def test_cluster_decomposition_equals_plain(cl, G, T, K, E, lo, hi):
    rng = np.random.default_rng(cl * 31 + T)
    ids = rng.integers(lo, hi, (G, T, K)).astype(np.int32)
    got = _split_routing(ids, E, cl)
    want = tmr.moe_routing_plain(torch.from_numpy(ids), num_experts=E)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_cluster_decomposition_holds_for_other_geometry():
    """The split is exact for any round shape, not only the kernel's."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 5, (2, 333, 3)).astype(np.int32)
    want = tmr.moe_routing_plain(torch.from_numpy(ids), num_experts=5)
    for warps, steps in ((2, 1), (4, 3), (8, 16)):
        got = _split_routing(ids, 5, 4, warps=warps, steps=steps)
        _eq(got[0], want[0])
        _eq(got[1], want[1])


# (E, K) of the repo's MoE configs: Jamba-1.5's 16 experts top-2,
# Granite-MoE's 40 top-8, Qwen1.5-MoE's 60 padded to 64, top-4
MODEL_ROUTING = [("jamba-1.5-large-398b", 16, 2),
                 ("granite-moe-3b-a800m", 40, 8),
                 ("qwen2-moe-a2.7b", 64, 4)]


@pytest.mark.parametrize("name,E,K", MODEL_ROUTING)
def test_moe_routing_plain_matches_jax_at_model_widths(name, E, K):
    from repro_torch import configs
    from repro_torch.models import params

    cfg = configs.get(name)
    assert cfg.top_k == K
    assert E in (cfg.n_experts, params.experts_padded(cfg))
    G, T = 3, 200
    rng = np.random.default_rng(E * 10 + K)
    assign = np.stack([np.argsort(rng.random((T, cfg.n_experts)), -1)
                       [:, :K] for _ in range(G)]).astype(np.int32)
    pos, counts = tmr.moe_routing_plain(torch.from_numpy(assign),
                                        num_experts=E)
    for g in range(G):
        pw, cw = rops.moe_routing(jnp.asarray(assign[g]), E, interpret=True)
        _eq(pos[g], pw)
        _eq(counts[g], cw)
        pr, cr = rref.moe_routing_ref(jnp.asarray(assign[g]), E)
        _eq(pos[g], pr)
        _eq(counts[g], cr)
