"""MoE routing against the JAX package, on the CPU (the kernel's plain
PyTorch version).  Integers throughout, so every comparison is exact:
against ``kernels.ops.moe_routing`` in Pallas interpret mode and against
the ``kernels.ref`` oracle.  Ids are drawn in [0, E): ids outside it are
outside the contract (the two JAX versions disagree there)."""

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
