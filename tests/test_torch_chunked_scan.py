"""The chunked-scan engine's entry points against the JAX package, on
the CPU (the kernels' plain PyTorch versions).

Reference side: ``kernels.ops`` and ``kernels.scan_engine`` in Pallas
interpret mode, ``kernels.ref`` and ``models.mamba.ssm_scan_chunked``.
Tolerances:
  * integers: bit-exact, against JAX and the oracles;
  * floats: bit-exact against a numpy left fold of the same dtype (the
    port folds rows in order, rounding each ⊕ as numpy does);
  * exscan floats against a float64 fold within the a-priori bound of
    recursive summation, |err_t| <= γ_t·Σ_{i<t}|x_i| with
    γ_t = t·u/(1 − t·u), u = 2^-24 (Higham, "Accuracy and Stability of
    Numerical Algorithms", §4.2) — not against JAX's float32 exscan,
    which misses its own tolerance at (1000, 33) here.  A fixed
    1e-4·(1+|ref|) does not hold for any float32 left fold of that
    shape: numpy's own fold is off by 1.7e-4 there;
  * affine floats against JAX at rtol = atol = 3e-4, the JAX package's
    own tolerance for ``ssm_scan`` (its chunks scan associatively, in
    another order of float operations).
"""

import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels import scan_engine as rse
from repro.models import mamba as rmamba
from repro_torch import device as tdev
from repro_torch.kernels import blelloch_exscan as tbl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scan_engine as tse
from repro_torch.kernels import ssm_chunk_scan as tssm
from repro_torch.models import mamba as tmamba

CPU = "cpu"
AFFINE_TOL = 3e-4
U32 = 2.0 ** -24  # unit roundoff of float32

NP_OPS = {"add": np.add, "mul": np.multiply, "max": np.maximum,
          "min": np.minimum, "xor": np.bitwise_xor}


def _x64(dtype):
    if np.dtype(dtype) in (np.int64, np.float64):
        return jax.enable_x64(True)
    return contextlib.nullcontext()


def _identity(name, dtype):
    if name in ("add", "xor"):
        return 0
    if name == "mul":
        return 1
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return info.min if name == "max" else info.max
    return -np.inf if name == "max" else np.inf


def np_fold(x, name, exclusive=True, init=None):
    """Left fold along axis -2 of (..., T, D), in x's dtype."""
    x = np.asarray(x)
    op = NP_OPS[name]
    carry = (np.full(x.shape[:-2] + x.shape[-1:],
                     _identity(name, x.dtype), x.dtype)
             if init is None else np.asarray(init, x.dtype).copy())
    out = np.empty_like(x)
    for t in range(x.shape[-2]):
        nxt = op(carry, x[..., t, :]).astype(x.dtype)
        out[..., t, :] = carry if exclusive else nxt
        carry = nxt
    return out, carry


def np_affine(a, b, h0=None):
    """h_t = a_t·h_{t-1} + b_t along axis -2, product and sum rounded
    apart in a's dtype; also A = ∏ a."""
    h = np.zeros(a.shape[:-2] + a.shape[-1:], a.dtype) if h0 is None \
        else np.asarray(h0, a.dtype).copy()
    A = np.ones_like(h)
    hs = np.empty_like(a)
    for t in range(a.shape[-2]):
        h = a[..., t, :] * h + b[..., t, :]
        A = a[..., t, :] * A
        hs[..., t, :] = h
    return hs, h, A


def _t(x):
    return tdev.leaf_to_torch(x, CPU)


def _n(t):
    return tdev.leaf_to_numpy(t)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def assert_within_summation_bound(got, x):
    """The exclusive float32 left fold ``got`` of ``x`` against the
    float64 fold, within recursive summation's a-priori error bound."""
    x64 = x.astype(np.float64)
    ref = np.zeros_like(x64)
    ref[1:] = np.cumsum(x64[:-1], axis=0)
    mass = np.zeros_like(x64)
    mass[1:] = np.cumsum(np.abs(x64[:-1]), axis=0)
    t = np.arange(x.shape[0], dtype=np.float64)[:, None]
    gamma = t * U32 / (1.0 - t * U32)
    assert np.all(np.abs(got.astype(np.float64) - ref) <= gamma * mass)


# ------------------------------ ops.exscan ------------------------------

SHAPES = [(8, 128), (7, 5), (256, 128), (1000, 33), (64, 1), (513, 300),
          (1, 1)]


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_exscan_shapes(n, d, dtype):
    rng = np.random.default_rng(n * 1000 + d)
    if np.issubdtype(dtype, np.integer):
        x = rng.integers(-100, 100, (n, d)).astype(dtype)
    else:
        x = (rng.standard_normal((n, d)) * 10).astype(dtype)
    got = _n(tops.exscan(x, device=CPU))
    assert_bits(got, np_fold(x, "add")[0])
    if np.issubdtype(dtype, np.integer):
        want = np.asarray(rops.exscan(jnp.asarray(x), interpret=True))
        assert_bits(got, want)
        assert_bits(got, np.asarray(rref.exscan_ref(jnp.asarray(x))))
    else:
        assert_within_summation_bound(got, x)


def test_exscan_1d():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, 37).astype(np.int32)
    got = _n(tops.exscan(x, device=CPU))
    assert_bits(got, np.asarray(rops.exscan(jnp.asarray(x),
                                            interpret=True)))
    assert_bits(got, np.concatenate([[0], np.cumsum(x)[:-1]]).astype(
        np.int32))


def test_exscan_oracles_agree():
    """The port's oracle is the JAX package's oracle."""
    rng = np.random.default_rng(4)
    x = rng.integers(-1000, 1000, (90, 6)).astype(np.int32)
    assert_bits(_n(tref.exscan_ref(_t(x))),
                np.asarray(rref.exscan_ref(jnp.asarray(x))))
    assert_bits(_n(tbl.blelloch_exscan(_t(x))), np_fold(x, "add")[0])


# ------------------------ monoid_exscan: every monoid -------------------

INT_MONOIDS = ("add", "max", "min", "xor", "mul")


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", INT_MONOIDS)
def test_monoid_exscan_int_exact(name, dtype):
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.integers(-1000, 1000, (512, 7)).astype(dtype)
    got = _n(tse.monoid_exscan(_t(x), name))
    with _x64(dtype):
        want = np.asarray(rse.monoid_exscan(jnp.asarray(x), name,
                                            block_rows=128,
                                            interpret=True))
    assert_bits(got, want)
    assert_bits(got, np_fold(x, name)[0])


FLOAT_DTYPES = (np.float32, np.float64, ml_dtypes.bfloat16)


@pytest.mark.parametrize("dtype", FLOAT_DTYPES,
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", ("add", "mul", "max", "min"))
def test_monoid_exscan_float_is_the_left_fold(name, dtype):
    rng = np.random.default_rng(7)
    if name == "mul":
        x = rng.uniform(0.9, 1.1, (300, 11)).astype(dtype)
    else:
        x = rng.standard_normal((300, 11)).astype(dtype)
    got = _n(tse.monoid_exscan(_t(x), name))
    assert_bits(got, np_fold(x, name)[0])


def test_monoid_exscan_mul_float_against_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0.9, 1.1, (256, 5)).astype(np.float32)
    got = _n(tse.monoid_exscan(_t(x), "mul"))
    want = np.asarray(rse.monoid_exscan(jnp.asarray(x), "mul",
                                        block_rows=64, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_monoid_exscan_groups_scan_apart():
    rng = np.random.default_rng(5)
    x = rng.integers(-50, 50, (3, 40, 6)).astype(np.int64)
    got = _n(tse.monoid_exscan(_t(x), "add"))
    for g in range(3):
        assert_bits(got[g], _n(tse.monoid_exscan(_t(x[g]), "add")))
    assert_bits(got, np_fold(x, "add")[0])


def test_monoid_exscan_rejects_structured_monoid():
    with pytest.raises(ValueError, match="not elementwise"):
        tse.monoid_exscan(torch.zeros((4, 4)), "affine")


@pytest.mark.parametrize("exclusive", [False, True])
def test_chunked_scan_elementwise_against_jax(exclusive):
    """Init carry, trajectory and final row, as the JAX engine."""
    rng = np.random.default_rng(11)
    x = rng.integers(-50, 50, (256, 3)).astype(np.int32)
    init = rng.integers(-50, 50, (1, 3)).astype(np.int32)
    (got,), (fin,) = tse.chunked_scan((_t(x),), (_t(init),), "add",
                                      exclusive=exclusive, traj=(0,),
                                      final=(0,))
    (want,), (wfin,) = rse.chunked_scan(
        (jnp.asarray(x),), (jnp.asarray(init),), rse._tuple_combine(
            jnp.add), exclusive=exclusive, traj=(0,), final=(0,),
        chunk=32, interpret=True)
    assert_bits(_n(got), np.asarray(want))
    assert_bits(_n(fin), np.asarray(wfin))


def test_chunked_scan_affine_against_jax():
    rng = np.random.default_rng(12)
    a = rng.uniform(0.8, 1.0, (128, 9)).astype(np.float32)
    b = rng.standard_normal((128, 9)).astype(np.float32)
    init = (rng.uniform(0.8, 1.0, (1, 9)).astype(np.float32),
            rng.standard_normal((1, 9)).astype(np.float32))
    got_t, got_f = tse.chunked_scan((_t(a), _t(b)), tuple(map(_t, init)),
                                    "affine", traj=(0, 1), final=(0, 1))
    want_t, want_f = rse.chunked_scan(
        (jnp.asarray(a), jnp.asarray(b)), tuple(map(jnp.asarray, init)),
        rse._affine_combine, traj=(0, 1), final=(0, 1), chunk=32,
        interpret=True)
    for g, w in zip(got_t + got_f, want_t + want_f):
        np.testing.assert_allclose(_n(g), np.asarray(w), rtol=AFFINE_TOL,
                                   atol=AFFINE_TOL)


def test_kernel_wrappers_count_no_launch_on_the_cpu():
    before = tse.launch_counts()
    tse.monoid_exscan(torch.ones((5, 3)), "add")
    tse.affine_chunk_summary(torch.ones((5, 3)), torch.ones((5, 3)))
    assert tse.launch_counts() == before


# ------------------------------ ssm scan ------------------------------


@pytest.mark.parametrize("T,D", [(16, 8), (300, 100), (512, 128), (1, 1)])
def test_ssm_scan_shapes(T, D):
    rng = np.random.default_rng(T * 131 + D)
    a = rng.uniform(0.8, 1.0, (T, D)).astype(np.float32)
    b = rng.standard_normal((T, D)).astype(np.float32)
    h0 = rng.standard_normal(D).astype(np.float32)
    h, hf = tops.ssm_scan(a, b, h0, device=CPU)
    hw, hfw = rops.ssm_scan(jnp.asarray(a), jnp.asarray(b),
                            jnp.asarray(h0), interpret=True)
    np.testing.assert_allclose(_n(h), np.asarray(hw), rtol=AFFINE_TOL,
                               atol=AFFINE_TOL)
    np.testing.assert_allclose(_n(hf), np.asarray(hfw), rtol=AFFINE_TOL,
                               atol=AFFINE_TOL)
    hs, hlast, _ = np_affine(a, b, h0)
    assert_bits(_n(h), hs)
    assert_bits(_n(hf), hlast)


def test_ssm_scan_matches_the_oracles():
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 1.0, (77, 13)).astype(np.float32)
    b = rng.standard_normal((77, 13)).astype(np.float32)
    h, hf = tops.ssm_scan(a, b, device=CPU)
    hr, hfr = tref.ssm_scan_ref(_t(a), _t(b))
    assert torch.equal(h, hr) and torch.equal(hf, hfr)
    hw, _ = rref.ssm_scan_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(_n(h), np.asarray(hw), rtol=AFFINE_TOL,
                               atol=AFFINE_TOL)


def test_ssm_chunk_summary_is_affine_monoid_element():
    """h_out == A_total * h_in + B_total, against JAX's summary."""
    rng = np.random.default_rng(7)
    T, D = 130, 70
    a = rng.uniform(0.7, 1.0, (T, D)).astype(np.float32)
    b = rng.standard_normal((T, D)).astype(np.float32)
    at, bt = tops.ssm_chunk_summary(a, b, device=CPU)
    atw, btw = rops.ssm_chunk_summary(jnp.asarray(a), jnp.asarray(b),
                                      interpret=True)
    np.testing.assert_allclose(_n(at), np.asarray(atw), rtol=AFFINE_TOL,
                               atol=AFFINE_TOL)
    np.testing.assert_allclose(_n(bt), np.asarray(btw), rtol=AFFINE_TOL,
                               atol=AFFINE_TOL)
    _, h_last, A = np_affine(a, b)
    assert_bits(_n(at), A)
    assert_bits(_n(bt), h_last)
    for _ in range(3):
        h_in = rng.standard_normal(D).astype(np.float32)
        _, hf = rref.ssm_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(h_in))
        np.testing.assert_allclose(_n(at) * h_in + _n(bt), np.asarray(hf),
                                   rtol=AFFINE_TOL, atol=AFFINE_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_affine_chunk_groups_against_jax(dtype):
    """(G, T, D) operands: each group equals JAX's engine instances."""
    rng = np.random.default_rng(9)
    G, T, D = 3, 64, 10
    a = rng.uniform(0.8, 1.0, (G, T, D)).astype(dtype)
    b = rng.standard_normal((G, T, D)).astype(dtype)
    h0 = rng.standard_normal((G, D)).astype(dtype)
    h, hf = tssm.ssm_chunk_scan(_t(a), _t(b), _t(h0))
    at, bt = tssm.ssm_chunk_summary(_t(a), _t(b))
    assert h.shape == (G, T, D) and hf.shape == at.shape == (G, D)
    with _x64(dtype):
        for g in range(G):
            hw, hfw = rse.affine_chunk_scan(
                jnp.asarray(a[g]), jnp.asarray(b[g]),
                jnp.asarray(h0[g:g + 1]), chunk=16, interpret=True)
            atw, btw = rse.affine_chunk_summary(
                jnp.asarray(a[g]), jnp.asarray(b[g]), chunk=16,
                interpret=True)
            for got, want in ((h[g], hw), (hf[g], hfw[0]), (at[g], atw[0]),
                              (bt[g], btw[0])):
                np.testing.assert_allclose(_n(got), np.asarray(want),
                                           rtol=AFFINE_TOL, atol=AFFINE_TOL)
    hs, hlast, _ = np_affine(a, b, h0)
    assert_bits(_n(h), hs)
    assert_bits(_n(hf), hlast)


@pytest.mark.parametrize("state", [(16,), (4, 8)])
def test_ssm_scan_chunked_against_jax(state):
    rng = np.random.default_rng(len(state))
    B, S = 2, 200
    a = rng.uniform(0.7, 1.0, (B, S) + state).astype(np.float32)
    b = rng.standard_normal((B, S) + state).astype(np.float32)
    h0 = rng.standard_normal((B,) + state).astype(np.float32)
    h, hf = tmamba.ssm_scan_chunked(_t(a), _t(b), _t(h0))
    hw, hfw = rmamba.ssm_scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(h0))
    assert h.shape == a.shape and hf.shape == h0.shape
    np.testing.assert_allclose(_n(h), np.asarray(hw), rtol=AFFINE_TOL,
                               atol=AFFINE_TOL)
    np.testing.assert_allclose(_n(hf), np.asarray(hfw), rtol=AFFINE_TOL,
                               atol=AFFINE_TOL)
    d = int(np.prod(state))
    hs, _, _ = np_affine(a.reshape(B, S, d), b.reshape(B, S, d),
                         h0.reshape(B, d))
    assert_bits(_n(h).reshape(B, S, d), hs)
