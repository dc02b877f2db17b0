"""Context-parallel SSM prefill on stacked ranks against the JAX
package's single-sequence scan, on the CPU.

``cp_ssm_scan`` splits the global (B, S, ...) sequence into p shards on
a leading rank axis.  Its output, un-split, must match JAX's
``ssm_scan_chunked`` over the whole sequence at rtol = atol = 2e-4, the
JAX package's own tolerance for its context-parallel scan
(``tests/test_context_parallel.py``): the carry composes the shards'
summaries in another order of float operations than one sequential
pass.  The cross-rank carry must run the planned schedule: its measured
rounds and ⊕ equal the plan's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import ssm_scan_chunked as ref_scan
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch
from repro_torch.core.scan_api import ScanSpec
from repro_torch.models import context_parallel as tcp

TOL = 2e-4
B, S = 2, 240  # S divides by every p below
ALGOS = ("auto", "123", "1doubling", "two_op")


def _split(x, p):
    """(B, S, ...) -> (p, B, S/p, ...)."""
    t = torch.from_numpy(x)
    return t.reshape(B, p, S // p, *x.shape[2:]).transpose(0, 1).contiguous()


def _join(h, p):
    return h.transpose(0, 1).reshape(B, S, *h.shape[3:]).numpy()


def _inputs(state, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 1.0, (B, S) + state).astype(np.float32)
    b = rng.standard_normal((B, S) + state).astype(np.float32)
    return a, b


@pytest.mark.parametrize("alg", ALGOS)
@pytest.mark.parametrize("p", [2, 3, 5, 8])
def test_cp_ssm_matches_sequential(p, alg):
    a, b = _inputs((16,))
    ref, _ = ref_scan(jnp.asarray(a), jnp.asarray(b), jnp.zeros((B, 16)))
    got = tcp.cp_ssm_scan(_split(a, p), _split(b, p), algorithm=alg)
    assert got.shape == (p, B, S // p, 16)
    np.testing.assert_allclose(_join(got, p), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("p", [3, 8])
def test_cp_ssm_carry_runs_the_plan(p):
    """Multi-dim state, an explicit spec and executor; the carry's
    measured rounds and ⊕ are the plan's."""
    state = (4, 6)
    a, b = _inputs(state, seed=p)
    spec = ScanSpec(kind="exclusive", monoid="affine", algorithm="123")
    with tsch.collect_stats() as st:
        got = tcp.cp_ssm_scan(_split(a, p), _split(b, p), spec=spec,
                              executor=tsch.StackedExecutor("cpu"))
    pl = tsa.plan(spec, p, nbytes=2 * B * 24 * 4)
    assert (st.rounds, st.op_applications) == (pl.rounds,
                                               pl.op_applications)
    ref, _ = ref_scan(jnp.asarray(a), jnp.asarray(b),
                      jnp.zeros((B,) + state))
    np.testing.assert_allclose(_join(got, p), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_carry_spec_resolution():
    assert tcp._carry_spec(None, None) == tcp.CARRY_SPEC
    pinned = tcp._carry_spec(None, "two_op")
    assert (pinned.kind, pinned.monoid, pinned.algorithm) == (
        "exclusive", "affine", "two_op")
    forced = tcp._carry_spec(ScanSpec(kind="inclusive", monoid="add",
                                      algorithm="123"), None)
    assert (forced.kind, forced.monoid, forced.algorithm) == (
        "exclusive", "affine", "123")


def test_cp_ssm_one_rank_is_the_local_scan():
    a, b = _inputs((5,), seed=3)
    got = tcp.cp_ssm_scan(_split(a, 1), _split(b, 1))
    ref, _ = ref_scan(jnp.asarray(a), jnp.asarray(b), jnp.zeros((B, 5)))
    np.testing.assert_allclose(_join(got, 1), np.asarray(ref), rtol=TOL,
                               atol=TOL)
