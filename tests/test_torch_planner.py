"""The port's planner against the JAX package's, under one profile.

The reference's ``DEFAULT_PROFILE`` is carried across with
``to_json``/``from_json``; under it both planners must make the same
decision (algorithm, S, rounds, ⊕, all-gathers, wire bytes and cost)
for every kind × p in 2..64 × m from 8 B to 64 MB in powers of two, and
``explain()`` must give the same rows.  Costs are the same float
arithmetic in the same order, so they are compared exactly.
"""

import dataclasses

import pytest

from repro.core import scan_api as rsa
from repro.launch import mesh as rmesh
from repro_torch.core import scan_api as tsa
from repro_torch.launch import mesh as tmesh

P_RANGE = range(2, 65)
M_RANGE = [8 << k for k in range(24)]  # 8 B .. 64 MiB
# monoids whose op_cost or segmentability changes the candidates
OTHER_MONOIDS = {"exclusive": ("affine", "matmul"),
                 "scan_total": ("affine", "matmul")}
OTHER_P = (2, 3, 5, 8, 13, 17, 31, 32, 33, 63, 64)


@pytest.fixture(scope="module")
def profiles():
    ref = rmesh.DEFAULT_PROFILE
    port = tsa.CostProfile.from_json(ref.to_json())
    return ref, port


def _decision(pl):
    return (pl.algorithm, pl.segments, pl.rounds, pl.op_applications,
            pl.allgathers, pl.bytes_on_wire, pl.cost, pl.kernel_passes,
            pl.op_bytes, pl.pass_bytes, pl.cost_model_source)


def test_profile_round_trips_and_fingerprints_equal(profiles):
    ref, port = profiles
    assert port.to_json() == ref.to_json()
    assert port.fingerprint() == ref.fingerprint()
    back = rsa.CostProfile.from_json(port.to_json())
    assert back == ref
    for tier, cm in ref.tiers:
        assert dataclasses.astuple(port.model(tier)) == \
            dataclasses.astuple(cm)


def _same_decisions(kind, name, ps, profiles):
    ref, port = profiles
    rspec = rsa.ScanSpec(kind=kind, monoid=name)
    tspec = tsa.ScanSpec(kind=kind, monoid=name)
    for p in ps:
        for m in M_RANGE:
            want = rsa.plan(rspec, p, nbytes=m, cost_model=ref)
            got = tsa.plan(tspec, p, nbytes=m, cost_model=port)
            assert _decision(got) == _decision(want), (kind, name, p, m)


@pytest.mark.parametrize("kind", tsa.KINDS)
def test_auto_decisions_equal(kind, profiles):
    _same_decisions(kind, "add", P_RANGE, profiles)


@pytest.mark.parametrize("kind,name", [(k, n) for k, ns in
                                       OTHER_MONOIDS.items() for n in ns])
def test_auto_decisions_equal_other_monoids(kind, name, profiles):
    _same_decisions(kind, name, OTHER_P, profiles)


@pytest.mark.parametrize("kind", tsa.KINDS)
def test_explain_rows_equal(kind, profiles):
    ref, port = profiles
    for p in P_RANGE:
        for m in M_RANGE:
            want = rsa.plan(rsa.ScanSpec(kind=kind), p, nbytes=m,
                            cost_model=ref).explain()
            got = tsa.plan(tsa.ScanSpec(kind=kind), p, nbytes=m,
                           cost_model=port).explain()
            assert got == want, (kind, p, m)


@pytest.mark.parametrize("kind", tsa.KINDS)
def test_pinned_plans_equal(kind, profiles):
    ref, port = profiles
    for algo in tsa.algorithms(kind):
        assert algo in rsa.algorithms(kind)
        for p in (2, 5, 16, 37, 64):
            for m in (8, 4096, 1 << 22):
                segs = (None, 8) if algo == "ring" else (None,)
                for S in segs:
                    want = rsa.plan(rsa.ScanSpec(kind=kind, algorithm=algo,
                                                 segments=S),
                                    p, nbytes=m, cost_model=ref)
                    got = tsa.plan(tsa.ScanSpec(kind=kind, algorithm=algo,
                                                segments=S),
                                   p, nbytes=m, cost_model=port)
                    assert _decision(got) == _decision(want)
                    assert got.explain() == want.explain()


def test_fused_and_hierarchical_plans_equal(profiles):
    ref, port = profiles
    for p in (4, 8, 12, 64):
        for k in (1, 2, 8):
            sizes = [4 * (i + 1) for i in range(k)]
            want = rsa.plan_fused([rsa.ScanSpec()] * k, p, sizes,
                                  cost_model=ref)
            got = tsa.plan_fused([tsa.ScanSpec()] * k, p, sizes,
                                 cost_model=port)
            assert (got.fused, got.rounds, got.cost) == \
                (want.fused, want.rounds, want.cost)
    for pi, pa in ((2, 4), (3, 4), (4, 8)):
        for m in (64, 1 << 18, 1 << 20):
            want = rsa.plan_hierarchical(rsa.ScanSpec(), p_inter=pi,
                                         p_intra=pa, nbytes=m,
                                         cost_model=ref)
            got = tsa.plan_hierarchical(tsa.ScanSpec(), p_inter=pi,
                                        p_intra=pa, nbytes=m,
                                        cost_model=port)
            assert _decision(got) == _decision(want)
            assert got.explain() == want.explain()


def test_port_default_profile_is_its_own():
    """The port prices with the card's constants, not the TPU's."""
    cm = tmesh.current_profile().for_axis(None)
    assert tmesh.current_profile().default_tier == "stacked"
    for tier, ref_cm in rmesh.DEFAULT_PROFILE.tiers:
        assert (cm.alpha, cm.beta, cm.gamma) != \
            (ref_cm.alpha, ref_cm.beta, ref_cm.gamma), tier


def test_installed_profile_routes_plans():
    ref = tsa.CostProfile.from_json(rmesh.DEFAULT_PROFILE.to_json())
    prev = tmesh.install_profile(ref)
    try:
        assert tmesh.current_profile() is ref
        assert tmesh.axis_cost_model("data") == ref.model("ici")
    finally:
        tmesh.install_profile(prev)
    assert tmesh.current_profile() is tmesh.DEFAULT_PROFILE


def test_plan_cache_info_counts():
    tsa.plan_cache_clear()
    spec = tsa.ScanSpec(kind="exclusive", monoid="xor")
    tsa.plan(spec, 8, nbytes=64)
    tsa.plan(spec, 8, nbytes=64)
    info = tsa.plan_cache_info()
    assert (info["hits"], info["misses"], info["size"]) == (1, 1, 1)
