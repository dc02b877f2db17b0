"""Online autotuning on the card (marked ``cuda``; skipped where there is
no card): a probe's clock ends in a synchronise and its first meeting
with a schedule runs untimed, a service with a tuner attached answers
as its CPU run does with no compile across an install, and the dci tier
calibrates across a 2-process pool on the card.

Run on the machine with the card:
    python -m pytest -q -m cuda tests/test_torch_cuda_autotune.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import autotune as at
from repro_torch.core import scan_api as sa
from repro_torch.core import schedule as sch
from repro_torch.core import tune
from repro_torch.kernels import scan_engine as se
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve import Bucket, ScanService

pytestmark = pytest.mark.cuda

ROUND_KERNELS = ("combine", "exchange", "scan_reduce")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def clean_globals():
    prev = mesh_lib.install_profile(None)
    sa.plan_cache_clear()
    try:
        yield
    finally:
        mesh_lib.install_profile(prev)
        sa.plan_cache_clear()


def _round_launches() -> int:
    counts = se.launch_counts()
    return sum(counts.get(k, 0) for k in ROUND_KERNELS)


def test_probe_is_synchronised_and_warms_first(dev):
    spec = sa.ScanSpec(kind="exclusive", monoid="add", algorithm="123")
    p, nbytes = 8, 8 << 22  # 32 MiB a rank: each round a long kernel
    tuner = at.AutoTuner(install=False)
    ex = sch.StackedExecutor(dev)
    before = _round_launches()
    pl = tuner.probe(spec, p, nbytes, executor=ex)
    ir = pl.schedule().kernel_launches(True, fused=True)
    assert ir > 0
    assert _round_launches() - before == 2 * ir  # warm-up, then timed
    before = _round_launches()
    tuner.probe(spec, p, nbytes, executor=ex)
    assert _round_launches() - before == ir  # met before: timed only
    x = torch.randint(0, 1 << 30, (p, nbytes // 8), device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    ex.execute(pl.schedule(), x, "add")
    end.record()
    torch.cuda.synchronize(dev)
    round_s = start.elapsed_time(end) / 1e3 / pl.rounds
    seconds = [s.seconds for s in tuner.reservoir("stacked")]
    assert len(seconds) == 2
    assert min(seconds) >= round_s > 0


def test_service_with_a_tuner_matches_cpu(dev, clean_globals):
    buckets = [Bucket(kind="exclusive", monoid="add", shape=(),
                      dtype=np.int32),
               Bucket(kind="scan_total", monoid="add", shape=(64,),
                      dtype=np.int32)]
    rng = np.random.default_rng(5)
    rounds = [[(kind, rng.integers(0, 1000, (16,) + shape).astype(np.int32))
               for kind, shape in (("exclusive", ()), ("scan_total", (64,)))
               for _ in range(int(rng.integers(1, 6)))] for _ in range(6)]
    answers = {}
    for where in ("cpu", "cuda"):
        tuner = at.AutoTuner(mesh_lib.DEFAULT_PROFILE, refit_every=1000)
        svc = ScanService(16, buckets, max_batch=4,
                          executor=sch.StackedExecutor(
                              dev if where == "cuda" else "cpu"),
                          cost_model=mesh_lib.DEFAULT_PROFILE)
        svc.attach_autotuner(tuner)
        svc.warmup()
        got = []
        for i, reqs in enumerate(rounds):
            if i == 3:  # an install between bursts: re-warmed, no compile
                tuner.install(dataclasses.replace(
                    mesh_lib.DEFAULT_PROFILE, mesh_fingerprint="swap",
                    tiers=(("stacked", dataclasses.replace(
                        mesh_lib.STACKED_COST, alpha=4e-4)),)))
            done = [svc.submit(x, kind=kind) for kind, x in reqs]
            svc.drain()
            got += [tuple(t.cpu().numpy() for t in r.result)
                    if isinstance(r.result, tuple) else r.result.cpu().numpy()
                    for r in done]
        assert svc.post_warmup_compiles == 0
        assert tuner.installs == 1 and tuner.rejected == 0
        assert tuner.executions == svc.metrics.batches
        answers[where] = got
    for a, b in zip(answers["cpu"], answers["cuda"]):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(u, v)


def test_calibrate_dist_on_the_card(dev):
    prof = tune.calibrate_dist(nprocs=2, device=dev, ms=(8192, 131_072),
                               repeats=2)
    assert prof.mesh_fingerprint == "dist-cuda-procs2x1"
    assert [n for n, _ in prof.tiers] == ["dci", "stacked"]
    dci = prof.model("dci")
    assert min(dci.alpha, dci.beta, dci.gamma) >= 0
    assert dci.alpha + dci.beta + dci.gamma > 0
    assert prof.tier_for_axis("proc") == "dci"
