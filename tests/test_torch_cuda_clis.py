"""The ported benchmark CLIs and examples on the card (marked ``cuda``;
skipped where there is no card).  Each measured bench and example runs
on the card and on the CPU: integer outputs bit for bit, fp32 ones
within the tolerance their CPU tests state (the context-parallel scan
2e-4, the models atol 3e-4 and rtol 3e-3); the gates of the ``--check``
CLIs pass with every executed schedule on the card.

Run on the machine with the card:
    python -m pytest -q -m cuda tests/test_torch_cuda_clis.py
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.benchmarks import exec_bench, exscan_table1, moe_dispatch, \
    plan_table, round_counts, serve_bench, ssm_context_parallel
from repro_torch.examples import context_parallel_ssm, moe_dispatch_exscan, \
    quickstart, train_smoke
from repro_torch.kernels import scan_engine as se

pytestmark = pytest.mark.cuda

CP_TOL = 2e-4
ATOL, RTOL = 3e-4, 3e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_exscan_table1_measured_on_the_card(card):
    ems = (1, 1000, 100_000)
    got = exscan_table1.measured(card, ems=ems)  # raises unless numpy's
    assert sorted(got) == sorted(f"{a}/{m}" for a in exscan_table1.ALGS
                                 for m in ems)
    assert all(v > 0 for v in got.values())


@pytest.mark.parametrize("alg", ("auto", "123", "native"))
def test_moe_dispatch_forward_card_against_cpu(card, alg):
    tokens = np.random.default_rng(0).integers(
        0, configs.get_smoke(moe_dispatch.ARCH).vocab, (4, 32)).astype(
            np.int32)
    se.reset_launch_counts()
    _, logits, aux = moe_dispatch.forward(alg, tokens, card, reps=1)
    assert se.KERNELS["moe_routing"].launches > 0
    _, want, want_aux = moe_dispatch.forward(alg, tokens, "cpu", reps=1)
    np.testing.assert_allclose(logits.cpu().numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(aux.cpu().numpy(), want_aux.numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("alg", ("auto", "123"))
def test_ssm_prefill_card_against_cpu(card, alg):
    a, b = ssm_context_parallel.inputs(0, (1, 1024, 256))
    se.reset_launch_counts()
    _, h = ssm_context_parallel.prefill(alg, a, b, card, reps=1)
    assert se.KERNELS["affine_chunk"].launches > 0
    _, want = ssm_context_parallel.prefill(alg, a, b, "cpu", reps=1)
    np.testing.assert_allclose(h.cpu().numpy(), want.numpy(), rtol=CP_TOL,
                               atol=CP_TOL)


def test_exec_bench_gates_on_the_card(card):
    rows = exec_bench.schedule_rows(8, card, reps=1) + \
        exec_bench.fused_rows(card, reps=1)
    assert exec_bench.check(rows) == []
    assert all(r["round_kernel_launches"] == r["predicted_launches"] > 0
               for r in rows if r["algorithm"] != "native")


def test_serve_bench_burst_on_the_card(card):
    svc, traffic, _, _ = serve_bench.make_service_and_traffic(card)
    row = serve_bench.run_burst(svc, traffic)
    cpu, traffic_cpu, _, _ = serve_bench.make_service_and_traffic("cpu")
    want = serve_bench.run_burst(cpu, traffic_cpu)
    assert row["wrong"] == 0 and row["completed"] == serve_bench.N_BURST
    assert row["fused_round_win"] == want["fused_round_win"] >= \
        serve_bench.MIN_FUSED_ROUND_WIN
    assert svc.post_warmup_compiles == 0


def test_round_counts_and_plan_table_check_on_the_card(card):
    assert round_counts.run([], check=True, device=card)
    rows = plan_table.run([], check=True, device=card)
    assert dict((k, v) for k, v, _ in rows)[
        "winner_map/stacked/new_alg_cells"] >= 1


def test_quickstart_card_against_cpu(card):
    got = quickstart.run(card, verbose=False)
    want = quickstart.run("cpu", verbose=False)
    assert got.keys() == want.keys()
    for alg in want:
        if alg == "legacy":
            assert np.array_equal(got[alg], want[alg])
            continue
        assert np.array_equal(got[alg]["out"], want[alg]["out"])
        assert {k: v for k, v in got[alg].items() if k != "out"} == \
            {k: v for k, v in want[alg].items() if k != "out"}


def test_context_parallel_ssm_card_against_cpu(card):
    kw = dict(shape=(1, 2048, 64), reps=1, verbose=False)
    got = context_parallel_ssm.run(card, **kw)
    want = context_parallel_ssm.run("cpu", **kw)
    for alg, w in want.items():
        assert (got[alg]["rounds"], got[alg]["ops"]) == (w["rounds"],
                                                         w["ops"])
        np.testing.assert_allclose(got[alg]["h"].cpu().numpy(),
                                   w["h"].numpy(), rtol=CP_TOL, atol=CP_TOL)
        assert got[alg]["max_err"] <= CP_TOL


def test_moe_dispatch_exscan_card_against_cpu(card):
    got = moe_dispatch_exscan.run(card, tokens_shape=(4, 32),
                                  verbose=False)
    want = moe_dispatch_exscan.run("cpu", tokens_shape=(4, 32),
                                   verbose=False)
    for alg, (lg, aux) in want.items():
        np.testing.assert_allclose(got[alg][0], lg, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[alg][1], aux, atol=ATOL, rtol=RTOL)


def test_train_smoke_card_against_cpu_and_resume(card, tmp_path):
    cfg = configs.get_smoke("llama3_8b")
    kw = dict(seq=32, batch=2, ckpt_every=2, verbose=False)
    got = train_smoke.train_smoke(cfg, 4, str(tmp_path / "card"), card, **kw)
    want = train_smoke.train_smoke(cfg, 4, str(tmp_path / "cpu"), "cpu",
                                   **kw)
    np.testing.assert_allclose(got["losses"], want["losses"], atol=ATOL,
                               rtol=RTOL)
    more = train_smoke.train_smoke(cfg, 6, str(tmp_path / "card"), card,
                                   **kw)
    assert more["start"] == 4 and len(more["losses"]) == 2
