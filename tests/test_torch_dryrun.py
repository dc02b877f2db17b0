"""The port's dry run: the kernels' meta rules, the meta trace, the
priced collectives, the probes, the CLI and the roofline table, on the
CPU.

The meta rules are held to the plain versions' shapes and dtypes; the
trace's FLOPs to ``FlopCounterMode`` over the same smoke step run on the
CPU; the probe extrapolation to the whole trace; the collectives of
smoke llama3 (tp, fsdp_sp) and qwen2_moe (tp) at ranks (2, 4) to counts
made by hand from the configs; ``roofline_table.fmt`` to the JAX
package's on the same cells.
"""

import dataclasses
import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tconfigs
from repro_torch.benchmarks import roofline_table
from repro_torch.benchmarks import run as run_harness
from repro_torch.kernels import moe_routing as mr
from repro_torch.kernels import scan_engine as se
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from repro_torch.optim import adamw_init

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = make_host_mesh(2, 4)


def _meta(t):
    return t.to("meta") if isinstance(t, torch.Tensor) else tuple(
        x.to("meta") for x in t)


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        if isinstance(w, (tuple, list)):
            _same(g, w)
            continue
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype


@pytest.fixture
def counts():
    se.reset_meta_counts()
    before = se.launch_counts()
    yield se.META_LAUNCHES, se.META_BYTES
    assert se.launch_counts() == before  # meta calls launch nothing
    se.reset_meta_counts()


# ------------------------------ meta rules ------------------------------


@pytest.mark.parametrize("op,dtype", [("add", torch.int32),
                                      ("xor", torch.int64),
                                      ("max", torch.float32),
                                      ("affine", torch.float32)])
def test_round_rules_match_plain_shapes(op, dtype, counts):
    p, n = 5, 7
    g = torch.Generator().manual_seed(0)

    def rand(rows=p):
        if op == "affine":
            return (torch.rand(rows, n, generator=g, dtype=dtype),
                    torch.rand(rows, n, generator=g, dtype=dtype))
        return torch.randint(0, 9, (rows, n), generator=g).to(dtype)

    a, b, pf = rand(), rand(1), rand()
    src = torch.tensor([-1, 0, 1, 2, 3], dtype=torch.int32)
    low = torch.tensor([1, 0, 1, 0, 1], dtype=torch.int32)
    ra = se.Rows(a, src)
    rm = se.Rows(_meta(a), src.to("meta"))
    mlow = low.to("meta")
    _same(se.combine(op, rm, _meta(b), mask=mlow),
          se.combine(op, ra, b, mask=low))
    _same(se.exchange(op, _meta(a), _meta(pf), mlow),
          se.exchange(op, a, pf, low))
    _same(se.scan_reduce(op, rm, _meta(a), _meta(pf), mlow,
                         commutative=op != "affine"),
          se.scan_reduce(op, ra, a, pf, low, commutative=op != "affine"))
    leaves = 2 if op == "affine" else 1
    row = n * dtype.itemsize * leaves
    want = {"combine": p * row + 5 * 4 + row + 5 * 4 + p * row,
            "exchange": 2 * p * row + 5 * 4 + p * row,
            "scan_reduce": p * row + 5 * 4 + 2 * p * row + 5 * 4
            + 2 * p * row}
    launches, nbytes = counts
    assert launches == {"combine": 1, "exchange": 1, "scan_reduce": 1}
    assert nbytes == want


def test_tree_forms_and_block_combine_take_the_rules(counts):
    from repro_torch.core import monoid as monoid_lib

    m = monoid_lib.get("add")
    lo = {"a": torch.ones(4, 3, dtype=torch.int32),
          "b": torch.ones(4, 2, dtype=torch.int32)}
    hi = {k: v + 1 for k, v in lo.items()}
    keep = torch.tensor([True, False, True, True])
    got = se.tree_combine(m, {k: _meta(v) for k, v in lo.items()},
                          {k: _meta(v) for k, v in hi.items()},
                          keep=keep.to("meta"))
    _same([got["a"], got["b"]], [lo["a"], lo["b"]])
    _same(se.block_combine(_meta(lo["a"]), _meta(hi["a"]), "add"),
          lo["a"])
    assert counts[0] == {"combine": 2}  # one launch per dtype group


@pytest.mark.parametrize("traj,final,exclusive", [(True, False, True),
                                                  (False, True, False),
                                                  (True, True, False)])
def test_monoid_chunk_rule(traj, final, exclusive, counts):
    x = torch.rand(3, 11, 5)
    init = torch.rand(3, 5)
    want = se.monoid_chunk(x, "add", init=init, traj=traj, final=final,
                           exclusive=exclusive)
    got = se.monoid_chunk(_meta(x), "add", init=_meta(init), traj=traj,
                          final=final, exclusive=exclusive)
    _same(got, want)
    out = (x.numel() if traj else 0) + (15 if final else 0)
    assert counts == ({"monoid_chunk": 1},
                      {"monoid_chunk": 4 * (x.numel() + 15 + out)})
    with pytest.raises(TypeError):
        se.monoid_chunk(_meta(x), "xor")


@pytest.mark.parametrize("r", (1, 4))
def test_affine_chunk_rules(r, counts):
    G, T, D = 2, 9, 8
    a = torch.rand(G, T, D // r)
    b = torch.rand(G, T, D)
    h0 = torch.rand(G, D)
    flags = dict(a_traj=True, h_traj=True, a_final=True, h_final=True)
    _same(se.affine_chunk(_meta(a), _meta(b), h0=_meta(h0), **flags),
          se.affine_chunk(a, b, h0=h0, **flags))
    _, h, _, _ = se.affine_chunk(a, b, h0=h0, exclusive=True)
    gy, gh = torch.rand(G, T, D), torch.rand(G, D)
    _same(se.affine_chunk_bwd(_meta(a), _meta(gy), _meta(gh), _meta(h),
                              h0=_meta(h0), exclusive=True),
          se.affine_chunk_bwd(a, gy, gh, h, h0=h0, exclusive=True))
    na, nb = a.numel() * 4, b.numel() * 4
    assert counts == (
        {"affine_chunk": 1, "affine_chunk_bwd": 1},
        {"affine_chunk": na + nb + G * D * 4 + na + nb + G * D // r * 4
         + G * D * 4,
         "affine_chunk_bwd": na + 2 * nb + G * D * 4 + G * D * 4
         + na + nb + G * D * 4})


def test_affine_chunk_rule_keeps_the_kernels_refusals(counts):
    a = torch.rand(2, 9, 8, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        se.affine_chunk(a, a.detach())
    a = torch.rand(2, 9, 3, device="meta")
    with pytest.raises(TypeError, match="r = 3"):
        se.affine_chunk_bwd(a, None, None, torch.rand(2, 9, 9,
                                                      device="meta"),
                            exclusive=True)


def test_moe_routing_rule(counts):
    ids = torch.randint(0, 6, (3, 10, 2), dtype=torch.int32)
    _same(mr.moe_routing(_meta(ids), num_experts=6),
          mr.moe_routing(ids, num_experts=6))
    assert counts == ({"moe_routing": 1},
                      {"moe_routing": 2 * ids.numel() * 4 + 3 * 6 * 4})


# ------------------------------ the trace ------------------------------


def test_trace_counts_bytes_and_the_live_peak():
    x = torch.empty(256, device="meta")
    y = torch.empty(256, device="meta")
    trace = steps.MetaTrace((x, y))
    with trace:
        z = x + y  # 3 · 1 KiB
        v = z.view(16, 16)  # a view: nothing
        w = v.t().contiguous()  # a copy: 2 KiB
        del z, v
        u = w * 2  # 2 KiB; w and u live with x and y
        del w
    assert trace.arg_bytes == 2048
    assert trace.bytes == 3 * 1024 + 2 * 1024 + 2 * 1024
    assert trace.peak == 2048 + 2 * 1024
    del u
    assert trace.cur == 2048


def _smoke_step(name, kind, strategy="tp", B=8, S=16):
    cfg = tconfigs.get_smoke(name, sharding_strategy=strategy)
    return cfg, steps.ShapeSpec(f"{kind}_b{B}_s{S}", kind, S, B)


@pytest.mark.parametrize("name,kind", [("llama3_8b", "train"),
                                       ("qwen2_moe_a2_7b", "prefill"),
                                       ("rwkv6_1_6b", "train")])
def test_traced_flops_equal_flop_counter_on_the_cpu(name, kind):
    cfg, shape = _smoke_step(name, kind)
    comp = steps.lower_cell(cfg, shape, MESH).compile()
    model = Model(cfg, MESH, device="cpu")
    params = model.init_params(0, trainable=kind == "train")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (shape.batch, shape.seq)).astype(np.int32))
    if kind == "train":
        step = steps.make_train_step(cfg, MESH, model=model)
        args = (params, adamw_init(params),
                {"tokens": tokens, "labels": tokens}, 0)
    else:
        step = steps.make_serve_step(cfg, MESH, shape, model=model)
        args = (params, model.init_cache(shape.batch, shape.seq), tokens, 0)
    se.reset_meta_counts()
    with FlopCounterMode(display=False) as fc:
        step(*args)
    assert comp.flops_total == fc.get_total_flops() > 0
    assert se.META_LAUNCHES == {}  # the CPU ran the plain versions
    n = MESH.size
    assert comp.cost_analysis()["flops"] == comp.flops_total / n
    mem = comp.memory_analysis()
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert comp.peak_bytes_total >= comp.argument_bytes_total


@pytest.mark.parametrize("name,kind", [("llama3_8b", "train"),
                                       ("jamba_1_5_large_398b", "train"),
                                       ("qwen2_moe_a2_7b", "prefill")])
def test_probe_extrapolation_equals_the_whole_trace(name, kind):
    cfg, shape = _smoke_step(name, kind)
    cfg = dataclasses.replace(cfg, n_layers=4 * len(cfg.pattern()))
    whole = steps.lower_cell(cfg, shape, MESH).compile()
    p1 = dryrun._probe(cfg, shape, MESH, 1)
    p2 = dryrun._probe(cfg, shape, MESH, 2)
    flops, nbytes, coll = dryrun._extrapolate(p1, p2, cfg.n_repeats)
    cost = whole.cost_analysis()
    assert flops == cost["flops"]
    assert nbytes == cost["bytes accessed"]
    want = whole.collectives()
    assert coll.op_counts == want.op_counts
    assert coll.op_bytes == pytest.approx(want.op_bytes, rel=1e-12)


# ------------------------------ collectives ------------------------------


def test_llama3_tp_collectives_by_hand():
    """Smoke llama3 (d 64, 4 heads of 16, 2 kv heads, d_ff 192, vocab
    256, 2 layers, fp32, untied head) training at (data 2, model 4),
    B = 8, S = 16, remat.  FSDP over "data" (g = 2; wire = out/2 = one
    rank's shard): each block leaf gathered twice (forward, recompute),
    the two top leaves once, every gradient reduce-scattered once.  TP
    (g = 4): attn.wo and ffn.w_down outputs, (4, 16, 64) fp32 = 16 KiB
    a rank, all-reduced in the forward (2 a layer), the recompute (wo
    only: w_down's output is not needed again) and the backward (2 a
    layer): 10, each 2 · 16 KiB · 3/4 on the wire."""
    cfg, shape = _smoke_step("llama3_8b", "train")
    got = steps.lower_cell(cfg, shape, MESH).compile().collectives()
    top = 2 * (256 * 64 // 8 * 4)  # tok_embed, lm_head shards
    blocks = 2 * 4 * (64 * 64 // 8 + 2 * 64 * 32 // 8 + 64 * 64 // 8
                      + 3 * 64 * 192 // 8)  # wq, wk, wv, wo, ffn
    assert got.op_counts == {"all-gather": 2 + 7 * 2, "reduce-scatter": 9,
                             "all-reduce": 10}
    assert got.op_bytes == pytest.approx({
        "all-gather": top + 2 * blocks, "reduce-scatter": top + blocks,
        "all-reduce": 10 * 2 * 16384 * 3 / 4})


def test_llama3_fsdp_sp_collectives_by_hand():
    """The same step under fsdp_sp: "embed" over (data, model) (g = 8:
    wire = 7 shards a gather, 7 a reduce-scatter), no TP all-reduce, and
    attention's k and v, (4, 16, 32) fp32 = 8 KiB a rank with the whole
    sequence, gathered over "model" (g = 4) in the forward and the
    recompute (8) and reduce-scattered in the backward (4)."""
    cfg, shape = _smoke_step("llama3_8b", "train", "fsdp_sp")
    got = steps.lower_cell(cfg, shape, MESH).compile().collectives()
    top = 2 * (256 * 64 // 8 * 4)
    blocks = 2 * 4 * (64 * 64 // 8 + 2 * 64 * 32 // 8 + 64 * 64 // 8
                      + 3 * 64 * 192 // 8)
    kv = 8192 * 3 / 4
    assert got.op_counts == {"all-gather": 16 + 8, "reduce-scatter": 9 + 4}
    assert got.op_bytes == pytest.approx({
        "all-gather": 7 * (top + 2 * blocks) + 8 * kv,
        "reduce-scatter": 7 * (top + blocks) + 4 * kv})


def test_qwen2_moe_tp_collectives_by_hand():
    """Smoke qwen2_moe (d 64, 4 heads = 4 kv heads of 16, 8 experts
    padded to 16 of f 32, top-2, two shared experts of f 64, 2 layers,
    fp32) prefilling 8 × 16 tokens at (data 2, model 4).  B·S·k = 256:
    weight-stationary (tokens replicated over "data"), token-split over
    "model" (4 groups of n0 = 32, capacity 8).  A layer: the (128, 64)
    dispatch buffer there and back (all-to-all, g = 4), the (128, 64)
    outputs and (128, 2) kept flags gathered (g = 4), the (2, 4, 32, 32)
    gate/up pair and the (4, 32, 64) output summed over "data" (g = 2),
    and the TP all-reduces of attn.wo and the shared ffn.w_down, (4, 16,
    64) each; FSDP gathers every leaf with an "embed" dim once, but the
    expert weights; the offsets' scan_total rounds as permutes."""
    cfg, shape = _smoke_step("qwen2_moe_a2_7b", "prefill")
    comp = steps.lower_cell(cfg, shape, MESH).compile()
    got = comp.collectives()
    layers = 2
    shard = {"tok_embed": 256 * 64, "lm_head": 64 * 256}
    block = {"wq": 64 * 64, "wk": 64 * 64, "wv": 64 * 64, "wo": 64 * 64,
             "router": 64 * 16, "shared_gate": 64 * 64,
             "shared_up": 64 * 64, "shared_down": 64 * 64}
    fsdp = (sum(v // 8 for v in shard.values()) * 4
            + sum(v * layers // 8 if k != "router" else v * layers // 2
                  for k, v in block.items()) * 4)
    a2a = 128 * 64 * 4 * 3 / 4
    ts = (128 * 64 * 4 + 128 * 2 * 4) * 3 / 4
    ws = 2 * (2 * 4 * 32 * 32 * 4) / 2 + 2 * (4 * 32 * 64 * 4) / 2
    tp = 2 * (4 * 16 * 64 * 4) * 3 / 4
    rounds = comp.scan_stats.bytes_per_round
    assert got.op_counts == {
        "all-gather": 2 + 8 + layers * 2, "all-to-all": layers * 2,
        "all-reduce": layers * 4,
        "collective-permute": len(rounds)}
    assert got.op_bytes == pytest.approx({
        "all-gather": fsdp + layers * ts, "all-to-all": layers * 2 * a2a,
        "all-reduce": layers * (ws + 2 * tp),
        "collective-permute": float(sum(rounds))})


# ------------------------------ the CLI ------------------------------


def test_dryrun_cli_cell_and_roofline_rows(tmp_path, monkeypatch, capsys):
    out = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k",
                        "--no-probes", "--json", str(out)]) == 0
    (cell,) = json.loads(out.read_text())
    assert cell["status"] == "ok" and cell["per_device"] == "even split"
    assert cell["hardware"]["peak_flops"] == rl.PEAK_FLOPS == 989e12
    assert cell["hardware"]["hbm_bw"] == rl.HBM_BW == 3.35e12
    assert cell["fits_hbm"] is True
    assert cell["memory_s"] == cell["bytes_per_device"] / rl.HBM_BW
    cfg = tconfigs.get("rwkv6_1_6b")
    args, shard, _ = steps.input_specs(cfg, steps.SHAPES["decode_32k"],
                                       dryrun.make_production_mesh())
    assert cell["memory_analysis"]["argument_bytes"] == \
        steps._shard_bytes(args, shard)
    rows = run_harness.roofline_rows([], path=str(out))
    key = "roofline/rwkv6_1_6b/decode_32k/16x16"
    assert [k for k, _, _ in rows] == [key + "/bound_ms",
                                       key + "/mfu_bound"]
    assert rows[0][1] == 1e3 * max(cell["compute_s"], cell["memory_s"],
                                   cell["collective_s"])
    assert run_harness.roofline_rows([], path=str(tmp_path / "no")) == []


def test_dryrun_cli_records_failures(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no trace")

    monkeypatch.setattr(dryrun.steps_lib, "lower_cell", boom)
    out = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "hubert_xlarge", "--shape",
                        "decode_32k", "--json", str(out)]) == 0  # a skip
    assert json.loads(out.read_text())[0]["status"] == "skipped"
    assert dryrun.main(["--arch", "hubert_xlarge", "--shape", "train_4k",
                        "--json", str(out)]) == 1
    (cell,) = json.loads(out.read_text())
    assert cell["status"] == "FAILED" and "no trace" in cell["error"]


def test_roofline_table_fmt_matches_reference():
    spec = importlib.util.spec_from_file_location(
        "reference_roofline_table", ROOT / "benchmarks" / "roofline_table.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    cells = [
        {"arch": "a", "shape": "train_4k", "mesh": "16x16", "status": "ok",
         "compute_s": 0.25, "memory_s": 1.5, "collective_s": 0.125,
         "dominant": "memory", "useful_flops_fraction": 0.75,
         "mfu_bound": 0.0625, "fits_hbm": False,
         "memory_analysis": {"argument_bytes": 1e9, "peak_bytes": 9e10}},
        {"arch": "b", "shape": "long_500k", "mesh": "16x16",
         "status": "skipped", "reason": "pure full-attention arch: 500k "
                                        "context needs sub-quadratic"},
        {"arch": "c", "shape": "decode_32k", "mesh": "2x16x16",
         "status": "FAILED", "error": "x"},
    ]
    assert roofline_table.fmt(cells) == ref.fmt(cells)
    fit = roofline_table.fmt_fit(cells).splitlines()
    assert fit[2] == "| a | train_4k | 16x16 | 1.00 | 90.00 | no |"
    assert len(fit) == 3
    assert math.isclose(rl.HBM_BYTES, 80e9)
