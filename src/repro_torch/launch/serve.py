"""Batched serving entry point: prefill into the cache, then greedy
single-token decode, from the JAX package's ``launch/serve.py``.

Usage (on the card; ``--device cpu`` runs the plain versions here):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_1_6b \\
        --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --smoke --device cpu --batch 2 --prompt-len 8 --gen 4

One prefill writes the KV / state caches, then ``gen - 1`` batched
single-token decode steps follow, with greedy sampling.  Weights are
random, made from ``--seed``; the prompts too, as the reference makes
them (``numpy.random.default_rng(seed)``).

``--backend gloo|nccl`` serves the ``--data-mesh`` × ``--model-mesh``
ranks as that many processes (``dist.WorkerPool``, one rank a process;
under nccl one card a process), each holding its rows of the batch, its
share of the experts and of the dense layers (attention heads, FFN and
shared-expert columns, vocabulary: ``models.params.shard_params``) and,
with ``--data-mesh`` > 1, its data slice of every weight's d_model dim
(FSDP, gathered over the data processes a layer at a time), the
row-split products all-reduced over the model processes and the MoE
layers' tokens exchanged between them (``models.moe.moe_ffn``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        --smoke --device cpu --model-mesh 4 --backend gloo
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --device cpu --model-mesh 4 --backend gloo

Without ``--backend`` the ranks are stacked on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.models.model import Model
from repro_torch.serve.metrics import percentile


# seconds a request of the CLI's process pool may take: a full-width
# model's weights are drawn and served inside one
POOL_TIMEOUT_S = 600.0


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray  # (B, G) greedy tokens, the prefill's first
    prefill_logits: torch.Tensor  # (B, vocab_padded) fp32, last position
    prefill_s: float
    step_s: list  # seconds of each decode step, synchronised

    @property
    def decode_s(self) -> float:
        return float(sum(self.step_s))

    def tok_per_s(self) -> float:
        B = self.tokens.shape[0]
        return B * len(self.step_s) / self.decode_s if self.decode_s > 0 \
            else float("inf")


def serve_loop(model: Model, params, prompts, gen: int,
               prefix=None) -> ServeResult:
    """Prefill ``prompts`` (B, P) into a fresh cache of P + gen entries,
    then ``gen - 1`` greedy decode steps.  Each phase is timed on the
    host clock and ends in a synchronise of the model's device.  A model
    over processes serves its rows of the batch (``Model.rows``), and
    the result covers those rows.  ``prefix`` (B, n, d): a vision
    model's patch embeddings, prefilled before the prompts (n more
    cache entries)."""
    dev = model.dev
    batch = np.shape(prompts)[0]
    rows = model.rows(batch)
    prompts = torch.as_tensor(np.asarray(prompts)[rows],
                              dtype=torch.int32, device=dev)
    B, P = prompts.shape
    if prefix is not None:
        prefix = torch.as_tensor(np.asarray(prefix)[rows], device=dev)
        P += prefix.shape[1]
    cache = model.init_cache(B, P + gen)
    device_lib.synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = model.serve_step(params, cache, prompts, 0,
                                     prefix_embeds=prefix, last_only=True,
                                     batch=batch)
    next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    device_lib.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits[:, -1]

    generated = [next_tok]
    step_s = []
    for i in range(gen - 1):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, next_tok[:, None],
                                          P + i, batch=batch)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        device_lib.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        generated.append(next_tok)
    tokens = torch.stack(generated, dim=1).cpu().numpy()
    return ServeResult(tokens, prefill_logits, prefill_s, step_s)


def prompts_for(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """The CLI's prompts, as the reference draws them."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab, (batch, prompt_len)).astype(np.int32)


def serve_procs(pool, *, arch: str, smoke: bool, batch: int,
                prompt_len: int, gen: int, seed: int, ranks,
                repeats: int = 1, **kw) -> dict:
    """Serve over ``pool``'s processes, one rank of the (data, model)
    grid ``ranks`` each (``launcher.ENTRIES["serve"]``: each process
    builds the config, its weights from ``seed`` and the prompts; ``kw``
    are the entry's other keywords and the config's overrides).  Returns
    the tokens (B, gen) in batch order, the prefill logits of the last
    position in batch order, the prefill seconds and each decode step's,
    each the slowest process's (the last of ``repeats`` runs), and by
    process its parameter bytes ("param_bytes": dense, experts), its
    card's peak bytes ("peak_bytes", None off the card) and its
    weights' all-gathers over "data" ("fsdp_gather": calls, bytes it
    sent, seconds; ``params.fsdp_gathers`` a call), and the pool's
    ``DistResult``.  Under decode_ws (``sharding_strategy`` among the
    overrides) every process serves every row."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as PD
    from repro_torch.models.moe import held_rows

    if pool.nprocs != ranks[0] * ranks[1] or pool.p_intra != 1:
        raise ValueError(f"{ranks[0]} x {ranks[1]} ranks need as many "
                         f"processes of one rank, the pool has "
                         f"{pool.nprocs} of {pool.p_intra}")
    res = pool.call("serve", None, arch=arch, smoke=smoke, batch=batch,
                    prompt_len=prompt_len, gen=gen, seed=seed,
                    ranks=tuple(ranks), repeats=repeats,
                    mesh=(("data", ranks[0]), ("model", ranks[1])), **kw)
    tokens, logits, seconds = res.outputs[:3]
    mesh = make_host_mesh(*ranks)
    over = {k: v for k, v in kw.items()
            if k not in ("weights", "forward", "trace", "warm", "prefix")}
    cfg = (configs.get_smoke if smoke else configs.get)(arch, **over)
    # the first process holding each row: model rank 0 of its data shard
    # (under decode_ws every process holds every row)
    every = PD.ws_slices(cfg, mesh) > 1
    firsts = {}
    for k in range(pool.nprocs):
        firsts.setdefault(0 if every else held_rows(batch, mesh, k).start,
                          k)
    order = [firsts[start] for start in sorted(firsts)]
    return {"tokens": np.concatenate([tokens[k] for k in order]),
            "prefill_logits": np.concatenate([logits[k] for k in order]),
            "prefill_s": float(seconds[:, 0].max()),
            "step_s": [float(t) for t in seconds[:, 1:].max(axis=0)],
            "param_bytes": np.asarray(res.outputs[3]).tolist(),
            "peak_bytes": [m["allocated_peak_bytes"] for m in res.memory],
            "fsdp_gather": [{"calls": t["fsdp_gather"],
                             "bytes": t["fsdp_gather_bytes"],
                             "s": t["fsdp_gather_s"]} for t in res.traffic],
            "result": res}


def serve(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="serve the data x model ranks as that many "
                         "processes over this backend (nccl: one card a "
                         "process); without it they are stacked on one "
                         "card")
    args = ap.parse_args(argv)
    for name in ("batch", "prompt_len", "gen", "data_mesh", "model_mesh"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, "
                     f"got {getattr(args, name)}")

    get = configs.get_smoke if args.smoke else configs.get
    cfg = get(args.arch)
    if cfg.encoder_only:
        raise SystemExit("encoder-only arch has no decode loop")
    B, P, G = args.batch, args.prompt_len, args.gen
    ranks = (args.data_mesh, args.model_mesh)
    if args.backend is None:
        model = Model(cfg, ranks, device=args.device)
        params = model.init_params(args.seed)
        res = serve_loop(model, params, prompts_for(cfg, B, P, args.seed), G)
        out, prefill_s, step_s = res.tokens, res.prefill_s, res.step_s
        memory = None
    else:
        from repro_torch.dist import WorkerPool

        with WorkerPool(ranks[0] * ranks[1], backend=args.backend,
                        device=args.device, timeout=POOL_TIMEOUT_S) as pool:
            got = serve_procs(pool, arch=args.arch, smoke=args.smoke,
                              batch=B, prompt_len=P, gen=G, seed=args.seed,
                              ranks=ranks)
        out, prefill_s, step_s = got["tokens"], got["prefill_s"], \
            got["step_s"]
        memory = got["result"].memory
        print(f"{ranks[0]} x {ranks[1]} ranks as {len(memory)} processes "
              f"over {args.backend}")

    print(f"prefill {P} tokens x {B} reqs: {prefill_s*1e3:.1f} ms")
    if G == 1:
        # the prompt's last-token argmax IS the only generated token —
        # there are no decode steps, so no decode rate exists to report
        print("decode: 0 steps (--gen 1 generates the prefill "
              "token only)")
    else:
        decode_s = sum(step_s)
        print(f"decode {G-1} steps x {B} reqs: {decode_s*1e3:.1f} ms "
              f"({B * (G - 1) / decode_s:.1f} tok/s)")
        print(f"decode step latency: p50 "
              f"{percentile(step_s, 50)*1e3:.2f} ms, p99 "
              f"{percentile(step_s, 99)*1e3:.2f} ms")
    for k, mem in enumerate(memory or ()):
        gathers = got["fsdp_gather"][k]
        print(f"process {k} on {mem['device']}: parameters "
              f"{sum(got['param_bytes'][k])} B, resident "
              f"{mem['resident_bytes']} B, card peak "
              f"{mem['allocated_peak_bytes']} B, {gathers['calls']} "
              f"all-gathers of weights over data, {gathers['bytes']} B "
              f"sent")
    print(f"first request tokens: {out[0][:16]}")
    if memory is not None:
        print(f"tokens in batch order: {out.tolist()}")
    return out


if __name__ == "__main__":
    serve()
