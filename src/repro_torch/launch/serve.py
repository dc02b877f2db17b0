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


def serve_loop(model: Model, params, prompts, gen: int) -> ServeResult:
    """Prefill ``prompts`` (B, P) into a fresh cache of P + gen entries,
    then ``gen - 1`` greedy decode steps.  Each phase is timed on the
    host clock and ends in a synchronise of the model's device."""
    dev = model.dev
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                              device=dev)
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen)
    device_lib.synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = model.serve_step(params, cache, prompts, 0,
                                     last_only=True)
    next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    device_lib.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits[:, -1]

    generated = [next_tok]
    step_s = []
    for i in range(gen - 1):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, next_tok[:, None],
                                          P + i)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        device_lib.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        generated.append(next_tok)
    tokens = torch.stack(generated, dim=1).cpu().numpy()
    return ServeResult(tokens, prefill_logits, prefill_s, step_s)


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
    args = ap.parse_args(argv)
    for name in ("batch", "prompt_len", "gen", "data_mesh", "model_mesh"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, "
                     f"got {getattr(args, name)}")

    get = configs.get_smoke if args.smoke else configs.get
    cfg = get(args.arch)
    if cfg.encoder_only:
        raise SystemExit("encoder-only arch has no decode loop")
    model = Model(cfg, (args.data_mesh, args.model_mesh), device=args.device)
    params = model.init_params(args.seed)

    B, P, G = args.batch, args.prompt_len, args.gen
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab, (B, P)).astype(np.int32)
    res = serve_loop(model, params, prompts, G)

    out = res.tokens
    print(f"prefill {P} tokens x {B} reqs: {res.prefill_s*1e3:.1f} ms")
    if G == 1:
        # the prompt's last-token argmax IS the only generated token —
        # there are no decode steps, so no decode rate exists to report
        print("decode: 0 steps (--gen 1 generates the prefill "
              "token only)")
    else:
        print(f"decode {G-1} steps x {B} reqs: {res.decode_s*1e3:.1f} ms "
              f"({res.tok_per_s():.1f} tok/s)")
        print(f"decode step latency: p50 "
              f"{percentile(res.step_s, 50)*1e3:.2f} ms, p99 "
              f"{percentile(res.step_s, 99)*1e3:.2f} ms")
    print(f"first request tokens: {out[0][:16]}")
    return out


if __name__ == "__main__":
    serve()
