"""End-to-end training example: a llama-family model of about 100M
parameters, a few hundred AdamW steps on ``--device`` (the card by
default), with checkpoint and restart.

A run restores the latest checkpoint in ``--ckpt`` and trains on from
its step to ``--steps``; it saves every 100 steps (in the background)
and at the end.  Running it again with a larger ``--steps`` on the same
directory resumes.

    PYTHONPATH=src python -m repro_torch.examples.train_smoke
        [--steps 200] [--ckpt DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import tempfile
import time


def config():
    """llama3-8b cut to 8 layers, d_model 512, 8 heads (4 kv), d_ff 1536,
    vocab 8192, fp32."""
    from repro_torch import configs

    return dataclasses.replace(
        configs.get("llama3-8b"),
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, d_ff=1536,
        vocab=8192, dtype="float32")


def train_smoke(cfg, steps: int, ckpt: str, device, *, seq: int = 256,
                batch: int = 8, ckpt_every: int = 100,
                verbose: bool = True) -> dict:
    """Train ``cfg`` from the latest checkpoint in ``ckpt`` (or from
    weights drawn on the host from seed 0) up to ``steps``.  Returns
    ``{"start": step, "losses": [...], "seconds": [...]}``: each step's
    loss and seconds (the host clock around the step and the read of its
    loss, which waits for the device)."""
    import torch

    from repro_torch.benchmarks.common import host_weights
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import restore_into
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw_init

    say = print if verbose else (lambda *a, **k: None)
    say(f"model: {PD.count_params(cfg)/1e6:.1f}M params")
    model = Model(cfg, (1, 1), device)
    dev = model.dev
    params = host_weights(model, trainable=True)  # drawn on the host
    opt = adamw_init(params)
    store = CheckpointStore(ckpt)
    start = store.latest_step() or 0
    if start:
        state = {"params": params, "opt": opt}
        restore_into(state, store.restore(start, state))
        say(f"resumed from step {start}")

    step_fn = make_train_step(cfg, (1, 1), lr_peak=1e-3, warmup=20,
                              total_steps=steps, model=model)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch))
    losses, seconds = [], []
    for step in range(start, steps):
        b = data.batch(step)
        feed = {k: torch.from_numpy(b[k]).to(dev)
                for k in ("tokens", "labels")}
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, feed, step)
        losses.append(float(m["loss"]))  # waits for the step
        seconds.append(time.perf_counter() - t0)
        if step % 20 == 0:
            say(f"step {step:4d} loss {losses[-1]:.4f}")
        if (step + 1) % ckpt_every == 0:
            store.save(step + 1, {"params": params, "opt": opt},
                       blocking=False)
    store.wait()
    store.save(steps, {"params": params, "opt": opt})
    if losses:
        say(f"done; final loss {losses[-1]:.4f}; median step "
            f"{statistics.median(seconds) * 1e3:.2f} ms; checkpoints in "
            f"{ckpt}")
    return {"start": start, "losses": losses, "seconds": seconds}


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_smoke"))
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    train_smoke(config(), args.steps, args.ckpt,
                device_lib.resolve(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
