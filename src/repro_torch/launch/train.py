"""Training driver with checkpoint/restart, from the JAX package's
``launch/train.py``.

Usage (on the card; ``--device cpu`` runs the plain versions here):

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_1_6b \\
        --steps 6 --batch 4 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --smoke --device cpu --steps 12 --batch 2 --seq 64 \\
        --ckpt-dir /tmp/ckpt --ckpt-every 6

What it drives, as the reference does:
  * the deterministic resumable data pipeline (seeded by step),
  * checkpoints saved on a thread with an atomic commit, and a resume
    from the latest committed one,
  * step-time telemetry with an EWMA straggler watchdog (each step's
    time ends in a synchronise of the device),
  * the planner's exscan for the MoE dispatch (``--exscan auto`` by
    default), priced by a calibrated profile where one is stored.

``--data-mesh`` and ``--model-mesh`` become the model's ranks (stacked
on one card's leading axes).  Weights are random, made from ``--seed``
on the device.  ``--autotune`` runs the online cost-profile loop
(``core/autotune.py``): every ``--autotune-every`` steps, outside the
timed step, it times one planned exscan beside the step (``probe``) and
refits the planner's constants when due.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import time

import numpy as np
import torch

from repro_torch import _tree, configs
from repro_torch import device as device_lib
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import scan_api
from repro_torch.core.scan_api import ScanSpec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import make_train_step
from repro_torch.models import params as PD
from repro_torch.models.model import Model
from repro_torch.optim import adamw_init


class StragglerWatchdog:
    """EWMA step-time tracker; flags steps slower than ``k`` x EWMA.

    On a cluster the flag would feed the controller's drop-and-rebalance
    policy; here it gives the telemetry and the hook."""

    def __init__(self, alpha: float = 0.1, k: float = 3.0):
        self.alpha = alpha
        self.k = k
        self.ewma = None
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.k * self.ewma
        if slow:
            self.flagged.append(step)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


def restore_into(tree, arrays) -> None:
    """Copy a restored numpy tree into the live tensors of ``tree``."""
    with torch.no_grad():
        for t, a in zip(_tree.leaves(tree), _tree.leaves(arrays)):
            t.copy_(device_lib.leaf_to_torch(a, t.device))


def step_batch(cfg, data, step: int, args, rng, dev) -> dict:
    """The batch of ``step`` on ``dev``, as the reference builds it: the
    pipeline's tokens and labels, stub vision prefixes and audio frames
    drawn from one numpy stream."""
    batch = dict(data.batch(step))
    batch.pop("positions", None)
    batch.pop("segments", None)
    dtype = PD.torch_dtype(cfg)
    out = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if cfg.frontend == "vision":
        out["prefix"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.n_prefix, cfg.d_model))).to(dev, dtype)
    if cfg.frontend == "audio":
        out = {"embeds": torch.from_numpy(rng.standard_normal(
                   (args.batch, args.seq, cfg.d_model))).to(dev, dtype),
               "labels": out["labels"]}
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--exscan", default="auto",
                    choices=["auto", "123", "1doubling", "two_op",
                             "native", "ring"])
    ap.add_argument("--profile-dir", default=None,
                    help="calibrated cost-profile store (default: "
                         "tune/profiles/torch; see python -m "
                         "repro_torch.core.tune)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--autotune", action="store_true",
                    help="online cost-profile refits from probes "
                         "timed beside the steps")
    ap.add_argument("--autotune-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What a run leaves: the model, its state after the last step (the
    parameters and moments, updated in place), each step's metrics as
    floats and seconds, and the step function and batches it ran, so a
    caller can run one more step under a profiler."""

    model: Model
    params: dict
    opt: object
    start_step: int
    logs: list  # one dict a step: step, loss, ce, grad_norm, lr, seconds
    step_fn: object
    batch_of: object  # step -> batch on the device
    tuner: object = None  # the AutoTuner of --autotune

    @property
    def losses(self) -> list:
        return [log["loss"] for log in self.logs]


def run(args: argparse.Namespace, on_step=None) -> TrainRun:
    """Train as ``args`` say.  ``on_step(step, params, opt, log)``, when
    given, is called after each step's synchronise (outside its time)."""
    if args.autotune and args.autotune_every < 1:
        raise ValueError(f"--autotune-every must be >= 1, got "
                         f"{args.autotune_every}")
    get = configs.get_smoke if args.smoke else configs.get
    cfg = get(args.arch, scan=ScanSpec(kind="exclusive",
                                       algorithm=args.exscan))
    dev = device_lib.resolve(args.device)
    mesh = mesh_lib.make_host_mesh(args.data_mesh, args.model_mesh)
    grid = tuple(zip(mesh.axis_names, mesh.sizes))
    # planner pricing provenance: a profile calibrated on this card and
    # rank grid (core/tune.py) over the default constants, and which
    profile = mesh_lib.use_calibrated_profile(
        grid, directory=args.profile_dir, device=dev)
    prov = profile.provenance(mesh_lib.mesh_fingerprint(grid, dev))
    print(f"[planner] cost profile: {prov['source']} "
          f"fingerprint={prov['fingerprint']} "
          f"mesh={prov['mesh_fingerprint']}"
          + (f" fit_residuals={prov['fit_residuals']}"
             if prov["fit_residuals"] else ""))
    model = Model(cfg, mesh, device=dev)
    params = model.init_params(args.seed, trainable=True)
    opt = adamw_init(params)
    start_step = 0

    store = None
    if args.ckpt_dir:
        store = CheckpointStore(args.ckpt_dir)
        if args.resume == "auto":
            latest = store.latest_step()
            if latest is not None:
                state = {"params": params, "opt": opt}
                restore_into(state, store.restore(latest, state))
                start_step = latest
                print(f"[resume] restored step {latest}")

    step_fn = make_train_step(
        cfg, mesh, lr_peak=args.lr, warmup=max(1, args.steps // 20),
        total_steps=args.steps, model=model)
    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    rng = np.random.default_rng(1234)

    def batch_of(step: int) -> dict:
        return step_batch(cfg, data, step, args, rng, dev)

    watchdog = StragglerWatchdog()
    tuner = None
    if args.autotune:
        from repro_torch.core.autotune import AutoTuner
        from repro_torch.core.schedule import StackedExecutor

        # the training scans run inside the step, so the online loop
        # times the planned schedule beside it (tuner.probe) at probe
        # cadence; an install reprices every later plan() call
        tuner = AutoTuner(profile, mesh_fingerprint="train-online")
        probe_axes = mesh_lib.batch_axes(mesh)
        probe_spec = cfg.scan.over(
            probe_axes[-1] if probe_axes else "data", monoid="add")
        probe_p = max(2, mesh_lib.data_degree(mesh))
        probe_bytes = 8 * max(1, getattr(cfg, "n_experts", 8) or 8)
        probe_executor = StackedExecutor(dev)
    logs = []
    # what set-up left alive stays out of the cyclic collector's full
    # passes: with a large heap one took about 170 ms inside a step, the
    # card idle meanwhile
    gc.collect()
    gc.freeze()
    # "auto" scan specs price each rank axis by its tier
    with scan_api.use_cost_model(mesh_lib.axis_cost_model):
        for step in range(start_step, args.steps):
            batch = batch_of(step)
            device_lib.synchronize(dev)
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch, step)
            log = {k: float(v) for k, v in metrics.items()}
            device_lib.synchronize(dev)
            dt = time.perf_counter() - t0
            log.update(step=step, seconds=dt)
            slow = watchdog.observe(step, dt)
            logs.append(log)
            if step % args.log_every == 0 or slow:
                print(f"step {step:5d} loss {log['loss']:.4f} "
                      f"ce {log['ce']:.4f} gnorm {log['grad_norm']:.3f} "
                      f"{dt*1e3:.0f} ms{'  [STRAGGLER]' if slow else ''}")
            if on_step is not None:
                on_step(step, params, opt, log)
            if tuner is not None and step % args.autotune_every == 0:
                tuner.probe(probe_spec, probe_p, probe_bytes,
                            executor=probe_executor)
                res = tuner.maybe_refit()
                if res.installed:
                    prov = res.profile.provenance()
                    print(f"[autotune] step {step}: installed refit "
                          f"fingerprint={prov['fingerprint']} "
                          f"drift={dict(res.drift)} "
                          f"plans_dropped={res.plans_dropped}")
            if store and args.ckpt_every and \
                    (step + 1) % args.ckpt_every == 0:
                store.save(step + 1, {"params": params, "opt": opt},
                           blocking=False)
    gc.unfreeze()
    if store:
        store.wait()
        store.save(args.steps, {"params": params, "opt": opt})
    if tuner is not None:
        print(f"[autotune] refits={tuner.refits} "
              f"installs={tuner.installs} "
              f"plans_dropped={tuner.plans_dropped} "
              f"reservoirs={tuner.reservoir_sizes()}")
    if logs:
        print(f"final loss {logs[-1]['loss']:.4f} "
              f"(first {logs[0]['loss']:.4f})")
    return TrainRun(model, params, opt, start_step, logs, step_fn, batch_of,
                    tuner)


def train(argv=None) -> list:
    """The CLI: train as ``argv`` says; returns each step's loss."""
    return run(parse_args(argv)).losses


if __name__ == "__main__":
    train()
