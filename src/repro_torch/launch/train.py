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

``--backend gloo|nccl`` trains the ``--data-mesh`` × ``--model-mesh``
ranks as that many processes (``dist.WorkerPool``, one rank a process;
under nccl one card a process), as ``serve --backend`` serves them:
each holds, updates and checkpoints only its share (its experts, its
part of the dense layers over "model", its slice of every "embed" dim
over "data": ``models.params.shard_params``) and its data shard's rows
of each global batch; the loss, the gradients' norm and the metrics are
the global batch's (``launch.steps.make_train_step``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --device cpu --backend gloo --data-mesh 2 --model-mesh 2 \
        --steps 3 --batch 4 --seq 32

With ``--backend`` the ``--autotune`` probe runs over the pool's
"data" processes (the reference's scan over the mesh's last batch
axis, p = the data degree) on each process's executor, or, where one
data process leaves no group for its p = 2, stacked on each process's
device; every process records the slowest process's seconds, so all
refit and install alike, at the same steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from repro_torch import _tree, configs
from repro_torch import device as device_lib
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import scan_api
from repro_torch.core.scan_api import ScanSpec
from repro_torch.core.schedule import SEQ_KINDS, TRAIN_KINDS
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


def step_batch(cfg, data, step: int, args, rng, dev,
               rows: slice | None = None) -> dict:
    """The batch of ``step`` on ``dev``, as the reference builds it: the
    pipeline's tokens and labels, stub vision prefixes and audio frames
    drawn from one numpy stream; with ``rows``, those rows of it (a
    process's)."""
    batch = dict(data.batch(step, rows))
    batch.pop("positions", None)
    batch.pop("segments", None)
    dtype = PD.torch_dtype(cfg)
    out = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    every = slice(None) if rows is None else rows
    if cfg.frontend == "vision":
        out["prefix"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.n_prefix, cfg.d_model))[every]).to(dev, dtype)
    if cfg.frontend == "audio":
        out = {"embeds": torch.from_numpy(rng.standard_normal(
                   (args.batch, args.seq, cfg.d_model))[every]).to(dev,
                                                                  dtype),
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
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="train the data x model ranks as that many "
                         "processes over this backend (nccl: one card a "
                         "process); without it they are stacked on one "
                         "card")
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
    # over processes: each step's collectives (``SPMDExecutor.traffic``)
    traffic: list = dataclasses.field(default_factory=list)

    @property
    def losses(self) -> list:
        return [log["loss"] for log in self.logs]


def config_of(args: argparse.Namespace, over: dict | None = None):
    """The config ``args`` name, with the config overrides ``over``."""
    get = configs.get_smoke if args.smoke else configs.get
    return get(args.arch, scan=ScanSpec(kind="exclusive",
                                        algorithm=args.exscan),
               **(over or {}))


def run(args: argparse.Namespace, on_step=None, executor=None,
        quiet: bool = False, over: dict | None = None,
        on_grads=None, weights=None, tuner_kw: dict | None = None
        ) -> TrainRun:
    """Train as ``args`` say.  ``on_step(step, params, opt, log)``, when
    given, is called after each step's synchronise (outside its time).
    With ``executor`` (an ``SPMDExecutor`` over the (data, model) grid,
    one rank a process) this process trains its share on its rows of
    each batch, on the executor's device, and checkpoints its share
    under its rank; ``quiet`` prints nothing.  ``over`` overrides the
    config's fields; ``on_grads`` sees each step's gradients
    (``make_train_step``); ``weights``, a parameter tree of numpy arrays
    (``params.from_reference``'s input), replaces the seed's weights
    (over processes, this process's share of them); ``tuner_kw``,
    ``AutoTuner``'s keywords under ``--autotune`` (its cadence and
    gate)."""
    if args.autotune and args.autotune_every < 1:
        raise ValueError(f"--autotune-every must be >= 1, got "
                         f"{args.autotune_every}")
    procs = executor is not None
    say = (lambda *a: None) if quiet else print
    cfg = config_of(args, over)
    dev = executor.device if procs else device_lib.resolve(args.device)
    mesh = mesh_lib.make_host_mesh(args.data_mesh, args.model_mesh)
    grid = tuple(zip(mesh.axis_names, mesh.sizes))
    # planner pricing provenance: a profile calibrated on this card and
    # rank grid (core/tune.py) over the default constants, and which
    profile = mesh_lib.use_calibrated_profile(
        grid, directory=args.profile_dir, device=dev)
    prov = profile.provenance(mesh_lib.mesh_fingerprint(grid, dev))
    say(f"[planner] cost profile: {prov['source']} "
        f"fingerprint={prov['fingerprint']} "
        f"mesh={prov['mesh_fingerprint']}"
        + (f" fit_residuals={prov['fit_residuals']}"
           if prov["fit_residuals"] else ""))
    model = Model(cfg, mesh, device=dev, executor=executor)
    if weights is None:
        params = model.init_params(args.seed, trainable=True)
    else:
        tree = PD.from_reference(weights, cfg, dev)
        if procs:
            tree = PD.shard_params(tree, cfg, mesh, executor.rank)
        params = model.load_params(tree, trainable=True)
        del tree
    opt = adamw_init(params)
    start_step = 0

    store = None
    if args.ckpt_dir:
        store = CheckpointStore(args.ckpt_dir) if not procs else \
            CheckpointStore(args.ckpt_dir, host_id=executor.rank,
                            n_hosts=executor.world)
        if args.resume == "auto":
            latest = store.latest_step()
            if latest is not None:
                state = {"params": params, "opt": opt}
                restore_into(state, store.restore(latest, state))
                start_step = latest
                say(f"[resume] restored step {latest}")

    step_fn = make_train_step(
        cfg, mesh, lr_peak=args.lr, warmup=max(1, args.steps // 20),
        total_steps=args.steps, model=model, on_grads=on_grads)
    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    rng = np.random.default_rng(1234)
    rows = model.rows(args.batch) if procs else None

    def batch_of(step: int) -> dict:
        return step_batch(cfg, data, step, args, rng, dev, rows)

    watchdog = StragglerWatchdog()
    tuner = None
    if args.autotune:
        from repro_torch.core.autotune import AutoTuner
        from repro_torch.core.schedule import StackedExecutor

        # the training scans run inside the step, so the online loop
        # times the planned schedule beside it (tuner.probe) at probe
        # cadence; an install reprices every later plan() call
        tuner = AutoTuner(profile, mesh_fingerprint="train-online",
                          **(tuner_kw or {}))
        probe_axes = mesh_lib.batch_axes(mesh)
        probe_spec = cfg.scan.over(
            probe_axes[-1] if probe_axes else "data", monoid="add")
        probe_p = max(2, mesh_lib.data_degree(mesh))
        probe_bytes = 8 * max(1, getattr(cfg, "n_experts", 8) or 8)
        # over processes the data group's when it has probe_p of them,
        # else each process's own ranks stacked on its device
        probe_executor = executor if procs and \
            mesh.shape[probe_spec.axis_name] == probe_p \
            else StackedExecutor(dev)
        agree = None
        if procs:
            def agree(seconds):
                t = torch.tensor([seconds], dtype=torch.float64, device=dev)
                return float(executor.all_gather(t, None).max())
    logs, traffic = [], []
    saved = None  # the step last checkpointed
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
            if procs:
                executor.reset_traffic()
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch, step)
            log = {k: float(v) for k, v in metrics.items()}
            device_lib.synchronize(dev)
            dt = time.perf_counter() - t0
            if procs:
                traffic.append(executor.read_traffic())
            log.update(step=step, seconds=dt)
            slow = watchdog.observe(step, dt)
            logs.append(log)
            if step % args.log_every == 0 or slow:
                say(f"step {step:5d} loss {log['loss']:.4f} "
                    f"ce {log['ce']:.4f} gnorm {log['grad_norm']:.3f} "
                    f"{dt*1e3:.0f} ms{'  [STRAGGLER]' if slow else ''}")
            if on_step is not None:
                on_step(step, params, opt, log)
            if tuner is not None and step % args.autotune_every == 0:
                tuner.probe(probe_spec, probe_p, probe_bytes,
                            executor=probe_executor, agree=agree)
                res = tuner.maybe_refit()
                fp = tuner.profile.fingerprint()
                log.update(probe_s=tuner.reservoir(
                    tuner.profile.default_tier)[-1].seconds
                    if tuner.executions else float("nan"),
                    installed=float(res.installed),
                    profile=float(int(fp[:12], 16)))
                if res.installed:
                    prov = res.profile.provenance()
                    say(f"[autotune] step {step}: installed refit "
                        f"fingerprint={prov['fingerprint']} "
                        f"drift={dict(res.drift)} "
                        f"plans_dropped={res.plans_dropped}")
            if store and args.ckpt_every and \
                    (step + 1) % args.ckpt_every == 0:
                store.save(step + 1, {"params": params, "opt": opt},
                           blocking=False)
                saved = step + 1
    gc.unfreeze()
    if store:
        store.wait()
        if saved != args.steps:  # the last step's, unless just saved
            store.save(args.steps, {"params": params, "opt": opt})
    if tuner is not None:
        say(f"[autotune] refits={tuner.refits} "
              f"installs={tuner.installs} "
              f"plans_dropped={tuner.plans_dropped} "
              f"reservoirs={tuner.reservoir_sizes()}")
    if logs:
        say(f"final loss {logs[-1]['loss']:.4f} "
            f"(first {logs[0]['loss']:.4f})")
    return TrainRun(model, params, opt, start_step, logs, step_fn, batch_of,
                    tuner, traffic)


# the metrics train_procs returns a step, and the collectives' kinds, in
# order
METRICS = ("loss", "ce", "load_balance", "dropped", "grad_norm", "lr")
KINDS = ("fsdp_gather", "all_reduce", "all_gather", "all_to_all",
         *TRAIN_KINDS, *SEQ_KINDS)
# what train_procs returns a step of an --autotune run, by process
TUNED = ("probe_s", "installed", "profile")


def train_procs(pool, argv: list, *, over: dict | None = None,
                weights=None, grads: bool = False, params: bool = False,
                trace: bool = False, norms: bool = False,
                tuner_kw: dict | None = None) -> dict:
    """Train as ``argv`` (the CLI's arguments) say
    over ``pool``'s processes, one rank of the (``--data-mesh``,
    ``--model-mesh``) grid each (``launcher.ENTRIES["train"]``: each
    process runs :func:`run` on its share and its rows; ``over``: the
    config's overrides; ``weights``: :func:`run`'s).  Returns by
    step the metrics (:data:`METRICS`, process 0's: every process has
    the same) and the slowest process's seconds; by process its
    parameter, gradient and moment bytes, its card's peak bytes (None
    off the card), each step's collectives ({kind: {"calls", "bytes",
    "s"}}, ``params.train_collectives``' kinds) and, with ``trace``, the
    card's busy seconds of one more step (``device.busy_s``); with
    ``grads`` each process's share of the first step's gradients and
    with ``params`` its share of the parameters after each step, on a
    leading axis of the steps (numpy trees: ``params.join_shares``
    joins them), with ``norms`` the first step's gradient norm of each
    leaf ({path: norm}, every process's share counted once: what the
    chip's training rows hold against the stacked run without moving
    the gradients); with ``--autotune`` "autotune", by process and
    step {"probe_s", "installed", "profile"} (the seconds recorded, 1.0
    where the step's refit installed, the profile's fingerprint as a
    number; NaN on steps without a probe; ``tuner_kw``: ``run``'s); and
    the pool's ``DistResult``."""
    args = parse_args(argv)
    ranks = (args.data_mesh, args.model_mesh)
    if pool.nprocs != ranks[0] * ranks[1] or pool.p_intra != 1:
        raise ValueError(f"{ranks[0]} x {ranks[1]} ranks need as many "
                         f"processes of one rank, the pool has "
                         f"{pool.nprocs} of {pool.p_intra}")
    res = pool.call("train", None, argv=list(argv), over=over,
                    weights=weights, grads=grads, params=params, trace=trace,
                    norms=norms, tuner_kw=tuner_kw,
                    mesh=(("data", ranks[0]), ("model", ranks[1])))
    out = res.outputs
    metrics = np.asarray(out["metrics"])
    traffic = np.asarray(out["traffic"])  # (procs, steps, kinds, 3)
    got = {"metrics": [dict(zip(METRICS, map(float, m)))
                       for m in metrics[0]],
           "step_s": [float(t) for t in np.asarray(out["seconds"]).max(0)],
           "step_s_by_process": np.asarray(out["seconds"]).tolist(),
           "bytes": [dict(zip(("params", "grads", "moments"),
                              map(int, b)))
                     for b in np.asarray(out["bytes"])],
           "peak_bytes": [m["allocated_peak_bytes"] for m in res.memory],
           "collectives": [[{kind: {"calls": int(c), "bytes": int(b),
                                    "s": float(t)}
                             for kind, (c, b, t) in zip(KINDS, step)}
                            for step in proc] for proc in traffic],
           "result": res}
    if trace:
        got["busy_s"] = [float(b) for b in np.asarray(out["busy_s"])]
    if args.autotune:
        got["autotune"] = [[dict(zip(TUNED, map(float, step)))
                            for step in proc]
                           for proc in np.asarray(out["autotune"])]
    if norms:
        cfg = config_of(args, over)
        got["leaf_norms"] = dict(zip(
            ["/".join(map(str, path)) for path in
             PD.leaf_paths(PD.abstract_params(cfg))],
            np.sqrt(np.asarray(out["norms"]).sum(0)).tolist()))
    if grads:
        got["grads"] = [_tree.tree_map(lambda a, k=k: a[k], out["grads"])
                        for k in range(pool.nprocs)]
    if params:
        got["params"] = [_tree.tree_map(lambda a, k=k: a[k], out["params"])
                         for k in range(pool.nprocs)]
    return got


# seconds a request of the CLI's process pool may take
POOL_TIMEOUT_S = 600.0


def train(argv=None) -> list:
    """The CLI: train as ``argv`` says; returns each step's loss.  With
    ``--backend`` over a pool of processes (:func:`train_procs`),
    printing each step's global metrics and each process's bytes and
    collectives."""
    args = parse_args(argv)
    if args.backend is None:
        return run(args).losses
    from repro_torch.dist import WorkerPool

    argv = list(argv) if argv is not None else sys.argv[1:]
    ranks = (args.data_mesh, args.model_mesh)
    with WorkerPool(ranks[0] * ranks[1], backend=args.backend,
                    device=args.device, timeout=POOL_TIMEOUT_S) as pool:
        got = train_procs(pool, argv)
    print(f"{ranks[0]} x {ranks[1]} ranks as {pool.nprocs} processes over "
          f"{args.backend}")
    start = args.steps - len(got["metrics"])
    for step, (m, dt) in enumerate(zip(got["metrics"], got["step_s"]),
                                   start):
        print(f"step {step:5d} loss {m['loss']:.6f} ce {m['ce']:.6f} "
              f"gnorm {m['grad_norm']:.6f} lb {m['load_balance']:.6f} "
              f"{dt*1e3:.1f} ms (slowest process)")
    if args.autotune:  # every process installs alike (train_procs)
        installs = [(step, f"{int(t['profile']):012x}") for step, t in
                    enumerate(got["autotune"][0], start)
                    if t["installed"] == 1.0]
        print(f"[autotune] installs (step, fingerprint) on every process: "
              f"{installs}")
    for k, (b, peak, steps) in enumerate(zip(got["bytes"], got["peak_bytes"],
                                             got["collectives"])):
        last = steps[-1] if steps else {}
        calls = ", ".join(f"{kind} {c['calls']} ({c['bytes']} B)"
                          for kind, c in last.items() if c["calls"])
        print(f"process {k}: parameters {b['params']} B, gradients "
              f"{b['grads']} B, moments {b['moments']} B, card peak "
              f"{peak} B; a step's collectives: {calls}")
    return [m["loss"] for m in got["metrics"]]


if __name__ == "__main__":
    train()
