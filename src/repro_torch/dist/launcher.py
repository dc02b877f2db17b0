"""Spawn and drive N processes that each run a block of a schedule's ranks.

:class:`WorkerPool` starts ``nprocs`` processes with
``torch.multiprocessing``'s ``spawn`` method (the parent never forks
after CUDA is up, and it sends numpy arrays, never CUDA tensors,
through its pipes).  Each child pins itself to one thread, joins a
``torch.distributed`` process group (rendezvous through a ``FileStore``
in a fresh temporary directory, the pool's ``timeout`` on every
collective) and keeps one :class:`~repro_torch.core.schedule.SPMDExecutor`
a mode across runs, so its pinned staging buffers and axis sub-groups
are made once.  Process k holds the ``p_intra`` consecutive global
ranks [k·p_intra, (k+1)·p_intra), the row-major layout of a composed
(inter, intra) schedule, as the JAX package's pool does: rounds over
the intra axis stay inside a process, rounds over the inter axis cross
processes.  The pool scatters each process its block, gathers the
stacked outputs in global rank order, and returns a
:class:`DistResult`: wall seconds per repeat (the slowest process's),
each rank's seconds (its process's), process 0's ``collect_stats()``,
the summed traffic counters, each process's round-kernel launches and
memory.

Failures raise and nothing hangs: every wait on a child has a deadline
(the pool's ``timeout`` and a grace period), a child's exception comes
back with its rank and traceback, and a child that dies, or a run that
misses its deadline, kills the pool.  A child that fails before any
message of a run (an unknown monoid, a schedule for another p) tells
its peers through one ``all_reduce``, and the pool stays usable.

The pool is one host: gloo binds the loopback unless
``GLOO_SOCKET_IFNAME`` says otherwise.  Several processes on one card
need ``gloo`` (NCCL refuses two ranks on one device), whose messages
the executor stages through pinned host memory; under ``nccl`` process
k runs on card k (:func:`devices_for`), and the pool refuses, before it
spawns, more processes than cards or two processes on one card.  The
parent builds the round kernels before it spawns, so the children load
the cached library instead of running ``nvcc`` at once.

Besides schedules and the scan entry points, :meth:`WorkerPool.call`
runs the consumers of the scan named in :data:`ENTRIES` (the
context-parallel scans, forward or forward and backward, and the MoE
dispatch accounting) on each process's block of ranks.  Their inputs
can be drawn in each process from a seed (:class:`Draw`) and their
outputs returned as digests of each rank's bits (``digest=True``), so
that a full-width run ships neither through the pipes.

CLI (on the card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.dist.launcher --nprocs 2 --smoke
    PYTHONPATH=src python -m repro_torch.dist.launcher --nprocs 2 \
        --p-intra 4 --smoke

plans an exclusive scan over ``nprocs`` ranks (with ``--p-intra`` P >
1, ``plan_hierarchical`` over (proc = nprocs, local = P), printing both
tiers' sub-plans), runs it through the pool, and exits non-zero unless
it equals ``StackedExecutor``'s bit for bit, with the plan's rounds and
⊕, each process's launches the IR's, and real messages sent.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import shutil
import signal
import tempfile
import time
import traceback

import numpy as np
import torch

from repro_torch import _tree
from repro_torch import device as device_lib

GRACE_S = 10.0  # beyond the pool's timeout, for children to report
KILL_S = 60.0  # for a killed child to be gone (a card's context is freed)


def devices_for(nprocs: int, backend: str, device=None,
                n_cards: int = 0) -> list:
    """Each process's device, process k first to last.  ``device`` is
    one device for every process, or a list of one a process.  Under
    ``gloo`` every process runs on the one device given (the first card
    without one).  Under ``nccl`` process k runs on card k unless a list
    says otherwise, and NCCL's rule of one card a process is checked
    here, against the ``n_cards`` cards present: more processes than
    cards, a device that is not a card or not present, or two processes
    on one card raise ``ValueError``."""
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if len(devs) != nprocs:
            raise ValueError(f"{len(devs)} devices for {nprocs} processes")
    elif backend != "nccl":
        return [torch.device("cuda", 0) if device is None
                else torch.device(device)] * nprocs
    elif device is None or torch.device(device) == torch.device("cuda"):
        devs = [torch.device("cuda", k) for k in range(nprocs)]
    else:
        devs = [torch.device(device)] * nprocs
    if backend != "nccl":
        return devs
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"the nccl backend carries CUDA tensors only, "
                         f"got {[str(d) for d in devs]}")
    if nprocs > n_cards:
        raise ValueError(f"nccl wants one card a process: {nprocs} "
                         f"processes, {n_cards} cards present")
    cards = [d.index or 0 for d in devs]
    if len(set(cards)) < nprocs:
        raise ValueError(f"nccl wants one card a process: {nprocs} "
                         f"processes would share {len(set(cards))} of the "
                         f"{n_cards} cards ({[str(d) for d in devs]})")
    if max(cards) >= n_cards:
        raise ValueError(f"card {max(cards)} is not among the {n_cards} "
                         f"cards present")
    return [torch.device("cuda", k) for k in cards]


@dataclasses.dataclass(frozen=True)
class Draw:
    """Inputs drawn on each process's device instead of sent: float32
    leaves, each rank's part of leaf i of shape ``shapes[i]`` (no
    rank axis), drawn by ``kinds[i]`` (("uniform", lo, hi) or
    ("normal",)) from a generator on the device seeded ``seed`` +
    1000·i + r for rank r.  Every process, and :meth:`full`, draw a
    rank's part alike on cards of one kind."""

    shapes: tuple
    kinds: tuple
    seed: int

    def block(self, ranks, device) -> tuple:
        """The ranks' parts stacked on a leading axis, leaf by leaf."""
        ranks = list(ranks)
        out = []
        for i, (shape, kind) in enumerate(zip(self.shapes, self.kinds)):
            leaf = torch.empty((len(ranks),) + tuple(shape),
                               dtype=torch.float32,
                               device=device)
            for row, r in enumerate(ranks):
                gen = torch.Generator(device=device).manual_seed(
                    self.seed + 1000 * i + r)
                if kind[0] == "uniform":
                    leaf[row].uniform_(kind[1], kind[2], generator=gen)
                elif kind[0] == "normal":
                    leaf[row].normal_(generator=gen)
                else:
                    raise ValueError(f"no draw {kind!r}")
            out.append(leaf)
        return tuple(out)

    def full(self, p: int, device) -> tuple:
        """Every rank's part: the stacked executor's inputs."""
        return self.block(range(p), device)


# (multiplier, addend) of each sum's position weights, as int64
_MIX = ((-0x61C8864680B583EB, 0x5851F42D4C957F2D),
        (0x632BE59BD9B4E019, 0x14057B7EF767814F))
_CHUNK = 1 << 24  # elements a digest pass


def digest(t: torch.Tensor) -> np.ndarray:
    """(rows, 2) int64: two sums, modulo 2^64, of each row's bit patterns
    (the leading axis; as int32, int16 or bytes by itemsize) times odd
    weights drawn from their positions.  Any one element that differs
    in a bit changes both sums; two rows of equal bits give equal
    digests on any device."""
    t = t.detach().contiguous()
    rows = t.shape[0]
    width = {8: torch.int32, 4: torch.int32, 2: torch.int16}.get(
        t.element_size(), torch.uint8)
    bits = t.reshape(rows, -1).view(width).reshape(rows, -1)
    n = bits.shape[1]
    sums = torch.zeros((rows, 2), dtype=torch.int64, device=t.device)
    for lo in range(0, n, _CHUNK):
        x = bits[:, lo:lo + _CHUNK].to(torch.int64)
        pos = torch.arange(lo, lo + x.shape[1], dtype=torch.int64,
                           device=t.device)
        for j, (mul, add) in enumerate(_MIX):
            w = (pos * mul + add) | 1
            sums[:, j] += (x * w).sum(dim=1)
    return sums.cpu().numpy()


@dataclasses.dataclass
class DistResult:
    """One run across the pool."""

    outputs: object  # stacked on a leading rank axis (tuple: outputs)
    seconds: list  # per repeat: the slowest process's wall seconds
    stats: dict | None  # process 0's collect_stats() of the first repeat
    transport: dict  # traffic counters of the first repeat, summed
    # per repeat: the p ranks' seconds in global order, each rank its
    # process's (the ranks of a block run as one)
    rank_seconds: list = dataclasses.field(default_factory=list)
    # per process (one a rank when p_intra = 1): its stats, round-kernel
    # launches by wrapper and ⊕ (the first repeat), and memory (peak
    # bytes allocated on the card during the run, the card's used bytes,
    # the process's resident bytes, its staging buffers)
    rank_stats: list = dataclasses.field(default_factory=list)
    launches: list = dataclasses.field(default_factory=list)
    traffic: list = dataclasses.field(default_factory=list)  # per process
    memory: list = dataclasses.field(default_factory=list)
    staging_seconds: list = dataclasses.field(default_factory=list)
    # WorkerPool.call with digest=True: the digests of each rank's
    # inputs (as sent or drawn), in global rank order
    inputs: object = None


def stop_resource_tracker() -> None:
    """Stop the resource tracker, the helper process that the ``spawn``
    start method starts beside the first child, once this process has no
    child left; the next spawn starts it anew.  Left running, it would
    outlive this process by a moment, holding its standard streams.
    Raises if it is not gone within the grace period."""
    import multiprocessing
    from multiprocessing import resource_tracker

    if multiprocessing.active_children():
        return
    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        fd, pid = tracker._fd, tracker._pid
        if fd is None or pid is None:
            return
        tracker._fd = tracker._pid = None
        os.close(fd)  # its end-of-file tells the tracker to exit
        deadline = time.monotonic() + GRACE_S
        while os.waitpid(pid, os.WNOHANG) == (0, 0):
            if time.monotonic() > deadline:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
                raise RuntimeError("the resource tracker did not exit")
            time.sleep(0.01)


class _SetupError(RuntimeError):
    """A run refused before any of its messages: the pool survives."""


def _stats_dict(st) -> dict:
    return {"rounds": st.rounds, "op_applications": st.op_applications,
            "allgathers": st.allgathers,
            "bytes_per_round": list(st.bytes_per_round),
            "kernel_launches": st.kernel_launches,
            "hbm_passes": st.hbm_passes}


def _resident_bytes() -> int | None:
    """This process's resident bytes now (``/proc/self/statm``), or None
    where the system does not say."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE")


def _cp_entry(kind: str):
    def make(ex, x, *, spec=None, grad: bool = False):
        """``cp_ssm_scan`` / ``cp_wkv_scan`` on the block's (a, b): h;
        with ``grad`` on (a, b, gY): (h, da, db), forward and backward."""
        from repro_torch.models import context_parallel as cpl

        fn = cpl.cp_ssm_scan if kind == "ssm" else cpl.cp_wkv_scan
        if not grad:
            a, b = x
            return lambda: fn(a, b, spec=spec, executor=ex)
        a, b, gy = x

        def run():
            xs, ys = a.detach().requires_grad_(), b.detach().requires_grad_()
            out = fn(xs, ys, spec=spec, executor=ex)
            da, db = torch.autograd.grad(out, [xs, ys], gy)
            return out.detach(), da, db

        return run

    return make


def _dispatch_entry(ex, x, *, arch: str, smoke: bool = False, spec=None):
    """``dispatch_slots`` of the block's (P, n0, k) router choices under
    config ``arch`` (its smoke size with ``smoke``)."""
    from repro_torch import configs
    from repro_torch.models.moe import dispatch_slots

    cfg = (configs.get_smoke if smoke else configs.get)(arch)
    top_e = x.to(torch.int32)
    return lambda: dispatch_slots(cfg, top_e, spec=spec, executor=ex)


def _config(arch: str, smoke: bool, over: dict):
    from repro_torch import configs

    return (configs.get_smoke if smoke else configs.get)(arch, **over)


def _moe_entry(ex, x, *, arch: str, ranks, batch: int, smoke: bool = False,
               seed: int = 0, **over):
    """``moe_ffn`` of config ``arch`` in process k = mesh rank (i, j) of
    the (data, model) grid ``ranks``: its weights from ``seed`` (its
    experts only; in a weight-stationary call over n_data > 1 data
    processes their slice i of d, as the model holds them, else whole
    in d, as the model gathers them), x the global (B, S, d) input as a
    (1, B, S, d) block of which it takes its rows.  Returns (y as fp32,
    aux, kept) of its rows on a leading axis of one.  Under decode_ws
    (``params.ws_slices`` > 1) it takes every row's d-slice i of x and
    holds slice i of the router's d too: y is every row's d-slice."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import params as PD
    from repro_torch.models.shards import WHOLE_D, ProcessSlice

    cfg = _config(arch, smoke, over)
    mesh = make_host_mesh(*ranks)
    moe.check_layout(cfg, mesh, ex)
    for axis in mesh.axis_names:  # before any message, in one order
        ex.axis_group(axis)
    n = moe.fsdp_size(mesh)
    ws = moe.moe_groups(cfg, batch, x.shape[2], mesh).ws and n > 1
    i = ex.rank // ranks[1]
    p = PD.init_moe_layer(cfg, seed, ex.device,
                          experts=moe.expert_range(cfg, mesh, ex.rank),
                          data=(i, n) if ws else None)
    dsl = WHOLE_D
    if PD.ws_slices(cfg, mesh) > 1:
        dsl = ProcessSlice(ex, i, n)
        d_l = cfg.d_model // n
        p["router"] = p["router"][i * d_l:(i + 1) * d_l].contiguous()
        xs = dsl.chan(x[0].to(p["router"].dtype))
    else:
        xs = x[0][moe.held_rows(batch, mesh, ex.rank)].to(
            p["router"].dtype).contiguous()

    def run():
        y, aux, kept = moe._moe_ffn(cfg, p, xs, mesh, ex, batch, dsl)
        # fp32 (exact from bf16): numpy has no bf16 of its own
        return y.float()[None], aux[None], kept[None]

    return run


def _mamba_entry(ex, x, *, arch: str, ranks, prefill: int,
                 smoke: bool = False, seed: int = 0, **over):
    """One Mamba mixer (``mamba_block``) of config ``arch`` in process k
    = mesh rank (i, j) of the (data, model) grid ``ranks``: its share of
    the mixer's weights from ``seed`` (``params.init_mamba_mixer``), x
    the global (B, S, d) input as a (1, B, S, d) block of which it takes
    its rows; a prefill of the first ``prefill`` positions into its
    share of the cache, then a decode step a position.  Returns (y as
    fp32 (1, B_k, S, d), the cache's conv as fp32 (1, B_k, K − 1,
    di/tp), h (1, B_k, di/tp, ds) and the mixer's parameter bytes
    (1, 1))."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import params as PD
    from repro_torch.models.mamba import init_mamba_cache, mamba_block
    from repro_torch.models.shards import WHOLE, ProcessShards

    cfg = _config(arch, smoke, over)
    mesh = make_host_mesh(*ranks)
    moe.check_layout(cfg, mesh, ex)
    for axis in mesh.axis_names:  # before any message, in one order
        ex.axis_group(axis)
    split = PD.plan_split(cfg, mesh)
    shards = ProcessShards(ex, ex.rank % split.tp) if split.d_inner \
        else WHOLE
    p = PD.init_mamba_mixer(cfg, seed, ex.device, share=(mesh, ex.rank))
    held = sum(v.numel() * v.element_size() for v in p.values())
    xs = x[0][moe.held_rows(x.shape[1], mesh, ex.rank)].to(
        p["in_proj"].dtype).contiguous()

    def run():
        cache = init_mamba_cache(cfg, xs.shape[0], xs.dtype, ex.device,
                                 d_inner=p["conv_w"].shape[-1])
        ys = [mamba_block(cfg, p, xs[:, :prefill], cache=cache,
                          shards=shards)[0]]
        for t in range(prefill, xs.shape[1]):
            ys.append(mamba_block(cfg, p, xs[:, t:t + 1], cache=cache,
                                  shards=shards)[0])
        # fp32 (exact from bf16): numpy has no bf16 of its own
        return (torch.cat(ys, dim=1).float()[None],
                cache["conv"].float()[None], cache["h"][None],
                torch.tensor([[held]], dtype=torch.int64))

    return run


def _all_gather_entry(ex, x, *, nbytes: int, axis="data", seed: int = 0):
    """One weight bucket of ``nbytes`` gathered over mesh axis ``axis``
    of the executor's mesh (``SPMDExecutor.all_gather``, counted as
    "fsdp_gather"): each process draws its bf16 slice on its device from
    ``seed`` + its rank.  Returns (1, 1): whether every row gathered is
    what its process drew (redrawn here), bit for bit."""
    procs, _ = ex.axis_group(axis)

    def draw(k):
        gen = torch.Generator(device=ex.device).manual_seed(seed + k)
        return torch.randn(max(1, nbytes // 2), generator=gen,
                           device=ex.device).to(torch.bfloat16)

    t = draw(ex.rank)

    def run():
        got = ex.all_gather(t, axis, kind="fsdp_gather")
        same = all(torch.equal(got[q], draw(k)) for q, k in enumerate(procs))
        return torch.tensor([[same]])

    return run


def _all_reduce_entry(ex, x, *, axis=None, dtype: str = "float32"):
    """``SPMDExecutor.all_reduce`` of the process's (1, ...) block as
    ``dtype`` over mesh axis ``axis`` of the executor's mesh (None:
    every process).  Returns the sum as fp32 (exact from bf16) on a
    leading axis of one."""
    t = x[0].to(getattr(torch, dtype)).contiguous()
    return lambda: ex.all_reduce(t, axis).float()[None]


def _serve_entry(ex, x, *, arch: str, ranks, batch: int, prompt_len: int,
                 gen: int, smoke: bool = False, seed: int = 0,
                 weights=None, forward: bool = False, trace: bool = False,
                 warm: bool = False, prefix=None, **over):
    """``serve_loop`` of config ``arch`` in process k = mesh rank (i, j)
    of the (data, model) grid ``ranks``: the model's weights from
    ``seed`` (its share only: its experts, its part of the dense layers
    the rule table splits over "model", its data slice of every "embed"
    dim, gathered over "data" at each use), or this process's share
    (``params.shard_params``) of ``weights``, a parameter tree of numpy
    arrays (``params.from_reference``'s input), and the prompts drawn
    here.  Returns (tokens (1, B_k, gen), the prefill's last logits (1,
    B_k, vocab), seconds (1, gen): the prefill's then each decode
    step's, parameter bytes (1, 2): dense and experts), and with
    ``trace`` the card's busy seconds (1, 2) of one more prefill and one
    more decode step (``device.busy_s``; NaN where the profiler records
    none).  With ``warm``, a prefill and one decode step first, not
    reported (their collectives and launches are counted).  With
    ``forward``, ``Model.forward`` on the prompts instead: (logits (1,
    B_k, P, vocab), aux (1, 2)).  ``prefix`` (B, n, d) numpy: a vision
    model's patch embeddings before the prompts, or an audio model's
    frames (its whole input; ``forward`` only)."""
    from repro_torch.launch.serve import prompts_for, serve_loop
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model

    cfg = _config(arch, smoke, over)
    model = Model(cfg, tuple(ranks), device=ex.device, executor=ex)
    model.check_forward("forward" if forward else "cache", seq=prompt_len)
    if weights is None:
        params = model.init_params(seed)
    else:
        tree = PD.from_reference(weights, cfg, ex.device)
        params = model.load_params(PD.shard_params(tree, cfg, model.mesh,
                                                   ex.rank))
        del tree
    held = PD.nbytes(params)
    prompts = prompts_for(cfg, batch, prompt_len, seed)

    rows = model.rows(batch)
    pre = None if prefix is None else torch.as_tensor(
        prefix[rows], device=ex.device).to(PD.torch_dtype(cfg))
    if forward:
        def run_forward():
            tok = None if cfg.frontend == "audio" else torch.as_tensor(
                prompts[rows], device=ex.device)
            logits, aux = model.forward(params, tok, prefix_embeds=pre,
                                        batch=batch)
            return logits[None], aux[None]

        return run_forward

    def run():
        if warm:  # the shapes' first use: cuBLAS's set-up, the groups
            serve_loop(model, params, prompts, 2, prefix)
        res = serve_loop(model, params, prompts, gen, prefix)
        out = (torch.as_tensor(res.tokens)[None], res.prefill_logits[None],
               torch.tensor([[res.prefill_s, *res.step_s]],
                            dtype=torch.float64),
               torch.tensor([[held["dense"], held["experts"]]],
                            dtype=torch.int64))
        if not trace:
            return out
        return out + (torch.tensor([_busy(model, params, prompts, res)],
                                   dtype=torch.float64),)

    return run


def _train_entry(ex, x, *, argv, over=None, weights=None,
                 grads: bool = False, params: bool = False,
                 trace: bool = False, norms: bool = False, tuner_kw=None):
    """``launch.train.run`` of the CLI arguments ``argv`` in process k =
    mesh rank (i, j) of the (``--data-mesh``, ``--model-mesh``) grid:
    its share of the weights from ``--seed``, its rows of each global
    batch, checkpoints of its share under its rank (``over``: the
    config's overrides; ``weights``: a parameter tree of numpy arrays
    to take its share of instead; ``tuner_kw``: ``run``'s).  Refuses,
    before any message, what the model over processes does not train
    (decode_ws, fsdp_sp's MoE, a sequence tp does not divide).  Returns
    {"metrics" (1, steps, 6) (``train.METRICS``), "seconds" (1,
    steps), "bytes" (1, 3): its parameters', gradients' and moments',
    "traffic" (1, steps, kinds, 3): each step's calls, bytes and seconds
    by kind (``train_procs``' order)}; with ``--autotune`` "autotune"
    (1, steps, 3) (``train.TUNED``); with ``trace`` "busy_s" (1,): the
    card's busy seconds of
    one more step (``device.busy_s``, NaN where the profiler records
    none); with ``grads`` "grads": its share of the first step's
    gradients, with ``params`` "params": its share of the parameters
    after each step (each leaf (1, steps, ...)), with ``norms`` "norms"
    (1, leaves): the first step's sum of squares of each leaf's gradient
    over the share it counts in the global norm (``params.norm_owner``;
    0 elsewhere)."""
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model

    args = T.parse_args(argv)
    cfg = T.config_of(args, over)
    mesh = make_host_mesh(args.data_mesh, args.model_mesh)
    Model(cfg, mesh, device=ex.device, executor=ex).check_forward(
        "loss", seq=args.seq + (cfg.n_prefix if cfg.frontend == "vision"
                                else 0))

    def run():
        first, after = {}, []

        def keep(step, g):
            if grads and "g" not in first:
                first["g"] = _tree.tree_map(lambda t: t.detach().clone(), g)
            if norms and "norms" not in first:
                owner = PD.norm_owner(cfg, mesh, ex.rank)
                first["norms"] = torch.tensor([[
                    float(torch.sum(torch.square(t.double())))
                    if path in owner else 0.0
                    for path, t in zip(PD.leaf_paths(g), _tree.leaves(g))]],
                    dtype=torch.float64)

        def snapshot(step, p, opt, log):
            if params:
                after.append(_tree.tree_map(lambda t: t.detach().clone(),
                                            p))

        r = T.run(args, on_step=snapshot, executor=ex, quiet=True,
                  over=over, on_grads=keep, weights=weights,
                  tuner_kw=tuner_kw)
        out = {"metrics": torch.tensor([[[log[k] for k in T.METRICS]
                                         for log in r.logs]],
                                       dtype=torch.float64),
               "seconds": torch.tensor([[log["seconds"] for log in r.logs]],
                                       dtype=torch.float64),
               "traffic": torch.tensor(
                   [[[[t[k], t[k + "_bytes"], t[k + "_s"]] for k in T.KINDS]
                     for t in r.traffic]], dtype=torch.float64)}
        if args.autotune:
            out["autotune"] = torch.tensor(
                [[[log.get(k, float("nan")) for k in T.TUNED]
                  for log in r.logs]], dtype=torch.float64)
        n = sum(v.numel() for v in _tree.leaves(r.params))
        held = sum(v.numel() * v.element_size()
                   for v in _tree.leaves(r.params))
        out["bytes"] = torch.tensor([[held, held, 2 * 4 * n]],
                                    dtype=torch.int64)
        if trace:
            step = args.steps
            batch = r.batch_of(step)
            got = device_lib.busy_s(
                lambda: r.step_fn(r.params, r.opt, batch, step), ex.device)
            out["busy_s"] = torch.tensor(
                [float("nan") if got is None else got], dtype=torch.float64)
        if grads:
            out["grads"] = _tree.tree_map(lambda t: t[None], first["g"])
        if norms:
            out["norms"] = first["norms"]
        if params:
            out["params"] = _tree.tree_map(
                lambda *ts: torch.stack(ts)[None], *after)
        del r, first, after
        if ex.device.type == "cuda":  # the parent's stacked run may share
            torch.cuda.empty_cache()  # this card next
        return out

    return run


def _loss_entry(ex, x, *, arch: str, ranks, batch: dict, weights,
                smoke: bool = False, **over):
    """``Model.loss`` of config ``arch`` with its backward, and
    ``Model.forward``, in process k = mesh rank (i, j) of the (data,
    model) grid ``ranks``, on this process's share of ``weights`` (a
    parameter tree of numpy arrays, ``params.from_reference``'s input)
    and its rows of ``batch`` (the global batch as numpy arrays, whole
    rows: ``Model.loss``'s schema).  Refuses, before any message, what
    the model over processes does not run.  Returns {"loss" (1,),
    "grads": its share of the gradient of the global batch's loss
    (``launch.steps.sync_grads``), each leaf (1, ...), "logits" (1,
    B_k, S_k, vocab): the forward's at the positions it holds}."""
    from repro_torch.launch.steps import sync_grads
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model

    cfg = _config(arch, smoke, over)
    model = Model(cfg, tuple(ranks), device=ex.device, executor=ex)
    first = next(iter(batch.values()))
    S = batch["labels"].shape[1] + (batch["prefix"].shape[1]
                                    if "prefix" in batch else 0)
    model.check_forward("loss", seq=S)
    tree = PD.from_reference(weights, cfg, ex.device)
    params = model.load_params(PD.shard_params(tree, cfg, model.mesh,
                                               ex.rank), trainable=True)
    del tree
    rows = model.rows(first.shape[0])
    held = {k: torch.as_tensor(v[rows], device=ex.device)
            for k, v in batch.items()}
    inputs = (held.get("tokens"), held.get("embeds", held.get("prefix")))

    def run():
        leaves = _tree.leaves(params)
        loss, _ = model.loss(params, held)
        got = torch.autograd.grad(loss, leaves)
        got = sync_grads(model, PD.leaf_paths(params), list(got))
        logits, _ = model.forward(params, *inputs)
        return {"loss": loss.detach()[None],
                "grads": _tree.tree_map(lambda t: t[None],
                                        _tree.unflatten(
                                            _tree.flatten(params)[1], got)),
                "logits": logits[None]}

    return run


def _busy(model, params, prompts, res) -> list:
    """The card's busy seconds of one prefill and one decode step of
    ``res``'s requests (each process runs both, so the MoE layers'
    collectives pair up), NaN where the profiler records none."""
    dev, batch = model.dev, prompts.shape[0]
    rows = torch.as_tensor(prompts[model.rows(batch)], device=dev)
    tok = torch.as_tensor(res.tokens[:, :1].copy(), device=dev)
    cache = model.init_cache(rows.shape[0], rows.shape[1] + 1)
    out = []
    for fn in (lambda: model.serve_step(params, cache, rows, 0,
                                        last_only=True, batch=batch),
               lambda: model.decode_step(params, cache, tok, rows.shape[1],
                                         batch=batch)):
        got = device_lib.busy_s(fn, dev)
        out.append(float("nan") if got is None else got)
    return out


# The consumers WorkerPool.call runs, by name: each makes, from the
# process's executor, its block of inputs (leading axis P) and the call's
# keywords, the function one repeat calls.
ENTRIES = {
    "all_gather": _all_gather_entry,
    "all_reduce": _all_reduce_entry,
    "cp_ssm_scan": _cp_entry("ssm"),
    "cp_wkv_scan": _cp_entry("wkv"),
    "dispatch_slots": _dispatch_entry,
    "loss": _loss_entry,
    "mamba_block": _mamba_entry,
    "moe_ffn": _moe_entry,
    "serve": _serve_entry,
    "train": _train_entry,
}


class _Worker:
    """One child's state across runs: its rank, block size, device and
    executors."""

    def __init__(self, rank: int, device: torch.device, backend: str,
                 p_intra: int = 1):
        self.rank = rank
        self.device = device
        self.backend = backend
        self.p_intra = p_intra
        self._executors: dict = {}

    def executor(self, fused: bool, mesh=None, p_intra: int | None = None):
        from repro_torch.core import schedule as sch

        P = self.p_intra if p_intra is None else int(p_intra)
        key = (fused, mesh, P)
        ex = self._executors.get(key)
        if ex is None:
            ex = sch.SPMDExecutor(self.device, mesh=mesh, fused=fused,
                                  ranks_per_proc=P)
            self._executors[key] = ex
        return ex

    def _collective_device(self):
        return self.device if self.backend == "nccl" else "cpu"

    def agree(self, err: str | None) -> None:
        """Every rank learns whether any rank failed to set up a task;
        the only collective before a run's messages."""
        import torch.distributed as dist

        flag = torch.tensor([0 if err is None else 1],
                            device=self._collective_device())
        dist.all_reduce(flag)
        if err is not None:
            raise _SetupError(err)
        if int(flag.item()):
            raise _SetupError(f"rank {self.rank}: a peer failed to set up "
                              f"the task")

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index or 0])
        else:
            dist.barrier()

    def memory(self) -> dict:
        mem = {"resident_bytes": _resident_bytes(),
               "allocated_peak_bytes": None, "card_used_bytes": None,
               "device": str(self.device)}
        if self.device.type == "cuda":  # the card the process runs on
            mem["device"] = f"cuda:{torch.cuda.current_device()}"
            free, total = torch.cuda.mem_get_info(self.device)
            mem["allocated_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
            mem["card_used_bytes"] = total - free
        return mem

    def _call(self, task: dict):
        """The task's call in this process: a schedule's execution, or a
        scan entry point with this process's block of payloads."""
        from repro_torch.core import monoid as monoid_lib
        from repro_torch.core import scan_api

        ex = self.executor(bool(task["fused"]), task.get("mesh"),
                           task.get("p_intra"))
        if "call" in task:
            make = ENTRIES.get(task["call"])
            if make is None:
                raise ValueError(f"no entry {task['call']!r}; the pool "
                                 f"calls {sorted(ENTRIES)}")
            x = task["x"]
            if isinstance(x, Draw):
                P = ex.ranks_per_proc
                x = x.block(range(self.rank * P, (self.rank + 1) * P),
                            self.device)
            elif x is not None:
                x = device_lib.to_torch(x, self.device)
            return ex, x, make(ex, x, **task["kw"])
        x = device_lib.to_torch(task["x"], self.device)
        if "schedule" in task:
            sched, m = task["schedule"], monoid_lib.get(task["monoid"])
            if sched.p != ex.p:
                raise ValueError(f"schedule p={sched.p} != pool "
                                 f"p={ex.p}")
            on = ex.mirrored() if task.get("mirrored") else ex
            return ex, x, lambda: on.execute(sched, x, m)
        entry, spec = task["entry"], task["spec"]
        if entry == "fused_scan":
            return ex, x, lambda: scan_api.fused_scan(list(zip(x, spec)),
                                                      executor=ex)
        if entry not in ("scan", "scan_with_total"):
            raise ValueError(f"no scan entry point {entry!r}")
        fn = getattr(scan_api, entry)
        return ex, x, lambda: fn(x, spec, executor=ex)

    def run(self, task: dict) -> dict:
        from repro_torch.core import schedule as sch
        from repro_torch.kernels import scan_engine as se

        err = None
        if self.device.type == "cuda":  # the peak memory() reports: this run's
            torch.cuda.reset_peak_memory_stats(self.device)
        try:
            ex, x, call = self._call(task)
        except Exception:  # noqa: BLE001 - told to every rank, then raised
            err = traceback.format_exc()
        self.agree(err)
        seconds, staging = [], []
        first = None
        for rep in range(int(task["repeats"])):
            se.reset_launch_counts()
            ex.reset_traffic()
            self.barrier()
            t0 = time.perf_counter()
            with sch.collect_stats() as st:
                out = call()
            device_lib.synchronize(self.device)
            seconds.append(time.perf_counter() - t0)
            staging.append(ex.traffic["staging_s"])
            if first is None:
                first = {"stats": _stats_dict(st),
                         "traffic": ex.read_traffic(),
                         "launches": {name: dict(fn.launches_by_op)
                                      for name, fn in se.KERNELS.items()
                                      if fn.launches}}
        if task.get("digest"):
            first["inputs"] = None if x is None else _tree.tree_map(digest,
                                                                    x)
            outputs = _tree.tree_map(digest, out)
        else:
            outputs = device_lib.to_numpy(out)
        return {"outputs": outputs, "seconds": seconds,
                "staging_s": staging, "memory": self.memory(),
                "staging_buffers": ex.staging_buffers, **first}

    def hop(self, task: dict) -> dict:
        """``repeats`` ping-pongs of ``nbytes`` on the pool's device
        between processes 0 and 1 (process 0 times them); the others
        wait."""
        ex = self.executor(True)
        self.agree(None)
        t = torch.zeros(max(1, int(task["nbytes"]) // 8), dtype=torch.int64,
                        device=self.device)
        n = int(task["repeats"])
        self.barrier()
        seconds = None
        if self.rank == 0:
            t0 = time.perf_counter()
            for _ in range(n):
                ex.sendrecv(t, 1, t, None)
                t = ex.sendrecv(None, None, t, 1)
            device_lib.synchronize(self.device)
            seconds = time.perf_counter() - t0
        elif self.rank == 1:
            for _ in range(n):
                got = ex.sendrecv(None, None, t, 0)
                ex.sendrecv(got, 0, got, None)
        ex.reset_traffic()
        self.barrier()
        return {"seconds": seconds}


def _child(rank: int, nprocs: int, backend: str, device: str, store: str,
           timeout: float, conn, p_intra: int = 1) -> None:
    """A pool process: join the group, then serve tasks until told to
    stop or until the parent's end of the pipe closes."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)  # the processes share the host's cores
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=nprocs, timeout=datetime.timedelta(seconds=timeout))
        worker = _Worker(rank, dev, backend, p_intra)
        conn.send(("ready", {"rank": rank, "pid": os.getpid()}))
    except BaseException:  # noqa: BLE001 - reported to the parent
        conn.send(("error", {"rank": rank, "fatal": True,
                             "traceback": traceback.format_exc()}))
        return
    try:
        while True:
            try:
                tag, task = conn.recv()
            except EOFError:  # the parent is gone
                return
            if tag == "shutdown":
                return
            try:
                reply = getattr(worker, tag)(task)
                conn.send(("done", reply))
            except _SetupError as e:
                conn.send(("error", {"rank": rank, "fatal": False,
                                     "peer": "a peer failed" in str(e),
                                     "traceback": str(e)}))
            except Exception:  # noqa: BLE001 - reported to the parent
                conn.send(("error", {"rank": rank, "fatal": True,
                                     "traceback": traceback.format_exc()}))
    finally:
        dist.destroy_process_group()


class WorkerPool:
    """``nprocs`` processes of ``p_intra`` consecutive schedule ranks
    each (p = nprocs·p_intra ranks), over a ``torch.distributed`` process
    group of ``backend`` ("gloo" or "nccl", the caller's choice).  Under
    gloo every process runs on ``device`` (the card by default;
    ``"cpu"`` for the host); under nccl process k runs on card k, or on
    the k-th of a list of devices, one card a process
    (:func:`devices_for`).  Every request must finish within
    ``timeout`` seconds, which is also the process group's timeout.
    ``p_intra`` may be set between requests: the same processes then
    hold that many ranks each (an executor a block size, as a mesh), so
    one pool serves several grids of its process count."""

    def __init__(self, nprocs: int, *, backend: str, device=None,
                 timeout: float = 120.0, p_intra: int = 1):
        if nprocs < 1 or p_intra < 1:
            raise ValueError(f"need nprocs >= 1 and p_intra >= 1, got "
                             f"{nprocs}/{p_intra}")
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        if backend == "gloo" and not isinstance(device, (list, tuple)):
            device = device_lib.resolve(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        devs = [device_lib.resolve(d) for d in devices_for(
            nprocs, backend, device, torch.cuda.device_count())]
        if any(d.type == "cuda" for d in devs):
            from repro_torch.kernels import _build

            _build.compile_source(_build.CSRC / "round_kernels.cu")
        self.nprocs = int(nprocs)
        self.p_intra = int(p_intra)  # ranks a process
        self.backend = backend
        self.devices = devs  # process k's device
        self.device = devs[0]
        self.cards = len({d for d in devs if d.type == "cuda"})
        self.platform = devs[0].type  # "cuda" or "cpu": keys the dci profile
        self.timeout = float(timeout)
        self._closed = False
        self._procs: list = []
        self._conns: list = []
        self._dir = tempfile.mkdtemp(prefix="repro-torch-dist-")
        ctx = torch.multiprocessing.get_context("spawn")
        try:
            for rank in range(self.nprocs):
                here, there = ctx.Pipe()
                proc = ctx.Process(
                    target=_child, name=f"repro-torch-rank-{rank}",
                    args=(rank, self.nprocs, backend, str(devs[rank]),
                          os.path.join(self._dir, "store"), self.timeout,
                          there, self.p_intra), daemon=True)
                proc.start()
                there.close()
                self._procs.append(proc)
                self._conns.append(here)
            self._replies("start-up")
        except BaseException:
            self.close()
            raise

    @property
    def p(self) -> int:
        """The schedule ranks the pool holds, ``nprocs``·``p_intra``."""
        return self.nprocs * self.p_intra

    def _fail(self, message: str):
        self.close()
        raise RuntimeError(message)

    def _replies(self, what: str) -> list:
        """One reply from every child, in rank order, within the
        deadline; a dead child or a missed deadline closes the pool and
        raises, a child's error raises with its rank and traceback."""
        from multiprocessing.connection import wait

        deadline = time.monotonic() + self.timeout + GRACE_S
        replies: list = [None] * self.nprocs
        pending = set(range(self.nprocs))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"ranks {sorted(pending)} sent no reply within "
                           f"{self.timeout + GRACE_S:.0f} s of {what}")
            wait([self._conns[k] for k in pending]
                 + [self._procs[k].sentinel for k in pending], timeout=left)
            for k in sorted(pending):
                if self._conns[k].poll():
                    try:
                        replies[k] = self._conns[k].recv()
                    except EOFError:
                        self._fail(f"rank {k} closed its pipe during {what}")
                    pending.discard(k)
                elif not self._procs[k].is_alive():
                    self._fail(f"rank {k} died (exit code "
                               f"{self._procs[k].exitcode}) during {what}")
        errors = [body for tag, body in replies if tag == "error"]
        if errors:
            first = next((e for e in errors if not e.get("peer")), errors[0])
            if any(e["fatal"] for e in errors):
                self.close()
            raise RuntimeError(f"rank {first['rank']} failed during {what}:"
                               f"\n{first['traceback']}")
        return [body for _, body in replies]

    def _request(self, tag: str, tasks: list) -> list:
        if self._closed:
            raise RuntimeError("the worker pool is closed")
        for k, (conn, task) in enumerate(zip(self._conns, tasks)):
            try:
                conn.send((tag, task))
            except (BrokenPipeError, EOFError, OSError) as e:
                self._fail(f"rank {k} is gone: {e}")
        return self._replies(tag)

    def run(self, sched, x, monoid="add", *, collect: bool = True,
            repeats: int = 1, fused: bool = True,
            mirrored: bool = False) -> DistResult:
        """Run ``sched`` on ``x`` (leaves with a leading rank axis of
        size p; a fused schedule takes the list of its payloads) across
        the pool; returns the outputs stacked on that axis.  With
        ``mirrored`` the executors' mirrored views run it: row r of
        ``x`` is the schedule's rank p−1−r.  ``mirrored`` is a test
        seam: it reaches :meth:`SPMDExecutor.mirrored` on any schedule
        family, where the context-parallel backward reaches it only
        through ``_SplitAffineFn``."""
        from repro_torch.core import monoid as monoid_lib

        if sched.p != self.p:
            raise ValueError(f"schedule p={sched.p} != pool p={self.p}")
        return self._run(x, {"schedule": sched,
                             "monoid": monoid_lib.get(monoid).name,
                             "mirrored": bool(mirrored)},
                         collect, repeats, fused)

    def scan(self, x, spec, *, entry: str = "scan", mesh=None,
             collect: bool = True, repeats: int = 1,
             fused: bool = True) -> DistResult:
        """Call a scan entry point (``"scan"``, ``"scan_with_total"`` or
        ``"fused_scan"``) in every process with its block of ``x``
        (leading rank axis of size p) and an ``SPMDExecutor`` over
        ``mesh`` ((name, size) pairs; one axis over the pool without it);
        ``fused_scan`` takes a list of payloads and a list of specs."""
        return self._run(x, {"entry": entry, "spec": spec,
                             "mesh": None if mesh is None else tuple(mesh)},
                         collect, repeats, fused)

    def call(self, entry: str, x, *, collect: bool = True,
             repeats: int = 1, digest: bool = False, mesh=None,
             **kw) -> DistResult:
        """Call the consumer ``entry`` (a name in :data:`ENTRIES`) in
        every process with its block of ``x`` (leaves with a leading
        rank axis of size p, each process given its P rows as (P, ...),
        also for P = 1; or a :class:`Draw`, which each process draws
        itself; or None for an entry that makes its own inputs), that
        process's ``SPMDExecutor`` (over ``mesh``, (name, size) pairs,
        where given) and ``kw``; returns the outputs in global rank
        order on that axis (with ``digest``, each rank's :func:`digest`
        of each output instead, and those of the drawn inputs in
        ``inputs``), with ``run``'s reports."""
        if entry not in ENTRIES:
            raise ValueError(f"no entry {entry!r}; the pool calls "
                             f"{sorted(ENTRIES)}")
        if x is not None and not isinstance(x, Draw):
            rows = {np.shape(a)[0] for a in _tree.leaves(x)}
            if rows != {self.p}:
                raise ValueError(f"{entry} takes leaves with a leading "
                                 f"axis of {self.p} ranks, got {rows}")
        return self._run(x, {"call": entry, "kw": kw,
                             "digest": bool(digest),
                             "mesh": None if mesh is None else tuple(mesh)},
                         collect, repeats, True, blocks=True)

    def _run(self, x, task: dict, collect: bool, repeats: int,
             fused: bool, blocks: bool = False) -> DistResult:
        P = self.p_intra
        drawn = x is None or isinstance(x, Draw)
        if not drawn:
            x = _tree.tree_map(device_lib.leaf_to_numpy, x)

        def block(a, k):  # process k's ranks (one: no rank axis)
            return a[k] if P == 1 and not blocks else a[k * P:(k + 1) * P]

        replies = self._request("run", [
            dict(task, repeats=int(repeats), fused=bool(fused),
                 p_intra=P,
                 x=x if drawn else
                 _tree.tree_map(lambda a, k=k: block(a, k), x))
            for k in range(self.nprocs)])
        join = np.stack if P == 1 and not blocks else np.concatenate
        outputs = _tree.tree_map(lambda *vs: join(vs, axis=0),
                                 *[r["outputs"] for r in replies])
        inputs = None
        if replies[0].get("inputs") is not None:
            inputs = _tree.tree_map(lambda *vs: np.concatenate(vs, axis=0),
                                    *[r["inputs"] for r in replies])
        transport: dict = {}
        for r in replies:
            for key, v in r["traffic"].items():
                transport[key] = transport.get(key, 0) + v
        rank_seconds = [[r["seconds"][i] for r in replies for _ in range(P)]
                        for i in range(int(repeats))]
        return DistResult(
            outputs=outputs, seconds=[max(t) for t in rank_seconds],
            stats=replies[0]["stats"] if collect else None,
            transport=transport, rank_seconds=rank_seconds,
            rank_stats=[r["stats"] for r in replies],
            launches=[r["launches"] for r in replies],
            traffic=[r["traffic"] for r in replies],
            memory=[dict(r["memory"],
                         staging_buffers=r["staging_buffers"])
                    for r in replies],
            staging_seconds=[max(r["staging_s"][i] for r in replies)
                             for i in range(int(repeats))],
            inputs=inputs)

    def measure_hop(self, nbytes: int, repeats: int = 10) -> float:
        """One-way seconds of a message of ``nbytes`` between processes 0
        and 1: half the mean of ``repeats`` round trips on the pool's
        device (staged through the host under gloo on the card)."""
        if self.nprocs < 2:
            raise ValueError("measure_hop needs two processes or more")
        replies = self._request("hop", [
            {"nbytes": int(nbytes), "repeats": int(repeats)}] * self.nprocs)
        return replies[0]["seconds"] / (2 * repeats)

    def close(self) -> None:
        """Stop and reap every child (killing those that do not stop
        within the grace period), remove the rendezvous directory, and
        stop the spawn method's helper process once no child is left;
        raises if a killed child outlives its deadline."""
        if self._closed:
            return
        self._closed = True
        for conn, proc in zip(self._conns, self._procs):
            if proc.is_alive():
                try:
                    conn.send(("shutdown", None))
                except OSError:
                    pass
        deadline = time.monotonic() + GRACE_S
        for proc in self._procs:
            proc.join(max(0.1, deadline - time.monotonic()))
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
        deadline = time.monotonic() + KILL_S
        for proc in self._procs:
            proc.join(max(0.1, deadline - time.monotonic()))
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)
        alive = [k for k, proc in enumerate(self._procs) if proc.is_alive()]
        if alive:
            raise RuntimeError(f"ranks {alive} still run {KILL_S:.0f} s "
                               f"after SIGKILL")
        stop_resource_tracker()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_plan(pool: WorkerPool, pl, x, *, collect: bool = True,
             repeats: int = 1) -> DistResult:
    """Run a resolved :class:`~repro_torch.core.scan_api.ScanPlan`
    through ``pool`` (the plan's spec names the monoid)."""
    return pool.run(pl.schedule(), x, monoid=pl.spec.monoid,
                    collect=collect, repeats=repeats)


# ---------------------------------------------------------------------------
# CLI: one exscan across the pool, against StackedExecutor
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run an exclusive scan across N processes through "
                    "torch.distributed and hold it against the stacked "
                    "executor on the same device.")
    ap.add_argument("--nprocs", type=int, default=2,
                    help="processes (the inter tier's size)")
    ap.add_argument("--p-intra", type=int, default=1,
                    help="ranks a process (the intra tier's size); above "
                         "1 the scan is planned hierarchically")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the host")
    ap.add_argument("--m", type=int, default=65_536,
                    help="per-rank payload bytes (int64 elements)")
    ap.add_argument("--monoid", default="add")
    ap.add_argument("--algorithm", default="auto")
    ap.add_argument("--smoke", action="store_true",
                    help="exit non-zero unless the result is bit for bit "
                         "the stacked executor's, with the plan's counts")
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)

    from repro_torch.core import monoid as monoid_lib
    from repro_torch.core import schedule as sch
    from repro_torch.core.scan_api import ScanSpec, plan, plan_hierarchical

    spec = ScanSpec(kind="exclusive", monoid=args.monoid,
                    algorithm=args.algorithm)
    if args.p_intra > 1:
        pl = plan_hierarchical(spec, p_inter=args.nprocs,
                               p_intra=args.p_intra, nbytes=args.m)
    else:
        pl = plan(spec, args.nprocs, nbytes=args.m)
    m = monoid_lib.get(args.monoid)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 30, size=(pl.p, max(1, args.m // 8)),
                     dtype=np.int64)
    with WorkerPool(args.nprocs, backend=args.backend, device=args.device,
                    timeout=args.timeout, p_intra=args.p_intra) as pool:
        print(f"pool: {pool.nprocs} processes x {pool.p_intra} ranks, "
              f"backend {pool.backend}, device {pool.device}")
        print(f"plan: {pl.algorithm} p={pl.p} m={args.m}B "
              f"rounds={pl.rounds}")
        for sub, axis in zip(pl.sub_plans, ("intra", "bridge", "inter")
                             if len(pl.sub_plans) == 3 else
                             ("intra", "inter")):
            print(f"  {axis} ({sub.spec.axes[-1]!r} tier): {sub.algorithm} "
                  f"S={sub.segments} rounds={sub.rounds}")
        res = pool.run(pl.schedule(), x, monoid=m.name)
        want = device_lib.to_numpy(
            sch.StackedExecutor(pool.device).execute(pl.schedule(), x, m))
    identical = np.array_equal(res.outputs, want)
    ir = pl.schedule().kernel_launches(m.commutative, fused=True)
    on_card = pool.device.type == "cuda"
    launches = [sum(n for by_op in ln.values() for n in by_op.values())
                for ln in res.launches]
    counts_ok = (res.stats["rounds"] == pl.rounds
                 and res.stats["op_applications"] == pl.op_applications
                 and all(s["kernel_launches"] == ir for s in res.rank_stats)
                 and launches == [ir if on_card else 0] * pool.nprocs)
    print(f"run: {res.seconds[0]:.4f} s, rounds {res.stats['rounds']} "
          f"(plan {pl.rounds}), launches per process {launches} (IR {ir}), "
          f"messages {res.transport['msgs']}, bytes {res.transport['bytes']}"
          f", staging copies {res.transport['staged_copies']}")
    print(f"bit-identical to StackedExecutor: {identical}")
    if args.smoke and not (identical and counts_ok and
                           (res.transport["msgs"] > 0 or args.nprocs < 2)):
        print("SMOKE FAIL")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
