"""What the port's benchmark CLIs share: the ``--device`` and ``--json``
arguments, the ``name,value,derived`` rows, the JSON envelope, and the
clock.

Every CLI runs on the card unless it is given ``--device cpu``.  A row
timed on the card carries the derived unit ``us_wallclock_cuda``, one
timed on the host ``us_wallclock_cpu`` (:func:`wallclock_unit`).  The
clock synchronises the device before it reads the time, and the first
call of a cell is left untimed: that is where kernels build and plans
are made.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="where to run: the CUDA card by default, 'cpu' "
                         "for the host")


def add_json_arg(ap, default: str) -> None:
    ap.add_argument("--json", nargs="?", const=default, default=None,
                    metavar="PATH",
                    help=f"also write the rows as JSON (default {default})")


def add_pool_args(ap) -> None:
    """``--nprocs``, ``--p-intra``, ``--backend`` and ``--check``: the
    bench's cells also across a worker pool, gated against the stacked
    run."""
    ap.add_argument("--nprocs", type=int, default=0,
                    help="also run the cells across this many processes")
    ap.add_argument("--p-intra", type=int, default=1,
                    help="ranks a process of the pool")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the pool's backend (nccl: one process a card)")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless the pool's outputs are the "
                         "stacked run's bit for bit")


def card_power() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    None where it does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def metadata(device) -> dict:
    """``core.benchmeta``'s envelope, with the device the rows ran on
    and, on the card, its name and power limit."""
    from repro_torch.core.benchmeta import bench_metadata

    meta = bench_metadata()
    dev = torch.device(device)
    meta["device"] = str(dev)
    if dev.type == "cuda":
        meta["card"] = card_power()
    return meta


def write_json(path: str, benchmark: str, device, **body) -> None:
    with open(path, "w") as f:
        json.dump({"meta": metadata(device), "schema_version": 1,
                   "benchmark": benchmark, **body}, f, indent=1,
                  sort_keys=True, default=str)
    print(f"wrote {path}")


def write_rows(path: str, benchmark: str, rows: list, device,
               **extra) -> None:
    """The CSV rows as ``[name, value, derived]`` triples."""
    write_json(path, benchmark, device,
               rows=[[k, v, note] for k, v, note in rows], **extra)


def print_csv(rows: list) -> None:
    for r in rows:
        print(",".join(str(x) for x in r))


def wallclock_unit(device) -> str:
    """The derived unit of a row timed on ``device``."""
    return f"us_wallclock_{torch.device(device).type}"


def timed(fn, device, reps: int) -> tuple[object, list[float]]:
    """``fn()`` once untimed (its result is returned), then ``reps``
    timed calls, each between two synchronises: the result and the
    seconds of each timed call."""
    from repro_torch.device import synchronize

    out = fn()
    synchronize(device)
    times = []
    for _ in range(reps):
        synchronize(device)
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return out, times


def host_weights(model, params=None, *, trainable: bool = False):
    """Load ``params`` (a weight tree on the host; None draws one there
    from seed 0, ``params.init_params``) onto ``model``'s device and
    return the loaded tree: the card and the CPU then run the same
    weights."""
    from repro_torch import _tree
    from repro_torch.models import params as PD

    tree = PD.init_params(model.cfg, 0, "cpu") if params is None else params
    return model.load_params(_tree.tree_map(lambda t: t.to(model.dev), tree),
                             trainable=trainable)
