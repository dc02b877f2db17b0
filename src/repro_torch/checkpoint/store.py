"""Sharded checkpoints with atomic commit, async save and elastic
restore, on the JAX package's on-disk format (``checkpoint/store.py``
there), so a checkpoint written by one package restores in the other.

Layout:
    <dir>/step_00000100/
        manifest.json          # leaf paths (jax keystr), shapes, dtypes
        shard_00000.npz        # the leaves (flat index -> array); the
                               # reference's n hosts write one each
        COMMITTED              # written last: marks the checkpoint usable

Leaves are flattened in ``jax.tree``'s order (``repro_torch._tree``) and
named as ``jax.tree_util.keystr`` names them; bf16 tensors are written
as ``ml_dtypes`` bfloat16 arrays, which ``np.savez`` stores as 2-byte
void records, and read back by the manifest's dtype, bit for bit.

Fault-tolerance contract, as the reference's:
  * save is all-or-nothing (COMMITTED is written after every shard), so
    a crash mid-save leaves the previous checkpoint intact;
  * ``latest_step`` ignores uncommitted directories;
  * a checkpoint in the reference's format restores whatever host
    count saved it (elastic): the manifest records which flat leaves
    live in which shard;
  * a save may run on a background thread, ``wait()`` joining it before
    the next save or exit.  The tensors are copied to host memory
    before the thread starts, so training may overwrite them.

Over processes (``n_hosts`` > 1, ``host_id`` the process's rank): each
process holds a share of the tree (its parameters and moments,
``models.params.shard_params``' cut) and writes all of it, under its
rank:

    <dir>/step_00000100/
        manifest.json          # n_hosts, sharded (written at the commit)
        share_00003.json       # process 3's leaf paths, shapes, dtypes
        share_00003.npz        # process 3's leaves
        COMMITTED

Each share lands whole or not at all (written aside, then renamed), and
process 0 commits the step once every process's share is there; a
process's ``restore`` reads its own share back.  ``restore`` picks the
layout from the manifest.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time

import numpy as np

from repro_torch import _tree
from repro_torch import device as device_lib


def tree_paths(tree) -> list[str]:
    return _tree.paths(tree)


def _from_file(arr: np.ndarray, dtype: str) -> np.ndarray:
    """A leaf as read from its shard, typed by the manifest (bf16 comes
    back from ``np.load`` as 2-byte void records)."""
    if dtype == "bfloat16" and arr.dtype != np.dtype(dtype):
        import ml_dtypes  # only bf16 leaves need it

        return arr.view(ml_dtypes.bfloat16)
    return arr


# seconds process 0 waits for the other processes' shares of a step
SHARE_WAIT_S = 600.0


class CheckpointStore:
    def __init__(self, directory: str, host_id: int = 0, n_hosts: int = 1):
        self.dir = directory
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------- save -----------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, tree, blocking: bool = True):
        """Save ``tree`` (tensors or arrays; host copies of this host's
        leaves are taken before returning)."""
        self.wait()
        paths = tree_paths(tree)
        arrays = [device_lib.leaf_to_numpy(l) for l in _tree.leaves(tree)]

        def work():
            if self.n_hosts > 1:
                return self._save_share(step, paths, arrays)
            d = self._step_dir(step)
            tmp = d + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            shutil.rmtree(d, ignore_errors=True)
            manifest = {
                "step": step,
                "n_hosts": 1,
                "leaves": [
                    {"path": p, "shape": list(a.shape),
                     "dtype": str(a.dtype), "shard": 0}
                    for p, a in zip(paths, arrays)
                ],
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            np.savez(os.path.join(tmp, "shard_00000.npz"),
                     **{str(i): a for i, a in enumerate(arrays)})
            os.replace(tmp, d)
            with open(os.path.join(d, "COMMITTED"), "w") as f:
                f.write("ok")

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _save_share(self, step: int, paths, arrays):
        """This process's share of ``step``, then (process 0) the commit
        once every share is written."""
        tmp = self._step_dir(step) + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        name = os.path.join(tmp, f"share_{self.host_id:05d}")
        with open(name + ".json.part", "w") as f:
            json.dump([{"path": p, "shape": list(a.shape),
                        "dtype": str(a.dtype)}
                       for p, a in zip(paths, arrays)], f)
        with open(name + ".npz.part", "wb") as f:
            np.savez(f, **{str(i): a for i, a in enumerate(arrays)})
        os.replace(name + ".json.part", name + ".json")
        os.replace(name + ".npz.part", name + ".npz")
        if self.host_id != 0:
            return
        want = {f"share_{h:05d}.npz" for h in range(self.n_hosts)}
        deadline = time.monotonic() + SHARE_WAIT_S
        while not want <= set(os.listdir(tmp)):
            if time.monotonic() > deadline:
                raise RuntimeError(f"step {step}: shares "
                                   f"{sorted(want - set(os.listdir(tmp)))} "
                                   f"not written within {SHARE_WAIT_S} s")
            time.sleep(0.01)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "n_hosts": self.n_hosts,
                       "sharded": True}, f)
        d = self._step_dir(step)
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
        with open(os.path.join(d, "COMMITTED"), "w") as f:
            f.write("ok")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ----------------------------- load -----------------------------

    def latest_step(self) -> int | None:
        best = None
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "COMMITTED")):
                s = int(m.group(1))
                best = s if best is None or s > best else best
        return best

    def restore(self, step: int, like):
        """Restore into the structure of ``like`` (shapes must match):
        a checkpoint in the reference's format, whatever host count
        saved it, or over processes this process's share.  Returns numpy
        arrays (bf16 as ``ml_dtypes.bfloat16``); ``device.to_torch``
        moves them."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, treedef = _tree.flatten(like)
        paths = tree_paths(like)
        if manifest.get("sharded"):
            return _tree.unflatten(treedef,
                                   self._restore_share(d, manifest, leaves,
                                                       paths))
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint holds {len(manifest['leaves'])} "
                             f"leaves, the tree {len(leaves)}")
        shards: dict[int, np.lib.npyio.NpzFile] = {}
        out = []
        for i, (leaf, meta) in enumerate(zip(leaves, manifest["leaves"])):
            sh = meta["shard"]
            if sh not in shards:
                shards[sh] = np.load(os.path.join(d, f"shard_{sh:05d}.npz"))
            if meta["path"] != paths[i]:
                raise ValueError(f"leaf {i}: checkpoint has {meta['path']}, "
                                 f"the tree {paths[i]}")
            arr = _from_file(shards[sh][str(i)], meta["dtype"])
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"leaf {meta['path']}: checkpoint shape {arr.shape} "
                    f"!= expected {tuple(leaf.shape)}")
            out.append(arr)
        return _tree.unflatten(treedef, out)

    def _restore_share(self, d: str, manifest: dict, leaves, paths) -> list:
        """This process's share of the sharded checkpoint in ``d``."""
        if manifest["n_hosts"] != self.n_hosts:
            raise ValueError(f"checkpoint of {manifest['n_hosts']} "
                             f"processes; this store reads "
                             f"{self.n_hosts}")
        name = os.path.join(d, f"share_{self.host_id:05d}")
        with open(name + ".json") as f:
            meta = json.load(f)
        if [m["path"] for m in meta] != paths:
            raise ValueError(f"share {self.host_id}: its leaves are not the "
                             f"tree's")
        out = []
        with np.load(name + ".npz") as got:
            for i, (leaf, m) in enumerate(zip(leaves, meta)):
                arr = _from_file(got[str(i)], m["dtype"])
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"leaf {m['path']}: share shape "
                                     f"{arr.shape} != expected "
                                     f"{tuple(leaf.shape)}")
                out.append(arr)
        return out
