"""Sharded checkpoints with atomic commit, async save and elastic
restore, on the JAX package's on-disk format (``checkpoint/store.py``
there), so a checkpoint written by one package restores in the other.

Layout:
    <dir>/step_00000100/
        manifest.json          # leaf paths (jax keystr), shapes, dtypes
        shard_00000.npz        # this host's leaves (flat index -> array)
        COMMITTED              # written last: marks the checkpoint usable

Leaves are flattened in ``jax.tree``'s order (``repro_torch._tree``) and
named as ``jax.tree_util.keystr`` names them; bf16 tensors are written
as ``ml_dtypes`` bfloat16 arrays, which ``np.savez`` stores as 2-byte
void records, and read back by the manifest's dtype, bit for bit.

Fault-tolerance contract, as the reference's:
  * save is all-or-nothing (COMMITTED is written after every shard), so
    a crash mid-save leaves the previous checkpoint intact;
  * ``latest_step`` ignores uncommitted directories;
  * restore works with another host count than save (elastic): the
    manifest records which flat leaves live in which shard;
  * a save may run on a background thread, ``wait()`` joining it before
    the next save or exit.  The tensors are copied to host memory
    before the thread starts, so training may overwrite them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

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
            d = self._step_dir(step)
            tmp = d + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            if self.host_id == 0:
                shutil.rmtree(d, ignore_errors=True)
                manifest = {
                    "step": step,
                    "n_hosts": self.n_hosts,
                    "leaves": [
                        {"path": p, "shape": list(a.shape),
                         "dtype": str(a.dtype), "shard": i % self.n_hosts}
                        for i, (p, a) in enumerate(zip(paths, arrays))
                    ],
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
            # every host writes the leaves it owns (round-robin by index)
            mine = {str(i): a for i, a in enumerate(arrays)
                    if i % self.n_hosts == self.host_id}
            np.savez(os.path.join(tmp, f"shard_{self.host_id:05d}.npz"),
                     **mine)
            # single host: commit now; several: host 0 calls commit()
            # after the cross-host barrier (every shard written)
            if self.n_hosts == 1:
                self.commit(step)

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def commit(self, step: int):
        """Publish a checkpoint once every host has written its shard
        (host 0, after a barrier)."""
        d = self._step_dir(step)
        tmp = d + ".tmp"
        expected = {f"shard_{h:05d}.npz" for h in range(self.n_hosts)}
        missing = expected - set(os.listdir(tmp))
        if missing:
            raise RuntimeError(f"commit({step}): missing shards {missing}")
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
        """Restore into the structure of ``like`` (shapes must match),
        whatever host count saved it.  Returns numpy arrays (bf16 as
        ``ml_dtypes.bfloat16``); ``device.to_torch`` moves them."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, treedef = _tree.flatten(like)
        paths = tree_paths(like)
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
