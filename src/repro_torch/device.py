"""Where the port runs, and payload conversion between numpy and torch.

Every entry point of the port runs on the CUDA card unless the caller
asks for the CPU (``device="cpu"``, as the tests do).  Nothing here is
decided when the module is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import _tree

_NUMPY_OF_TORCH = {
    torch.bool: np.bool_, torch.int8: np.int8, torch.uint8: np.uint8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64,
}


def resolve(device=None) -> torch.device:
    """The device a port entry point runs on: the CUDA card when
    ``device`` is None (raises when there is none), else ``device``
    as given.  A CUDA device that is not present raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is absent")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _is_bf16(dtype) -> bool:
    return np.dtype(dtype).name == "bfloat16"


def leaf_to_torch(a, device) -> torch.Tensor:
    """One numpy array (or tensor) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    arr = np.asarray(a)
    if _is_bf16(arr.dtype):
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def leaf_to_numpy(t) -> np.ndarray:
    """One tensor as a numpy array (bf16 through ``ml_dtypes``)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only bf16 payloads need it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree, device):
    """A numpy payload tree as a torch tree on ``device``."""
    dev = torch.device(device)
    return _tree.tree_map(lambda a: leaf_to_torch(a, dev), tree)


def to_numpy(tree):
    """A torch payload tree as a numpy tree (copied to the host)."""
    return _tree.tree_map(leaf_to_numpy, tree)


def dtype_str(dtype) -> str:
    """numpy's ``dtype.str`` for a numpy or torch dtype ("<i4", ...);
    bf16 is named "bfloat16" on both sides."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return "bfloat16"
        return np.dtype(_NUMPY_OF_TORCH[dtype]).str
    if _is_bf16(dtype):
        return "bfloat16"
    return np.dtype(dtype).str
