"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources under ``csrc/`` are compiled at first use, on the machine
with the card, into ``build/repro_torch_kernels/`` at the repository
root (``REPRO_TORCH_BUILD_DIR`` overrides it).  Each library is named
by a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header never loads a stale build, and
it is written under a temporary name and renamed into place, so
concurrent first uses do not collide.  Nothing is built when
this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    pkg = Path(__file__).resolve().parents[1]  # src/repro_torch
    root = pkg.parent.parent if pkg.parent.name == "src" else pkg
    return root / "build" / "repro_torch_kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, which has the CUDA toolkit")


def _lib_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(repr(FLAGS).encode())
    return build_dir() / f"{source.stem}-{h.hexdigest()[:12]}.so"


def compile_source(source: Path) -> Path:
    """Compile ``source`` into its hashed shared library (no-op when it
    exists)."""
    out = _lib_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([nvcc(), *FLAGS, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(CSRC / f"{name}.cu")))
            _loaded[name] = lib
        return lib
