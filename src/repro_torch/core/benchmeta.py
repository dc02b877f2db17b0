"""The metadata envelope of a benchmark's JSON: which code, on which
card, at what time.

    {"meta": {"meta_schema_version": 1, "git_sha": "...",
              "timestamp_utc": "2026-...Z", "platform": "NVIDIA H100 ..."},
     ...}

``meta_schema_version`` versions the header itself; ``platform`` names
the card the numbers describe (the same reason calibrated profiles
fingerprint it).
"""

from __future__ import annotations

import datetime
import os
import subprocess

import torch

BENCH_META_SCHEMA_VERSION = 1


def git_sha(cwd: str | None = None) -> str:
    """The current commit sha, or "unknown" outside a git checkout
    (benchmarks run from exported trees too)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def worker_platform() -> str:
    """The CUDA card's name, or "cpu" where no card is present."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def bench_metadata() -> dict:
    """The common ``"meta"`` header (see the module docstring)."""
    return {
        "meta_schema_version": BENCH_META_SCHEMA_VERSION,
        "git_sha": git_sha(),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"),
        "platform": worker_platform(),
    }
