"""Request bucketing for the scan service: the admission key.

A :class:`Bucket` names one request class — (kind, monoid, per-rank
shape, dtype).  Everything the continuous batcher does hangs off this
key:

  * requests inside one bucket are *fusable*: same monoid, same kind,
    identical per-rank payload signature, so ``plan_fused`` can pack
    them into one flat buffer and ride a single schedule's rounds;
  * the plan-key space of a bucket is *closed*: the only payload sizes
    the planner ever sees are ``k * bucket.nbytes`` for batch sizes
    k in 1..max_batch, which is what makes the startup warmup contract
    (steady state never compiles) provable via ``plan_cache_info()``
    rather than hoped for.

The admission key is the JAX package's (numpy dtype strings), so a
bucket means the same request class on both sides.  Buckets are
declared up front (``ScanService(buckets=...)``); admission
derives the key of each incoming payload with :func:`bucket_key` and
rejects shapes outside the declared set (unless the service opts into
dynamic buckets, which forfeit the warmup guarantee for their first
batches).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import monoid as monoid_lib
from repro_torch.core.scan_api import KINDS, ScanSpec


def bucket_key(kind: str, monoid, shape, dtype) -> tuple:
    """The canonical admission key: (kind, monoid name, per-rank shape,
    numpy dtype str)."""
    return (kind, monoid_lib.get(monoid).name,
            tuple(int(d) for d in shape), device_lib.dtype_str(dtype))


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One declared request class of the scan service.

    Attributes:
      kind: scan kind ("exclusive" | "scan_total" | ...).
      monoid: monoid registry name (or Monoid; normalized to its name).
      shape: per-rank payload shape (the service adds the leading rank
        axis; scalars use ``()``).
      dtype: numpy dtype (normalized to its ``str`` form).
      name: display label for metrics/benchmark rows.
    """

    kind: str = "exclusive"
    monoid: str = "add"
    shape: tuple = ()
    dtype: str = "<i4"
    name: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        object.__setattr__(self, "monoid",
                           monoid_lib.get(self.monoid).name)
        shape = self.shape
        if isinstance(shape, int):  # shape=(5) typo-friendliness
            shape = (shape,)
        object.__setattr__(self, "shape",
                           tuple(int(d) for d in shape))
        object.__setattr__(self, "dtype", device_lib.dtype_str(self.dtype))
        if not self.name:
            shp = "x".join(map(str, self.shape)) or "scalar"
            object.__setattr__(
                self, "name",
                f"{self.kind}/{self.monoid}/{shp}/"
                f"{_dtype_name(self.dtype)}")

    @property
    def key(self) -> tuple:
        return bucket_key(self.kind, self.monoid, self.shape,
                          self.dtype)

    @property
    def nbytes(self) -> int:
        """Per-rank payload bytes m — the planner's message size."""
        itemsize = 2 if self.dtype == "bfloat16" else \
            np.dtype(self.dtype).itemsize
        return int(math.prod(self.shape)) * itemsize

    def spec(self, axis_name=None) -> ScanSpec:
        """The ScanSpec every request in this bucket plans under."""
        return ScanSpec(kind=self.kind, monoid=self.monoid,
                        algorithm="auto", axis_name=axis_name,
                        payload_bytes=self.nbytes)

    def validate(self, payload, p: int):
        """Check ``payload`` (numpy array or tensor) is (p, *shape) of
        this bucket's dtype; returns it unchanged.  Raises ValueError on
        mismatch."""
        arr = payload if isinstance(payload, torch.Tensor) \
            else np.asarray(payload)
        want = (p,) + self.shape
        if tuple(arr.shape) != want:
            raise ValueError(
                f"bucket {self.name!r} expects payload shape {want}, "
                f"got {tuple(arr.shape)}")
        if device_lib.dtype_str(arr.dtype) != self.dtype:
            raise ValueError(
                f"bucket {self.name!r} expects dtype {self.dtype}, "
                f"got {device_lib.dtype_str(arr.dtype)}")
        return arr


def bucket_of(payload, *, kind: str = "exclusive",
              monoid: str = "add") -> Bucket:
    """Derive the bucket a (p, *shape) payload belongs to (the leading
    axis is the rank axis and is NOT part of the bucket shape)."""
    arr = payload if isinstance(payload, torch.Tensor) \
        else np.asarray(payload)
    if arr.ndim < 1:
        raise ValueError("service payloads carry a leading rank axis; "
                         f"got a {arr.ndim}-d array")
    return Bucket(kind=kind, monoid=monoid, shape=tuple(arr.shape[1:]),
                  dtype=arr.dtype)


def _dtype_name(dtype_str: str) -> str:
    return dtype_str if dtype_str == "bfloat16" else np.dtype(dtype_str).name
