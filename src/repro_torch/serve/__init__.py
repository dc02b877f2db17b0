"""Continuous-batching scan service on the card.

Live requests are admitted into shape/dtype/monoid buckets, a
continuous batcher drains each bucket into ONE fused schedule per tick
(``plan_fused`` decides fuse-vs-serial by the cost model), the plan
cache is warmed over the declared buckets at startup so steady state
never plans anew, and a metrics surface reports queue depth, batch
occupancy, rounds per request and p50/p99 latency.  The request
generators of the JAX package's ``serve/workloads.py`` are not ported
yet.
"""

from repro_torch.serve.bucket import Bucket, bucket_key, bucket_of
from repro_torch.serve.metrics import ServiceMetrics, percentile
from repro_torch.serve.service import (
    AdmissionError, ScanRequest, ScanService)

__all__ = [
    "AdmissionError",
    "Bucket",
    "ScanRequest",
    "ScanService",
    "ServiceMetrics",
    "bucket_key",
    "bucket_of",
    "percentile",
]
