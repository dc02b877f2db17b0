"""Metrics surface of the scan service: counters, gauges, percentiles.

One :class:`ServiceMetrics` per service (resettable per benchmark
phase); ``snapshot()`` is the single dict shape the serve bench JSON,
the tests and any external scraper consume.  The latency list is kept
raw so percentiles are exact — the serve bench runs thousands of
requests, not millions, and p99 from a reservoir would wobble the CI
gate.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def percentile(values, q: float) -> float:
    """Exact percentile of a sequence of seconds (NaN when empty) —
    shared by the service metrics and the launch drivers' per-step
    latency reporting."""
    vals = [v for v in values if v is not None]
    if not vals:
        return float("nan")
    return float(np.percentile(np.asarray(vals, dtype=np.float64), q))


@dataclasses.dataclass
class ServiceMetrics:
    """Counters and distributions of one service (or bench phase).

    Round accounting keeps BOTH sides of the paper's claim: of every
    executed batch the service records the rounds it actually paid
    (``rounds_executed`` — measured by ``collect_stats`` around the
    real execution, not predicted) and what the same requests would
    have paid served serially (``rounds_serial_equiv`` — the sum of the
    k solo plans' rounds).  Their ratio is the fused-batching win the
    serve bench gates on.
    """

    submitted: int = 0
    admitted: int = 0
    rejected_overload: int = 0  # queue-depth backpressure
    rejected_unknown: int = 0  # shape/dtype/monoid outside the buckets
    completed: int = 0
    timed_out: int = 0
    batches: int = 0
    fused_batches: int = 0
    occupancy_sum: int = 0
    rounds_executed: int = 0
    rounds_serial_equiv: int = 0
    ops_executed: int = 0
    service_seconds: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)
    queue_depth: int = 0  # gauge: set by the service every tick

    @property
    def rejected(self) -> int:
        return self.rejected_overload + self.rejected_unknown

    def record_batch(self, k: int, *, fused: bool, rounds: int,
                     serial_rounds: int, ops: int, seconds: float):
        self.batches += 1
        self.fused_batches += 1 if fused else 0
        self.occupancy_sum += k
        self.rounds_executed += rounds
        self.rounds_serial_equiv += serial_rounds
        self.ops_executed += ops
        self.service_seconds += seconds

    def record_completion(self, latency: float):
        self.completed += 1
        self.latencies.append(latency)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.batches if self.batches \
            else float("nan")

    @property
    def rounds_per_request(self) -> float:
        return self.rounds_executed / self.completed if self.completed \
            else float("nan")

    @property
    def fused_round_win(self) -> float:
        """serial-equivalent rounds / executed rounds (>1 means the
        continuous batcher amortized α·q across requests)."""
        return self.rounds_serial_equiv / self.rounds_executed \
            if self.rounds_executed else float("nan")

    def latency_percentile(self, q: float) -> float:
        return percentile(self.latencies, q)

    def snapshot(self) -> dict:
        """The one metrics shape everything consumes (bench JSON rows,
        tests, scrapers)."""
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "rejected_overload": self.rejected_overload,
            "rejected_unknown": self.rejected_unknown,
            "completed": self.completed,
            "timed_out": self.timed_out,
            "queue_depth": self.queue_depth,
            "batches": self.batches,
            "fused_batches": self.fused_batches,
            "mean_occupancy": self.mean_occupancy,
            "rounds_executed": self.rounds_executed,
            "rounds_serial_equiv": self.rounds_serial_equiv,
            "rounds_per_request": self.rounds_per_request,
            "fused_round_win": self.fused_round_win,
            "ops_executed": self.ops_executed,
            "service_seconds": self.service_seconds,
            "latency_p50_s": self.latency_percentile(50),
            "latency_p99_s": self.latency_percentile(99),
            "latency_mean_s": (float(np.mean(self.latencies))
                               if self.latencies else float("nan")),
        }
