"""ScanService: continuous batching of live scan requests.

The paper's small-payload scans are latency-bound — cost ≈ α·q, not
bytes — so a service facing many concurrent small exscan requests wins
exactly one way: amortize the α·q round cost across requests.
``fused_scan``/``plan_fused`` already do that for a static list; this
module is the dynamic version — the LightScan-style continuous-batching
loop over live traffic:

    submit(payload) ──admission──▶ bucket queues ──tick──▶ batches
                                                     │
                                    plan_fused(k specs) per bucket
                                      ├─ fused:  ONE packed schedule,
                                      │          k requests / α·q rounds
                                      └─ serial: k solo plans (the cost
                                                 model said packing loses)

Admission is by :class:`~repro_torch.serve.bucket.Bucket` key (kind, monoid,
per-rank shape, dtype) with queue-depth backpressure; each ``tick``
drains up to ``max_batch`` compatible requests per bucket into one
``plan_fused`` decision and executes it.  Clocking is caller-supplied
(``now``) so the same service runs under the benchmark's virtual clock
or a wall clock; execution time is measured for real around the
executor and pushed onto the clock, which is what makes queueing delay
— and therefore p50/p99 latency vs request rate — come out of the
bench honestly.

Warmup contract: a bucket's plan-key space is closed — the only
payload sizes the planner can see are k·bucket.nbytes for
k in 1..max_batch — so :meth:`ScanService.warmup` primes every
(bucket, k) plan up front and :attr:`ScanService.post_warmup_compiles`
(the ``plan_cache_info()`` miss counter delta) proves steady state
never compiles.  The serve bench gates on it being zero.

On the card the executor's work is asynchronous, so the service
synchronises the executor's device before it reads the clock after a
batch: the measured seconds are device time, not enqueue time.

Online tuning: :meth:`ScanService.attach_autotuner` feeds every batch's
execution seconds (from after planning to after that synchronise) to a
:class:`~repro_torch.core.autotune.AutoTuner`; an install re-prices the
service and re-warms it (:meth:`ScanService.install_cost_model`).

Deadline semantics: deadlines are *admission-to-start* — a request
whose deadline has passed when its bucket is drained is dropped
(status "timeout", never executed, counted in metrics); once a request
makes it into an executing batch it completes even if its deadline
expires mid-execution (the batch is already on the wire).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.scan_api import (
    current_cost_model, plan_cache_info, plan_fused)
from repro_torch.serve.bucket import Bucket, bucket_key
from repro_torch.serve.metrics import ServiceMetrics


class AdmissionError(RuntimeError):
    """A request the service refused to queue.

    ``reason`` is machine-readable: "unknown_bucket" (shape/dtype/
    monoid outside the declared set), "overload" (queue-depth
    backpressure — retry later), or "bad_payload" (malformed array).
    """

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass
class ScanRequest:
    """One queued scan: payload + bucket + timing.

    ``status`` walks queued → done | timeout.  ``payload`` is a tensor
    on the executor's device.  ``result`` is the scan output tensor
    (for scan_total buckets: the (prefix, total) tuple);
    ``latency`` is completion time minus submit time under the
    service clock.
    """

    rid: int
    bucket: Bucket
    payload: Any
    t_submit: float
    deadline: float | None = None
    status: str = "queued"
    result: Any = None
    t_done: float | None = None

    @property
    def latency(self) -> float | None:
        return None if self.t_done is None else \
            self.t_done - self.t_submit


class ScanService:
    """Continuous-batching scan server over one executor.

    Args:
      p: rank count every request's payload carries (leading axis).
      buckets: declared :class:`Bucket` set — the admissible request
        classes.  Warmup covers exactly these.
      axis_name: mesh axis for the specs (None for the simulator).
      max_batch: per-bucket batch-occupancy cap per tick (also the
        warmup's largest primed k).
      max_queue: total queued-request cap; admission beyond it raises
        ``AdmissionError("overload")`` — the backpressure signal.
      default_timeout: seconds after submit at which an un-started
        request is dropped (None: requests never expire).
      executor: schedule executor (default: ``StackedExecutor()`` on
        the CUDA card; ``StackedExecutor("cpu")`` serves on the CPU).
      cost_model: pricing for the fuse-vs-serial decision (default:
        the ambient model at construction, captured so warmup and
        steady state share one plan-cache key space).
      admit_unknown: auto-declare buckets for unseen shapes instead of
        rejecting (forfeits the warmup guarantee for their first
        batches; off by default).
    """

    def __init__(self, p: int, buckets, *, axis_name=None,
                 max_batch: int = 16, max_queue: int = 256,
                 default_timeout: float | None = None,
                 executor=None, cost_model=None,
                 admit_unknown: bool = False):
        if p < 1:
            raise ValueError(f"need p >= 1 ranks, got {p}")
        if max_batch < 1:
            raise ValueError(f"need max_batch >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"need max_queue >= 1, got {max_queue}")
        self.p = int(p)
        self.axis_name = axis_name
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.default_timeout = default_timeout
        self.executor = executor if executor is not None else \
            schedule_lib.StackedExecutor()
        self.cost_model = cost_model if cost_model is not None else \
            current_cost_model()
        self.admit_unknown = bool(admit_unknown)
        self.buckets: dict[tuple, Bucket] = {}
        self._queues: dict[tuple, deque] = {}
        for b in buckets:
            if b.key in self.buckets:
                raise ValueError(f"duplicate bucket {b.name!r}")
            self.buckets[b.key] = b
            self._queues[b.key] = deque()
        self.metrics = ServiceMetrics()
        self._rid = itertools.count()
        self._rr = 0  # round-robin offset across bucket queues
        self._now = 0.0
        self._warmup_misses: int | None = None
        self.last_decision = None  # the latest batch's FusedPlan
        self._autotuner = None  # core.autotune.AutoTuner, when attached
        self._autotune_tier: str | None = None

    # -- clock ---------------------------------------------------------

    @property
    def now(self) -> float:
        """The service clock: max of every caller-supplied ``now`` and
        the accumulated execution time."""
        return self._now

    def _advance(self, now) -> float:
        if now is not None:
            self._now = max(self._now, float(now))
        return self._now

    # -- admission -----------------------------------------------------

    @property
    def depth(self) -> int:
        """Total queued (not yet executed) requests."""
        return sum(len(q) for q in self._queues.values())

    def submit(self, payload, *, kind: str = "exclusive",
               monoid: str = "add", now: float | None = None,
               deadline: float | None = None,
               timeout: float | None = None) -> ScanRequest:
        """Admit one request, or raise :class:`AdmissionError`.

        ``payload`` is a numpy array or tensor with the rank axis
        leading; it is moved to the executor's device on admission.
        ``deadline`` is absolute (service clock); ``timeout`` is
        relative to now and wins over ``default_timeout``.  Returns the
        queued :class:`ScanRequest` (its ``result`` materializes after
        a ``tick`` executes the batch it lands in).
        """
        t = self._advance(now)
        self.metrics.submitted += 1
        arr = payload if isinstance(payload, torch.Tensor) \
            else np.asarray(payload)
        if arr.ndim < 1 or arr.shape[0] != self.p:
            self.metrics.rejected_unknown += 1
            raise AdmissionError(
                "bad_payload",
                f"payload must carry a leading rank axis of {self.p}; "
                f"got shape {tuple(arr.shape)}")
        key = bucket_key(kind, monoid, arr.shape[1:], arr.dtype)
        bucket = self.buckets.get(key)
        if bucket is None:
            if not self.admit_unknown:
                self.metrics.rejected_unknown += 1
                raise AdmissionError(
                    "unknown_bucket",
                    f"no declared bucket for key {key}; declared: "
                    f"{[b.name for b in self.buckets.values()]}")
            bucket = Bucket(kind=kind, monoid=monoid,
                            shape=arr.shape[1:], dtype=arr.dtype)
            self.buckets[key] = bucket
            self._queues[key] = deque()
        if self.depth >= self.max_queue:
            self.metrics.rejected_overload += 1
            raise AdmissionError(
                "overload",
                f"queue depth {self.depth} at max_queue="
                f"{self.max_queue}; backpressure — retry later")
        arr = device_lib.leaf_to_torch(bucket.validate(arr, self.p),
                                       self.executor.device)
        if timeout is not None:
            deadline = t + timeout
        elif deadline is None and self.default_timeout is not None:
            deadline = t + self.default_timeout
        req = ScanRequest(rid=next(self._rid), bucket=bucket,
                          payload=arr, t_submit=t, deadline=deadline)
        self._queues[key].append(req)
        self.metrics.admitted += 1
        self.metrics.queue_depth = self.depth
        return req

    # -- warmup --------------------------------------------------------

    def warmup(self) -> dict:
        """Prime the plan cache over the closed plan-key space of the
        declared buckets: every (bucket, batch size k) for k in
        1..max_batch — both the k solo plans and the packed-payload
        candidate ``plan_fused`` prices (planning builds the schedule
        IR too, so no tick ever traces a new round structure).  Records
        the cache-miss baseline that
        :attr:`post_warmup_compiles` measures against.
        """
        primed = 0
        for bucket in self.buckets.values():
            spec = bucket.spec(self.axis_name)
            for k in range(1, self.max_batch + 1):
                plan_fused([spec] * k, self.p, [bucket.nbytes] * k,
                           cost_model=self.cost_model)
                primed += 1
        info = plan_cache_info()
        self._warmup_misses = info["misses"]
        return {"buckets": len(self.buckets),
                "fused_plans_primed": primed, "cache": info}

    def install_cost_model(self, cost_model, *,
                           rewarm: bool = True) -> dict | None:
        """Swap the service's pricing (a recalibrated profile or a plain
        :class:`~repro_torch.core.scan_api.CostModel`) and, by default,
        re-``warmup()`` at once: the swap changes every plan-cache key
        of the declared buckets, so the re-warm keeps the
        zero-post-warmup-compile contract before any queued request is
        drained.  Returns the warmup report, or None when
        ``rewarm=False``."""
        self.cost_model = cost_model
        return self.warmup() if rewarm else None

    def attach_autotuner(self, tuner, *, tier: str | None = None):
        """Wire a :class:`~repro_torch.core.autotune.AutoTuner` into the
        loop: every executed batch feeds one sample (the features summed
        over the batch's executed schedules against its execution
        seconds), ``tick`` drives the refit cadence, and an install
        calls :meth:`install_cost_model` (re-warming a warmed service).
        ``tier`` defaults to the tier the tuner's profile routes the
        service's axis to."""
        self._autotuner = tuner
        self._autotune_tier = tier if tier is not None else \
            tuner.profile.tier_for_axis(self.axis_name)
        tuner.subscribe(lambda profile: self.install_cost_model(
            profile, rewarm=self._warmup_misses is not None))
        return tuner

    @property
    def post_warmup_compiles(self) -> int | None:
        """Plan-cache misses since :meth:`warmup` (None before warmup).
        The steady-state contract — and the serve bench's CI gate — is
        that this stays 0: every batch size of every declared bucket
        was primed, so serving never compiles."""
        if self._warmup_misses is None:
            return None
        return plan_cache_info()["misses"] - self._warmup_misses

    # -- the continuous batcher ----------------------------------------

    def _expire(self, queue: deque, now: float) -> list[ScanRequest]:
        expired = []
        kept = deque()
        for req in queue:
            if req.deadline is not None and req.deadline <= now:
                req.status = "timeout"
                req.t_done = now
                self.metrics.timed_out += 1
                expired.append(req)
            else:
                kept.append(req)
        queue.clear()
        queue.extend(kept)
        return expired

    def tick(self, now: float | None = None) -> list[ScanRequest]:
        """One batcher step: for each bucket with queued requests
        (round-robin start for fairness), drop expired requests, drain
        up to ``max_batch`` into ONE ``plan_fused`` decision, execute
        it, and stamp completions.  Returns every request finalized
        this tick (done and timed out); the clock advances by the
        measured execution seconds, so latencies include queueing AND
        service time."""
        self._advance(now)
        finalized: list[ScanRequest] = []
        keys = list(self._queues)
        if keys:
            self._rr = (self._rr + 1) % len(keys)
            keys = keys[self._rr:] + keys[:self._rr]
        for key in keys:
            queue = self._queues[key]
            finalized.extend(self._expire(queue, self._now))
            if not queue:
                continue
            batch = [queue.popleft()
                     for _ in range(min(self.max_batch, len(queue)))]
            finalized.extend(self._run_batch(self.buckets[key], batch))
        self.metrics.queue_depth = self.depth
        if self._autotuner is not None:
            # the refit cadence rides the batcher: an install fires the
            # attach-time subscriber, which re-prices and re-warms
            self._autotuner.maybe_refit()
        return finalized

    def _run_batch(self, bucket: Bucket,
                   batch: list[ScanRequest]) -> list[ScanRequest]:
        spec = bucket.spec(self.axis_name)
        k = len(batch)
        t0 = time.perf_counter()
        fp = plan_fused([spec] * k, self.p, [bucket.nbytes] * k,
                        cost_model=self.cost_model)
        self.last_decision = fp
        xs = [req.payload for req in batch]
        t_exec = time.perf_counter()
        with schedule_lib.collect_stats() as st:
            results = fp.execute(xs, executor=self.executor)
        device_lib.synchronize(self.executor.device)
        t1 = time.perf_counter()
        seconds = t1 - t0
        self._now += seconds
        if self._autotuner is not None:
            # execution-only seconds against the executed schedules'
            # features (planning time is not fabric time)
            if fp.fused:
                scheds = [fp.packed.schedule()]
                sizes = [fp.packed.payload_bytes]
            else:
                scheds = [pl.schedule() for pl in fp.plans]
                sizes = [pl.payload_bytes for pl in fp.plans]
            self._autotuner.record(
                scheds, sizes, t1 - t_exec, tier=self._autotune_tier,
                monoid=bucket.monoid, stats=st,
                algorithm=fp.packed.algorithm, kind=bucket.kind)
        serial_rounds = sum(pl.rounds for pl in fp.plans)
        self.metrics.record_batch(
            k, fused=fp.fused, rounds=st.rounds,
            serial_rounds=serial_rounds, ops=st.op_applications,
            seconds=seconds)
        for req, res in zip(batch, results):
            req.result = res
            req.status = "done"
            req.t_done = self._now
            self.metrics.record_completion(req.latency)
        return batch

    def drain(self, now: float | None = None, *,
              max_ticks: int = 10_000) -> list[ScanRequest]:
        """Tick until every queue is empty; returns all finalized
        requests.  ``max_ticks`` guards against a caller submitting
        faster than the loop drains (raises RuntimeError)."""
        self._advance(now)
        done: list[ScanRequest] = []
        for _ in range(max_ticks):
            if self.depth == 0:
                return done
            done.extend(self.tick())
        raise RuntimeError(
            f"drain() did not empty the queues in {max_ticks} ticks "
            f"(depth={self.depth})")

    def reset_metrics(self) -> ServiceMetrics:
        """Fresh metrics (benchmark phases); the warmup baseline and
        queues are untouched."""
        self.metrics = ServiceMetrics()
        self.metrics.queue_depth = self.depth
        return self.metrics
