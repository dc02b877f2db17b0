"""The port's scan service against the JAX package's, on the CPU.

One burst of requests made with numpy from a seed goes through both
services under the same cost constants: every result, every batch's
rounds and fuse decision, and the warmup contract must agree.  Integer
payloads, so the tolerance is 0.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import scan_api as rsa
from repro.serve import Bucket as RBucket
from repro.serve import ScanService as RService
from repro_torch import device as tdev
from repro_torch.core import scan_api as tsa
from repro_torch.core.schedule import StackedExecutor
from repro_torch.serve import AdmissionError, Bucket, ScanService

P = 16


def _buckets(cls):
    return [cls(kind="scan_total", monoid="add", shape=(64,),
                dtype=np.int32, name="moe"),
            cls(kind="exclusive", monoid="add", shape=(),
                dtype=np.int32, name="compression"),
            cls(kind="exclusive", monoid="max", shape=(3, 5),
                dtype=np.int64, name="maxes")]


def _burst(n, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        pick = rng.integers(0, 3)
        if pick == 0:
            x = rng.integers(0, 32, (P, 64)).astype(np.int32)
            x[:, 60:] = 0
            reqs.append((x, "scan_total", "add"))
        elif pick == 1:
            reqs.append((rng.integers(1, 4096, P).astype(np.int32),
                         "exclusive", "add"))
        else:
            reqs.append((rng.integers(-1000, 1000, (P, 3, 5)),
                         "exclusive", "max"))
    return reqs


def _serve(svc, reqs):
    svc.warmup()
    handles = [svc.submit(x, kind=k, monoid=m, now=0.0) for x, k, m in reqs]
    svc.drain()
    return svc, handles


COUNTS = ("submitted", "admitted", "completed", "batches", "fused_batches",
          "rounds_executed", "rounds_serial_equiv", "ops_executed")


_np = tdev.to_numpy


def test_burst_matches_reference_service():
    ref_cm = rsa.DEFAULT_COST_MODEL
    port_cm = tsa.CostModel(**{f.name: getattr(ref_cm, f.name)
                               for f in dataclasses.fields(ref_cm)})
    reqs = _burst(48)
    ref, want = _serve(RService(P, _buckets(RBucket), max_batch=8,
                                cost_model=ref_cm), reqs)
    svc, got = _serve(ScanService(P, _buckets(Bucket), max_batch=8,
                                  executor=StackedExecutor("cpu"),
                                  cost_model=port_cm), reqs)
    for g, w in zip(got, want):
        assert g.status == w.status == "done"
        gr, wr = _np(g.result), w.result
        if isinstance(wr, tuple):
            assert all(np.array_equal(a, np.asarray(b))
                       for a, b in zip(gr, wr))
        else:
            assert np.array_equal(gr, np.asarray(wr))
    assert svc.post_warmup_compiles == ref.post_warmup_compiles == 0
    gm, rm = svc.metrics.snapshot(), ref.metrics.snapshot()
    assert {k: gm[k] for k in COUNTS} == {k: rm[k] for k in COUNTS}


def test_burst_answers_and_warmup_contract():
    svc = ScanService(P, _buckets(Bucket), max_batch=8,
                      executor=StackedExecutor("cpu"))
    reqs = _burst(48, seed=1)
    _, handles = _serve(svc, reqs)
    for h, (x, kind, monoid) in zip(handles, reqs):
        acc = np.maximum.accumulate if monoid == "max" else np.cumsum
        ident = np.iinfo(x.dtype).min if monoid == "max" else 0
        pre = np.full_like(x, ident)
        pre[1:] = acc(x[:-1], axis=0)
        if kind == "scan_total":
            prefix, total = _np(h.result)
            assert np.array_equal(prefix, pre)
            assert np.array_equal(total, np.broadcast_to(x.sum(0), x.shape))
        else:
            assert np.array_equal(_np(h.result), pre)
    assert svc.post_warmup_compiles == 0
    assert svc.metrics.fused_round_win >= 2


def test_admission_errors():
    svc = ScanService(4, [Bucket(shape=(), dtype=np.int32)], max_queue=2,
                      executor=StackedExecutor("cpu"))
    with pytest.raises(AdmissionError) as e:
        svc.submit(np.zeros(3, np.int32))
    assert e.value.reason == "bad_payload"
    with pytest.raises(AdmissionError) as e:
        svc.submit(np.zeros(4, np.int64))
    assert e.value.reason == "unknown_bucket"
    svc.submit(np.zeros(4, np.int32))
    svc.submit(np.zeros(4, np.int32))
    with pytest.raises(AdmissionError) as e:
        svc.submit(np.zeros(4, np.int32))
    assert e.value.reason == "overload"


def test_deadline_drops_unstarted_requests():
    svc = ScanService(4, [Bucket(shape=(), dtype=np.int32)],
                      executor=StackedExecutor("cpu"))
    late = svc.submit(np.ones(4, np.int32), now=0.0, timeout=1.0)
    ok = svc.submit(np.ones(4, np.int32), now=0.0)
    svc.tick(now=5.0)
    assert late.status == "timeout" and ok.status == "done"
    assert svc.metrics.timed_out == 1
