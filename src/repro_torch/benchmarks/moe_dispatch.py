"""In-situ MoE dispatch benchmark: the MoE model's forward wall time with
each exscan algorithm driving the global-offset collective.

The smoke Qwen1.5-MoE-A2.7B config runs through the port's
:class:`~repro_torch.models.model.Model` at ranks (data 2, model 4), on
``--device`` (the card by default): each forward routes its tokens with
the ``moe_routing`` kernel and takes the offsets and totals of the
(E,)-int count vectors in one ``scan_with_total`` over the rank groups
(the paper's small-m regime).  The sweep pins the algorithm through the
config's ``ScanSpec`` (plus ``"auto"``, the planner's pick).  A row is
the minimum of 10 synchronised forwards after one untimed one, on
tokens (8, 64) drawn from ``numpy.random.default_rng(0)`` per
algorithm, weights drawn on the host from seed 0, as the JAX package's
``benchmarks/moe_dispatch.py`` draws them.

    PYTHONPATH=src python -m repro_torch.benchmarks.moe_dispatch
        [--device cpu] [--json [PATH]]
        [--nprocs N --p-intra P --backend {gloo,nccl}] [--check]

With ``--nprocs N --p-intra P`` (N·P = 8, the bench's 2 × 4 ranks) the
dispatch accounting also runs across a
:class:`~repro_torch.dist.WorkerPool` of N processes holding P ranks
each (``WorkerPool.call("dispatch_slots")``; under ``nccl`` one process
a card): the routing choices of 8 groups of 64 tokens (the forward's
8 × 64 tokens, top-k of the smoke config's experts from
``numpy.random.default_rng(0)``), one row an algorithm, the minimum of
10 pool calls after one untimed one, beside the same call on the
stacked ranks.  The expert all-to-all across processes is not run
here: the rows time the offsets and totals (routing and one
``scan_with_total``).  ``--check`` exits non-zero unless every output
equals the stacked run's (and, under nccl, nothing was staged through
the host).
"""

from __future__ import annotations

import argparse

import numpy as np

DEFAULT_JSON = "BENCH_torch_moe_dispatch.json"

ARCH = "qwen2_moe_a2_7b"
ALGS = ("auto", "123", "1doubling", "two_op", "native")
RANKS = (2, 4)
TOKENS = (8, 64)
REPS = 10


def forward(alg: str, tokens: np.ndarray, device, *, ranks=RANKS,
            params=None, reps: int = REPS):
    """One algorithm's cell: ``(µs, logits, aux)``, the minimum of
    ``reps`` synchronised forwards and the first forward's outputs.
    ``params`` is a weight tree on the host (``Model.load_params``);
    None draws the weights on the host from seed 0, so the card and the
    CPU run the same weights."""
    import torch

    from repro_torch import configs
    from repro_torch.benchmarks.common import host_weights, timed
    from repro_torch.core.scan_api import ScanSpec
    from repro_torch.models.model import Model

    cfg = configs.get_smoke(ARCH,
                            scan=ScanSpec(kind="exclusive", algorithm=alg))
    model = Model(cfg, ranks, device)
    p = host_weights(model, params)
    tok = torch.from_numpy(np.asarray(tokens, np.int32)).to(model.dev)
    with torch.no_grad():
        (logits, aux), ts = timed(lambda: model.forward(p, tok),
                                  model.dev, reps)
    return min(ts) * 1e6, logits, aux


def run(csv_rows: list, device=None, *, outputs: dict | None = None) -> list:
    """Append one row an algorithm; ``device`` None is the card (raises
    when there is none).  ``outputs``, when given, receives each row's
    tokens and first forward's ``(logits, aux)`` under the row's name."""
    from repro_torch import configs
    from repro_torch import device as device_lib
    from repro_torch.benchmarks.common import wallclock_unit

    device = device_lib.resolve(device)
    vocab = configs.get_smoke(ARCH).vocab
    rng = np.random.default_rng(0)
    for alg in ALGS:
        tokens = rng.integers(0, vocab, TOKENS).astype(np.int32)
        us, logits, aux = forward(alg, tokens, device)
        name = f"moe_forward_p8/{alg}"
        csv_rows.append((name, us, wallclock_unit(device)))
        if outputs is not None:
            outputs[name] = (tokens, logits, aux)
    return csv_rows


def dispatch_inputs(seed: int = 0):
    """(p, n0, k) router choices: k distinct experts of the smoke
    config's a token, for the forward's tokens split over its p ranks."""
    from repro_torch import configs

    cfg = configs.get_smoke(ARCH)
    p = RANKS[0] * RANKS[1]
    n0 = TOKENS[0] * TOKENS[1] // p
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random((p, n0, cfg.n_experts)),
                      axis=-1)[..., :cfg.top_k].astype(np.int32)


def run_pool(nprocs: int, p_intra: int, backend: str, device=None, *,
             reps: int = REPS, timeout: float = 300.0) -> list:
    """One row an algorithm of ``dispatch_slots`` across a pool of
    ``nprocs`` processes of ``p_intra`` ranks (p = 8): a dict with the
    pool's µs (the minimum of ``reps`` calls after one untimed), the
    stacked call's µs on the pool's first device, whether every output
    equals the stacked one, and the call's messages and staging
    copies."""
    import torch

    from repro_torch import configs
    from repro_torch.benchmarks.common import timed
    from repro_torch.core.scan_api import ScanSpec
    from repro_torch.dist import WorkerPool
    from repro_torch.models.moe import dispatch_slots

    p = RANKS[0] * RANKS[1]
    if nprocs * p_intra != p:
        raise ValueError(f"{nprocs} processes of {p_intra} ranks are not "
                         f"the bench's p = {p}")
    cfg = configs.get_smoke(ARCH)
    top_e = dispatch_inputs()
    rows = []
    with WorkerPool(nprocs, p_intra=p_intra, backend=backend,
                    device=device, timeout=timeout) as pool:
        top = torch.from_numpy(top_e).to(pool.device)
        for alg in ALGS:
            spec = ScanSpec(kind="exclusive", algorithm=alg)
            res = pool.call("dispatch_slots", top_e, arch=ARCH, smoke=True,
                            spec=spec, repeats=1 + reps)
            want, ts = timed(lambda: dispatch_slots(cfg, top, spec=spec),
                             pool.device, reps)
            rows.append({
                "name": f"moe_dispatch_p{p}/{alg}/procs{nprocs}x{p_intra}/"
                        f"{backend}",
                "us": min(res.seconds[1:]) * 1e6,
                "stacked_us": min(ts) * 1e6,
                "identical": all(np.array_equal(g, w.cpu().numpy())
                                 for g, w in zip(res.outputs, want)),
                "rounds": res.stats["rounds"],
                "messages": res.transport["msgs"],
                "staged_copies": res.transport["staged_copies"],
                "backend": backend, "device": str(pool.device),
                "cards": pool.cards})
    return rows


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common
    from repro_torch.benchmarks.ssm_context_parallel import pool_ok

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    common.add_json_arg(ap, DEFAULT_JSON)
    common.add_pool_args(ap)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    rows = run([], device=dev)
    pool_rows = [] if not args.nprocs else run_pool(
        args.nprocs, args.p_intra, args.backend,
        dev if args.backend == "gloo" else None)
    common.print_csv(rows + [(r["name"], r["us"],
                              common.wallclock_unit(dev))
                             for r in pool_rows])
    if args.json:
        common.write_rows(args.json, "torch_moe_dispatch", rows, dev,
                          pool_rows=pool_rows)
    bad = [r["name"] for r in pool_rows if not pool_ok(r)]
    if args.check and bad:
        print(f"POOL DRIFT in {bad}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
