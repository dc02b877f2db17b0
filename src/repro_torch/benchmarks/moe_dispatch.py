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


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    common.add_json_arg(ap, DEFAULT_JSON)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    rows = run([], device=dev)
    common.print_csv(rows)
    if args.json:
        common.write_rows(args.json, "torch_moe_dispatch", rows, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
