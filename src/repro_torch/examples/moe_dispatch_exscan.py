"""MoE dispatch with exscan-driven global capacity accounting.

The paper's collective doing real work inside a model: the smoke
Qwen1.5-MoE forward at ranks (data 2, model 4) on ``--device`` (the
card by default), once per exscan algorithm.  The outputs are the same
(the drop policy does not depend on the algorithm); the schedules
differ as Theorem 1 says.  ``dropped`` is the loss's aux term as the
JAX package's example prints it: summed over the MoE layers.

    PYTHONPATH=src python -m repro_torch.examples.moe_dispatch_exscan
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

ARCH = "qwen2_moe_a2_7b"
RANKS = (2, 4)
ALGS = ("auto", "123", "1doubling", "two_op", "native")
TOL = 1e-4


def run(device, *, tokens_shape=(8, 64), algs=ALGS, ranks=RANKS,
        params=None, verbose: bool = True) -> dict:
    """``{alg: (logits, aux)}`` as numpy, on tokens from
    ``default_rng(0)``, with ``params`` (a weight tree on the host; None
    draws it there from seed 0); raises when an algorithm's logits
    leave the first algorithm's by more than 1e-4."""
    import torch

    from repro_torch import configs
    from repro_torch.benchmarks.common import host_weights
    from repro_torch.core.scan_api import ScanSpec
    from repro_torch.models.model import Model

    say = print if verbose else (lambda *a, **k: None)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, tokens_shape).astype(np.int32)
    outs = {}
    for alg in algs:
        cfg = configs.get_smoke(
            ARCH, scan=ScanSpec(kind="exclusive", algorithm=alg))
        model = Model(cfg, ranks, device)
        weights = host_weights(model, params)
        with torch.no_grad():
            logits, aux = model.forward(
                weights, torch.from_numpy(tokens).to(model.dev))
        lg, ax = logits.cpu().numpy(), aux.cpu().numpy()
        outs[alg] = (lg, ax)
        say(f"{alg:>10s}: logits[0,0,:3]={lg[0, 0, :3]} "
            f"load_balance={float(ax[0]):.4f} "
            f"dropped={float(ax[1]):.4%}")
    base = outs[algs[0]][0]
    for alg, (lg, _) in outs.items():
        np.testing.assert_allclose(lg, base, rtol=TOL, atol=TOL,
                                   err_msg=f"{alg} against {algs[0]}")
    say("\nall algorithms produce the same MoE outputs "
        "(the drop policy does not depend on the algorithm) ✓")
    return outs


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch.benchmarks import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    run(device_lib.resolve(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
