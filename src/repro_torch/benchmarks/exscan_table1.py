"""Paper Table 1 / Figure 1 analogue.

The paper benchmarks MPI_Exscan against two-⊕ doubling, 1-doubling and
123-doubling on a 36-node cluster over m ∈ {1..100k} MPI_LONGs
(MPI_BXOR).  Here the four algorithms run as the port runs them:

  (a) MEASURED: ``exscan_measured_p8/{alg}/m{m}``, p = 8 ranks stacked on
      ``--device`` (the card by default) through
      :class:`~repro_torch.core.schedule.StackedExecutor`, int64 xor; the
      minimum of 30 synchronised calls at m ≤ 1000, else 10, after one
      untimed call; every output checked against numpy's xor exscan.
      At these sizes a call costs about its rounds times the host's
      issue of one round: the paper's round-count regime.
  (b) MODELED: ``exscan_modeled_p{p}/{alg}/m{m}`` for the paper's p = 36
      and p ∈ {256, 512}, with the JAX package's α-β-γ formula
      t = rounds·α + rounds·m_bytes·β + ops·m_bytes·γ (native: one
      all-gather, α + p·m_bytes·β + (p−1)·m_bytes·γ/2), its constants
      taken from the default tier of the active profile
      (``launch.mesh.current_profile()``; the card's "stacked" tier by
      default) instead of fixed link and HBM rates.

    PYTHONPATH=src python -m repro_torch.benchmarks.exscan_table1
        [--device cpu] [--json [PATH]]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import oracle

DEFAULT_JSON = "BENCH_torch_exscan_table1.json"

ALGS = ("two_op", "1doubling", "123", "native")
EMS = (1, 10, 100, 1000, 10_000, 100_000)
P_MEASURED = 8
MODELED_PS = (36, 256, 512)


def modeled_us(alg: str, p: int, m: int, cm, itemsize: int = 8) -> float:
    """The α-β-γ time in µs of one exscan of ``m`` items a rank under
    the :class:`~repro_torch.core.scan_api.CostModel` ``cm``."""
    nbytes = m * itemsize
    if alg == "native":  # all-gather + local fold
        t = cm.alpha + p * nbytes * cm.beta \
            + (p - 1) * nbytes * cm.gamma / 2
        return t * 1e6
    st = oracle.verify(p, alg)
    t = st.rounds * cm.alpha + st.rounds * nbytes * cm.beta \
        + st.result_path_ops * nbytes * cm.gamma
    return t * 1e6


def xor_exscan(x: np.ndarray) -> np.ndarray:
    """numpy's exclusive xor scan over the leading (rank) axis."""
    out = np.zeros_like(x)
    if len(x) > 1:
        out[1:] = np.bitwise_xor.accumulate(x[:-1], axis=0)
    return out


def measured(device, ems=EMS) -> dict:
    """``{"alg/m": µs}`` at p = 8: the minimum of the synchronised calls
    of each cell on ``device``; raises when an output differs from
    numpy."""
    import torch

    from repro_torch.benchmarks.common import timed
    from repro_torch.core.scan_api import ScanSpec, scan
    from repro_torch.core.schedule import StackedExecutor

    ex = StackedExecutor(device)
    p = P_MEASURED
    out = {}
    for alg in ALGS:
        spec = ScanSpec(kind="exclusive", monoid="xor", algorithm=alg)
        for m in ems:
            x = np.arange(p * m, dtype=np.int64).reshape(p, m)
            xt = torch.from_numpy(x).to(ex.device)
            got, ts = timed(lambda: scan(xt, spec, executor=ex), ex.device,
                            repeats(m))
            if not np.array_equal(got.cpu().numpy(), xor_exscan(x)):
                raise RuntimeError(f"exscan {alg} at p={p}, m={m} differs "
                                   f"from numpy's")
            out[f"{alg}/{m}"] = min(ts) * 1e6
    return out


def repeats(m: int) -> int:
    """The timed calls of a measured cell of ``m`` items a rank."""
    return 30 if m <= 1000 else 10


def run(csv_rows: list, device=None) -> list:
    """Append the measured and modeled rows; ``device`` None is the
    card (raises when there is none)."""
    from repro_torch import device as device_lib
    from repro_torch.benchmarks.common import wallclock_unit
    from repro_torch.launch import mesh as mesh_lib

    device = device_lib.resolve(device)
    res = measured(device)
    unit = wallclock_unit(device)
    for m in EMS:
        for alg in ALGS:
            csv_rows.append((f"exscan_measured_p{P_MEASURED}/{alg}/m{m}",
                             res[f"{alg}/{m}"], unit))
    prof = mesh_lib.current_profile()
    tier = prof.default_tier
    cm = prof.model(tier)
    for p in MODELED_PS:
        for m in EMS:
            for alg in ALGS:
                csv_rows.append((f"exscan_modeled_p{p}/{alg}/m{m}",
                                 modeled_us(alg, p, m, cm),
                                 f"us_abg_model_{tier}"))
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
        common.write_rows(args.json, "torch_exscan_table1", rows, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
