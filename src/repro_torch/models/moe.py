"""MoE dispatch accounting through the paper's exscan, on one card.

Each token-holding rank routes its tokens to experts; a token is kept
iff its GLOBAL position within its expert (across all ranks) is under
the expert's global capacity.  That global position is

    global_pos = exscan(per-rank expert counts)[expert] + local_pos

and the capacity accounting also needs the global per-expert totals, so
offsets and totals ride ONE fused "scan_total" schedule
(``scan_api.scan_with_total``).  This is the JAX package's
``models/moe.py`` accounting (``moe_ffn``) as a function of its own,
with the p ranks stacked on a leading axis: the local positions and
counts of every rank come from one launch of the routing kernel.  The
router, the expert FFN, the all-to-all and the combine arrive with the
model-stack slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.scan_api import ScanSpec, scan_with_total
from repro_torch.core.schedule import StackedExecutor
from repro_torch.kernels.moe_routing import moe_routing
from repro_torch.models import params as PD


def dispatch_slots(cfg, top_e: torch.Tensor, *, spec: ScanSpec | None = None,
                   executor=None):
    """The dispatch accounting of p ranks' routing choices.

    top_e: (p, n0, k) int32, each rank's router choices.  Returns
    (positions (p, n0, k), offsets (p, e_pad), totals (p, e_pad),
    keep (p, n0·k) bool, slot (p, n0·k) int32): each entry's position
    in its rank's expert buffer, the exclusive scan of the per-rank
    expert counts across ranks and their sum, whether the entry fits
    the global capacity, and its row in the rank's (e_pad·cap, d) send
    buffer (e_pad·cap where dropped).
    """
    p, n0, k = top_e.shape
    e_pad = PD.experts_padded(cfg)
    positions, counts = moe_routing(top_e, num_experts=e_pad)
    if p > 1:
        spec = spec if spec is not None else cfg.scan_spec
        if executor is None:
            executor = StackedExecutor(top_e.device)
        offsets, totals = scan_with_total(
            counts, spec.over(spec.axis_name, kind="exclusive",
                              monoid="add"), executor=executor)
    else:
        offsets, totals = torch.zeros_like(counts), counts
    cap = max(8, int(cfg.capacity_factor * n0 * k / e_pad))
    cap_global = cap * p
    flat_e = top_e.reshape(p, n0 * k)
    flat_pos = positions.reshape(p, n0 * k)
    global_pos = offsets.gather(1, flat_e.long()) + flat_pos
    keep = (flat_pos < cap) & (global_pos < cap_global)
    slot = torch.where(keep, flat_e * cap + flat_pos,
                       torch.full_like(flat_e, e_pad * cap))
    return positions, offsets, totals, keep, slot
