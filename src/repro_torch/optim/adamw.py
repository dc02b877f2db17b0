"""AdamW over a parameter tree, from the JAX package's
``optim/adamw.py``.

Moments are kept in float32 whatever the parameters' dtype (bf16
parameters, fp32 statistics); the update is computed in fp32 and cast
to the parameter's dtype, as the reference does it.  ``torch.optim.AdamW``
does not serve: it updates bf16 parameters in bf16.  ``AdamWState`` is
a ``NamedTuple`` (step, mu, nu), so a checkpoint's leaf paths are the
reference's (``['opt'].mu[...]``).

The port updates in place where the reference returns new arrays: the
parameter tensors and the moments are overwritten (under ``no_grad``)
and the same trees are returned, so a step holds no second copy of
3.4 GB of weights and 13.4 GB of moments (RWKV6-1.6B).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import _tree


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, ()
    mu: Any  # first moment (fp32)
    nu: Any  # second moment (fp32)


def adamw_init(params) -> AdamWState:
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaves = _tree.leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=_tree.tree_map(f32, params),
                      nu=_tree.tree_map(f32, params))


def global_norm(tree, *, reduce=None, owned=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in the tree's order) of each leaf's
    sum of squares in fp32.  Over processes each holding a share of the
    tree: ``owned`` (one bool a leaf, in the tree's order) names the
    leaves this process counts, so a leaf held alike by several is
    counted once (``params.norm_owner``), and ``reduce`` sums the
    processes' fp32 sums (one all-reduce over every process)."""
    total = 0
    leaves = _tree.leaves(tree)
    if owned is not None:
        if len(owned) != len(leaves):
            raise ValueError(f"{len(owned)} ownership flags for "
                             f"{len(leaves)} leaves")
        if leaves and not any(owned):
            total = torch.zeros((), dtype=torch.float32,
                                device=leaves[0].device)
        leaves = [x for x, mine in zip(leaves, owned) if mine]
    for x in leaves:
        total = total + torch.sum(torch.square(x.float()))
    total = torch.as_tensor(total, dtype=torch.float32)
    if reduce is not None:
        total = reduce(total)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, *, reduce=None,
                        owned=None):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm), the norm
    :func:`global_norm`'s (over processes: the same on every one)."""
    norm = global_norm(grads, reduce=reduce, owned=owned)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _tree.tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step, in place.  ``lr`` may be a float or a 0-d
    tensor.  Returns (params, AdamWState) with the step counted."""
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    flat_p, treedef = _tree.flatten(params)
    flat_g, flat_mu, flat_nu = (_tree.leaves(x)
                                for x in (grads, state.mu, state.nu))
    if not len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu):
        raise ValueError("params, grads and moments differ in structure")
    for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu):
        g32 = g.float()
        mu.mul_(b1).add_(g32 * (1.0 - b1))
        nu.mul_(b2).add_(g32 * g32 * (1.0 - b2))
        delta = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        p32 = p.float()
        delta = delta + weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def cosine_lr(step, *, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``floor_frac * peak``, in
    fp32 (a 0-d tensor)."""
    t = torch.as_tensor(step).float()
    warm = peak * t / max(1.0, warmup)
    prog = torch.clamp((t - warmup) / max(1.0, total - warmup), 0, 1)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 *
                  (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)
