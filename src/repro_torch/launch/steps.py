"""Step functions, from the JAX package's ``launch/steps.py``.

``make_train_step`` builds the training step: the loss and its
gradient through autograd (the scans' backward is the
``affine_chunk_bwd`` kernel), clipping at a global norm of 1.0, the
cosine schedule and AdamW.  The shapes table, the abstract input
specs, the shardings and ``lower_cell`` wait for the dry-run slice.
"""

from __future__ import annotations

import torch

from repro_torch import _tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_lr


def make_train_step(cfg: ModelConfig, ranks=(1, 1), *, lr_peak: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    device=None, model: Model | None = None):
    """The train step ``(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``.  ``params`` are leaves that take gradients
    (``Model.load_params(tree, trainable=True)``); the batch holds
    tensors on the model's device.  Parameters and moments are updated
    in place (``optim.adamw``).  ``metrics`` holds the loss's (``ce``,
    ``load_balance``, ``dropped``) and ``loss``, ``grad_norm`` and
    ``lr``, as detached 0-d tensors on the device: reading them is the
    caller's synchronise."""
    model = model if model is not None else Model(cfg, ranks, device)

    def train_step(params, opt_state, batch, step):
        leaves, treedef = _tree.flatten(params)
        frozen = [i for i, p in enumerate(leaves) if not p.requires_grad]
        if frozen:
            raise ValueError(f"{len(frozen)} parameter leaves take no "
                             f"gradient: load them with trainable=True")
        loss, metrics = model.loss(params, batch)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = _tree.unflatten(treedef, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, got)])
        del got
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_lr(torch.as_tensor(step, device=loss.device),
                       peak=lr_peak, warmup=warmup, total=total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
        out = {k: v.detach() for k, v in metrics.items()}
        out.update(loss=loss.detach(), grad_norm=gnorm, lr=lr)
        return params, opt_state, out

    return train_step
