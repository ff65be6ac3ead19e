"""Training step factory of the port: the AdamW step of the dense decoder on
one device, with gradient accumulation over microbatches.

Port of ``repro.training.train_loop``.  The step takes the model (its
parameters are the tree), the optimizer state of
:func:`repro_torch.optim.adamw.init` and a batch of tensors, and updates
the parameters and the state in place.  The compressed cross-pod gradient
sync of the reference needs a mesh: it is not ported yet (ROADMAP Queue 1
item 11, part 2, sharding).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import LM_ITEM, RunCfg, lm_loss
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    microbatches: int = 1
    grad_compression: bool = False   # cross-pod int8 + error feedback
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()


def make_loss_fn(cfg: ArchConfig, run: RunCfg):
    def loss_fn(params, batch):
        return lm_loss(cfg, run, params, batch)
    return loss_fn


def make_train_step(cfg: ArchConfig, run: RunCfg, tcfg: TrainCfg):
    """Returns ``step(params, opt_state, batch) -> (loss, metrics)``:
    ``params`` is the model, updated in place with ``opt_state``; metrics
    ``grad_norm``, ``lr`` and ``loss``.  With ``microbatches`` > 1 the
    batch is cut along its leading axis, and the loss and the gradients
    are the sums over the microbatches times 1/microbatches, in the
    reference's order."""
    if tcfg.grad_compression:
        raise NotImplementedError(
            "grad_compression syncs gradients across pods of a mesh; the "
            f"port trains on one device (sharding: {LM_ITEM}, part 2)")
    loss_fn = make_loss_fn(cfg, run)

    def grads_of(params, batch):
        names, leaves = zip(*params.named_parameters())
        if tcfg.microbatches == 1:
            loss = loss_fn(params, batch)
            return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))
        mb = tcfg.microbatches
        parts = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])
                 for k, x in batch.items()}
        dev = leaves[0].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in leaves]
        for i in range(mb):
            loss = loss_fn(params, {k: x[i] for k, x in parts.items()})
            grads = torch.autograd.grad(loss, leaves)
            total = total + loss.detach()
            torch._foreach_add_(acc, grads)
        inv = 1.0 / mb
        return total * inv, dict(zip(names, torch._foreach_mul(acc, inv)))

    def step(params, opt_state, batch):
        params.requires_grad_(True)
        loss, grads = grads_of(params, batch)
        _, new_state, metrics = adamw.update(
            tcfg.adamw, grads, opt_state, dict(params.named_parameters()))
        opt_state.update(new_state)
        return loss, dict(metrics, loss=loss)

    return step
