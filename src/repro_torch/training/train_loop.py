"""Training step factory of the port: the AdamW step of the dense decoder,
with gradient accumulation over microbatches, on one device or sharded
over a mesh of rank processes (FSDP × TP), and the compressed cross-pod
gradient sync.

Port of ``repro.training.train_loop``.  The step takes the model (its
parameters are the tree; on a mesh this rank's shards,
:func:`repro_torch.models.transformer.shard_model`), the optimizer state of
:func:`repro_torch.optim.adamw.init` and the global batch, and updates the
parameters and the state in place.  On a mesh each rank takes its rows of
the global batch (of each microbatch, as the reference's reshape cuts
them), and the loss is the global mean (its gradients summed over the
data axes inside the backward: :mod:`repro_torch.models.transformer`).
With ``grad_compression`` on a mesh with a ``pod`` axis the step is the
reference's ``step_compressed``: the loss and the
gradients of each pod's rows, the gradients synced over ``pod`` as int8
with error feedback (:mod:`repro_torch.distributed.compression`), the
loss averaged over the pods.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as SH
from repro_torch.models.transformer import RunCfg, local_rows, lm_loss, param_specs
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


def cut_axes(cfg: ArchConfig, run: RunCfg) -> dict | None:
    """``{name: the mesh axes its spec cuts}`` on ``run.mesh`` (None on one
    device)."""
    if run.mesh is None:
        return None
    return {n: SH.spec_axes(s) for n, s in param_specs(cfg, run.mesh).items()}


def make_train_step(cfg: ArchConfig, run: RunCfg, tcfg: TrainCfg):
    """Returns ``step(params, opt_state, batch) -> (loss, metrics)``:
    ``params`` is the model, updated in place with ``opt_state``; metrics
    ``grad_norm``, ``lr`` and ``loss``.  With ``microbatches`` > 1 the
    batch is cut along its leading axis, and the loss and the gradients
    are the sums over the microbatches times 1/microbatches, in the
    reference's order.  With ``grad_compression`` on a mesh with a ``pod``
    axis it returns ``step(params, opt_state, residuals, batch) -> (loss,
    metrics, residuals)`` instead (``compression.init_residuals`` of the
    parameters gives the first residuals); otherwise the flag changes
    nothing, as in the reference."""
    compressed = (tcfg.grad_compression and run.mesh is not None
                  and "pod" in run.mesh.shape)
    axes = cut_axes(cfg, run)

    def grads_of(params, batch, r):
        names, leaves = zip(*params.named_parameters())
        loss_fn = make_loss_fn(cfg, r)
        if tcfg.microbatches == 1:
            loss = loss_fn(params, {k: local_rows(x, r) for k, x in batch.items()})
            return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))
        mb = tcfg.microbatches
        parts = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])
                 for k, x in batch.items()}
        dev = leaves[0].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in leaves]
        for i in range(mb):
            loss = loss_fn(params, {k: local_rows(x[i], r) for k, x in parts.items()})
            grads = torch.autograd.grad(loss, leaves)
            total = total + loss.detach()
            torch._foreach_add_(acc, grads)
        inv = 1.0 / mb
        return total * inv, dict(zip(names, torch._foreach_mul(acc, inv)))

    def step(params, opt_state, batch):
        params.requires_grad_(True)
        loss, grads = grads_of(params, batch, run)
        _, new_state, metrics = adamw.update(
            tcfg.adamw, grads, opt_state, dict(params.named_parameters()), axes)
        opt_state.update(new_state)
        return loss, dict(metrics, loss=loss)

    if not compressed:
        return step

    # --- compressed cross-pod DP: each pod's rows, the pod axis synced as int8
    inner = dataclasses.replace(run, per_pod=True)

    def step_compressed(params, opt_state, residuals, batch):
        params.requires_grad_(True)
        pod_batch = {k: local_rows(x, run, ("pod",)) for k, x in batch.items()}
        loss, grads = grads_of(params, pod_batch, inner)
        grads, residuals = comp.pod_sync_compressed(grads, residuals, "pod", axes)
        loss = C.all_reduce(loss, "pod", "sum") / C.axis_size("pod")
        _, new_state, metrics = adamw.update(
            tcfg.adamw, grads, opt_state, dict(params.named_parameters()), axes)
        opt_state.update(new_state)
        return loss, dict(metrics, loss=loss), residuals

    return step_compressed
