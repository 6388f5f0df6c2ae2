"""Step functions: train / prefill / decode, the counterpart of
`repro/models/steps.py`.

They close over (model, plan, optimizer) and are what `runtime/trainer.py`
executes.  The model must be ``LM(cfg, flash=False)`` for training: the
`flash_attention` kernel has no backward pass and raises under autograd.

The reference pins gradients and microbatches to the parameter and batch
layouts of its mesh (``_constrain_like_params``, ``_micro_split``'s
``ws``).  Every home of a `HomeMesh` lies on one device, so those
layouts move nothing here; the training layouts across cards come with
the ``torch.distributed`` backend (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compression import error_feedback_update
from repro_torch.sharding.partition import NULL_PLAN, MeshPlan
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

AUX_WEIGHT = 0.01


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              vocab_size: int) -> torch.Tensor:
    """The mean next-token nll of (B, S, Vp) logits: float32, the padded
    vocabulary masked to -1e30, ``logsumexp`` less the target's logit.  The
    target's logit is gathered: the reference's one-hot sum adds it to
    zeros only, the same value."""
    lf = logits.float()
    live = torch.arange(lf.shape[-1], device=lf.device) < vocab_size
    lf = torch.where(live, lf, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    tl = lf.gather(-1, targets[..., None].long())[..., 0]
    return (lse - tl).mean()


def make_loss_fn(model: LM, cfg: ArchConfig, plan: MeshPlan = NULL_PLAN):
    """``loss_fn(params, batch) -> (nll + AUX_WEIGHT * aux, nll)``
    (`token_nll`)."""
    def loss_fn(params, batch):
        logits, _, aux = model.forward(params, batch)
        nll = token_nll(logits, batch["targets"], cfg.vocab_size)
        return nll + AUX_WEIGHT * aux, nll

    return loss_fn


def _micro_split(batch, m: int):
    """(GB, ...) -> m microbatches of (GB/m, ...), in order."""
    def split(x):
        assert x.shape[0] % m == 0, (x.shape, m)
        return x.reshape(m, x.shape[0] // m, *x.shape[1:])
    parts = tree_map(split, batch)
    return [tree_map(lambda x: x[i], parts) for i in range(m)]


def make_train_step(model: LM, cfg: ArchConfig, plan: MeshPlan,
                    optimizer: AdamW):
    """``train_step(params, opt_state, batch, accept=None) -> (params,
    opt_state, metrics)``, params and state updated in place (the params'
    tensors are made to require grad: autograd differentiates them).

    Metrics are the reference's: ``loss`` (the nll), ``grad_norm`` (the
    global norm before clipping) and ``step`` (the optimiser step after
    this one), as tensors.  `accept`, when given, sees them before
    anything is written: if it returns False the step writes nothing --
    params, ``m``, ``v``, the step count and the error-feedback residual
    stay as they were -- which is the reference trainer's guard keeping
    its old state and dropping the step's outputs.
    """
    loss_fn = make_loss_fn(model, cfg, plan)
    M = max(cfg.parallel.microbatches, 1)
    accum_dtype = getattr(torch, cfg.parallel.accum_dtype)

    def train_step(params, opt_state, batch, accept=None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            if M == 1:
                loss, nll = loss_fn(params, batch)
                grads = torch.autograd.grad(loss, leaves)
                nll = nll.detach()
            elif cfg.parallel.accum_via_scan_grad:
                # the reference differentiates the scan over microbatches:
                # one gradient of sum(loss_i / M).  Here one backward a
                # microbatch on loss_i / M accumulates into the same .grad,
                # which is that gradient's math; .grad adds in the param
                # dtype where the reference's scan transpose keeps its own
                # accumulator, so the roundings differ (float32: within
                # rtol 1e-4 of the reference, tests/test_torch_train.py)
                for p in leaves:
                    p.grad = None
                nlls = []
                for one in _micro_split(batch, M):
                    loss, one_nll = loss_fn(params, one)
                    (loss / M).backward()
                    nlls.append(one_nll.detach())
                grads = [p.grad for p in leaves]
                for p in leaves:
                    p.grad = None
                nll = torch.stack(nlls).mean()
            else:
                acc = [torch.zeros(p.shape, dtype=accum_dtype,
                                   device=p.device) for p in leaves]
                nlls = []
                for one in _micro_split(batch, M):
                    loss, one_nll = loss_fn(params, one)
                    for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
                        a += g.to(accum_dtype)
                    nlls.append(one_nll.detach())
                grads = [a / M for a in acc]
                nll = torch.stack(nlls).mean()

        grads = tree_unflatten(params, grads)
        new_ef = None
        if cfg.parallel.grad_compression and "ef" in opt_state:
            pairs = tree_map(error_feedback_update, grads, opt_state["ef"])
            grads = tree_map(lambda p: p[0], pairs)
            new_ef = tree_map(lambda p: p[1], pairs)

        adam = opt_state["adam"]
        gnorm = optimizer.global_norm(grads)
        metrics = {"loss": nll, "grad_norm": gnorm,
                   "step": (adam["step"] + 1).to(torch.float32)}
        if accept is not None and not accept(metrics):
            return params, opt_state, metrics
        optimizer.update(grads, adam, params, gnorm=gnorm)
        if new_ef is not None:
            tree_map(lambda ef, new: ef.copy_(new), opt_state["ef"], new_ef)
        return params, opt_state, metrics

    return train_step


def init_opt_state(cfg: ArchConfig, optimizer: AdamW, params):
    state = {"adam": optimizer.init(params)}
    if cfg.parallel.grad_compression:
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state


def make_prefill_step(model: LM, cfg: ArchConfig, plan: MeshPlan = NULL_PLAN):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: LM, cfg: ArchConfig, plan: MeshPlan = NULL_PLAN):
    def decode_step(params, caches, batch, pos):
        return model.decode_step(params, caches, batch, pos)
    return decode_step
