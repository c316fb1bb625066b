"""Step builders of the training and serving paths (counterpart of the step
builders of ``repro.launch.steps``).

A train step is ``cfg.grad_accum`` microbatches of fwd + bwd, their
gradients summed in f32 and averaged, then one AdamW update.  Steps are
functional, as in JAX: a grad step never changes the caller's parameters
(gradients are taken with respect to detached aliases of them), and the
update returns new parameter and state trees.  Everything runs on the
device the tensors lie on.  On the card, a step runs through both
directions of the prefill kernels (flash attention; ``wkv6`` where ``T >
chunk``): their wrappers are autograd Functions whose backward passes are
CUDA kernels.

There is no ``Distribution`` argument and no sharding spec or ``jit_*``
function: PyTorch runs eagerly, and distribution is ROADMAP Queue 1 item
20.
"""
from __future__ import annotations

import torch

from repro_torch.models import decode_step, loss_fn, prefill
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.utils import tree_leaves, tree_map

F32 = torch.float32


def _stack_micro(batch, n):
    """Reshape every batch leaf (B, ...) -> (n, B/n, ...) for the
    microbatch loop; ``mrope_positions`` (3, B, S) carries the batch on
    axis 1 and becomes (n, 3, B/n, S)."""
    def one(name, x):
        if name == "mrope_positions":
            r = x.reshape(x.shape[0], n, x.shape[1] // n, *x.shape[2:])
            return torch.movedim(r, 1, 0)
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])
    return {name: one(name, x) for name, x in batch.items()}


def make_grad_step(cfg, *, loops: str = "scan"):
    """fwd + bwd of one microbatch: ``step(params, mb) -> (grads, loss,
    metrics)``, the gradients in the parameters' structure and dtypes (an
    unused parameter gets zeros, as ``jax.grad`` gives it)."""
    def step(params, mb):
        leaves = tree_leaves(params)
        aliases = iter([x.detach().requires_grad_(True) for x in leaves])
        p = tree_map(lambda _: next(aliases), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, p, mb, loops=loops)
            grads = torch.autograd.grad(loss, tree_leaves(p),
                                        allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        return (tree_map(lambda _: next(it), params), loss.detach(),
                {k: v.detach() for k, v in metrics.items()})
    return step


def make_opt_step(cfg, oc: OptConfig):
    def step(params, opt_state, grads):
        return adamw_update(params, grads, opt_state, oc)
    return step


def make_train_step(cfg, oc: OptConfig, *, loops: str = "scan"):
    """One optimizer step: ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.

    With ``cfg.grad_accum = M > 1`` the batch is split into M microbatches
    (``_stack_micro``) run in a loop, one microbatch's activations alive at
    a time; their gradients are summed in f32, in order and in place in
    the step's own accumulator, and divided by M, and the loss is their
    mean.  With M = 1 the gradients are cast to f32.  Then AdamW."""
    M = max(1, cfg.grad_accum)
    gstep = make_grad_step(cfg, loops=loops)
    ostep = make_opt_step(cfg, oc)

    def step(params, opt_state, batch):
        if M == 1:
            g, loss, metrics = gstep(params, batch)
            g32 = tree_map(lambda x: x.to(F32), g)
            params2, opt2, om = ostep(params, opt_state, g32)
            return params2, opt2, {"loss": loss, **metrics, **om}

        stacked = _stack_micro(batch, M)
        grads = tree_map(lambda x: torch.zeros(x.shape, dtype=F32,
                                               device=x.device), params)
        loss_sum = torch.zeros((), dtype=F32,
                               device=tree_leaves(params)[0].device)
        for i in range(M):
            g, loss, _ = gstep(params, {k: v[i] for k, v in stacked.items()})
            for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                acc.add_(gi.to(F32))
            loss_sum = loss_sum + loss
            del g           # not alive beside the next microbatch's

        # a true division: torch's CUDA division by a Python number
        # multiplies by its reciprocal
        m = torch.full((), M, dtype=F32, device=loss_sum.device)
        grads = tree_map(lambda g: g / m, grads)
        params2, opt2, om = ostep(params, opt_state, grads)
        return params2, opt2, {"loss": loss_sum / m, **om}
    return step


def make_prefill_step(cfg, *, loops: str = "scan"):
    def step(params, batch):
        return prefill(cfg, params, batch, loops=loops)
    return step


def make_decode_step(cfg):
    def step(params, cache, token, pos):
        return decode_step(cfg, params, cache, token, pos)
    return step
