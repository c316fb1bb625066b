"""Step functions and their sharding specs for every cell kind
(counterpart of ``repro.launch.steps``).

A train step is ``cfg.grad_accum`` microbatches of fwd + bwd, their
gradients summed in f32 and averaged, then one AdamW update.  Steps are
functional, as in JAX: a grad step never changes the caller's parameters
(gradients are taken with respect to detached aliases of them), and the
update returns new parameter and state trees.  Everything runs on the
device the tensors lie on.  On the card, a step runs through both
directions of the prefill kernels (flash attention; ``wkv6`` where ``T >
chunk``): their wrappers are autograd Functions whose backward passes are
CUDA kernels.

Every step builder takes a ``Distribution`` as the reference's do.  The
specs (``batch_specs``, ``cache_specs``, ``opt_specs``,
``param_shardings``, ``sanitize``) are the reference's rules on the port's
layouts (``repro_torch.models.sharding``).  The ``jit_*`` steps keep their
names so a reader finds the counterparts, and are eager: each sanitises
its sharding trees and returns a step that places each input on its
sharding's device, then runs the ``make_*`` step.  ``jax.jit``'s compile
and its buffer donation have no counterpart (a step returns new trees).
The dry run's two cost units, ``jit_grad_step_micro`` and
``jit_opt_step``, return the step and its inputs as meta tensors where
JAX returns a ``Lowered``.
"""
from __future__ import annotations

import torch

from repro_torch.models import decode_step, loss_fn, param_specs, prefill
from repro_torch.models.sharding import (P, Distribution, NamedSharding,
                                         map_with_path)
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.utils import tree_leaves, tree_map

F32 = torch.float32


# --------------------------------------------------------------------------
# sharding specs
# --------------------------------------------------------------------------

def _ns(dist, spec):
    return NamedSharding(dist.mesh, spec)


def _axis_size(mesh, entry):
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _zip_map(fn, shardings, tree):
    """``fn(sharding, leaf)`` over two trees of one structure."""
    if isinstance(shardings, dict):
        return {k: _zip_map(fn, v, tree[k]) for k, v in shardings.items()}
    if isinstance(shardings, (list, tuple)):
        return type(shardings)(_zip_map(fn, a, b)
                               for a, b in zip(shardings, tree))
    return fn(shardings, tree)


def sanitize(shardings, tree, mesh):
    """Drop spec axes that do not divide the corresponding dim (e.g. odd
    vocab 122753 on 16-way TP, int8 optimizer scale tails): the reference's
    ``jit`` in_shardings require exact divisibility, and the dropped dims
    are replicated.  ``tree`` gives only shapes (tensors, meta ones too)."""
    def one(sh, x):
        spec = tuple(sh.spec)
        spec = spec + (None,) * (x.ndim - len(spec))
        new = tuple(e if x.shape[i] % _axis_size(mesh, e) == 0 else None
                    for i, e in enumerate(spec))
        return NamedSharding(mesh, P(*new))
    return _zip_map(one, shardings, tree)


def _div(n, dist):
    ts = dist.tp_size()
    return dist.tp if (ts > 1 and n % ts == 0) else None


def batch_specs(cfg, batch_tree, dist: Distribution):
    dp = dist.dp_axes

    def one(path, x):
        name = path.split("/")[-1]
        if name == "mrope_positions":
            return _ns(dist, P(None, dp, None))
        if x.ndim >= 3:                      # embeds / enc_embeds
            return _ns(dist, P(dp, None, None))
        return _ns(dist, P(dp, None))        # tokens / targets
    return map_with_path(one, batch_tree)


def cache_specs(cfg, cache_tree, dist: Distribution):
    """KV caches: batch on dp + kv-heads on tp (when divisible); with
    cfg.kv_cache_seq_shard the sequence dim is sharded over the whole mesh
    instead (context-parallel decode).  The port's per-layer cache
    (``layers/<i>/...``) gets the reference's specs without the leading
    None of its stacked ``blocks``."""
    dp = dist.dp_axes

    def one(path, x):
        keys = path.split("/")
        leaf, parent = keys[-1], keys[-2] if len(keys) > 1 else ""
        stacked = keys[0] == "blocks"
        lead = (None,) if stacked else ()
        if parent in ("attn", "cross") or leaf in ("ck", "cv"):
            # (B, S, kv, hd)
            if cfg.kv_cache_seq_shard:
                all_axes = tuple(dp) + ((dist.tp,) if dist.tp else ())
                return _ns(dist, P(*lead, None, all_axes, None, None))
            kv_ax = _div(cfg.n_kv, dist)
            if kv_ax is None and dist.tp is not None:
                # kv heads don't divide TP: shard the sequence over 'model'
                # instead of replicating the cache (context-parallel decode)
                return _ns(dist, P(*lead, dp, dist.tp, None, None))
            return _ns(dist, P(*lead, dp, None, kv_ax, None))
        if leaf == "S":                        # rwkv state (B,H,k,v)
            H = cfg.d_model // cfg.rwkv_head_dim
            return _ns(dist, P(*lead, dp, _div(H, dist), None, None))
        if leaf == "h" and parent == "mamba":  # (B, d_in, N)
            return _ns(dist, P(*lead, dp, _div(cfg.mamba.expand *
                                               cfg.d_model, dist), None))
        if leaf == "conv":                     # (B, dc-1, d_in)
            return _ns(dist, P(*lead, dp, None,
                               _div(cfg.mamba.expand * cfg.d_model, dist)))
        if leaf in ("shift", "cshift"):        # (B, d)
            return _ns(dist, P(*lead, dp, None))
        return _ns(dist, P(*([None] * x.ndim)))
    return map_with_path(one, cache_tree)


def opt_specs(pspecs, oc: OptConfig, dist: Distribution):
    def one(_, s):
        if oc.state_dtype == "f32":
            return {"m": s, "v": s, "master": s}
        if oc.state_dtype == "bf16":
            return {"m": s, "v": s}
        return {"m": {"q": s, "scale": s}, "v": {"q": s, "scale": s}}
    return {"mu": map_with_path(one, pspecs), "step": P()}


def param_shardings(cfg, params_tree, dist: Distribution):
    specs = param_specs(cfg, params_tree, dist)
    return map_with_path(lambda _, s: _ns(dist, s), specs)


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------


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


def make_grad_step(cfg, dist: Distribution, *, loops: str = "scan"):
    """fwd + bwd of one microbatch: ``step(params, mb) -> (grads, loss,
    metrics)``, the gradients in the parameters' structure and dtypes (an
    unused parameter gets zeros, as ``jax.grad`` gives it)."""
    def step(params, mb):
        leaves = tree_leaves(params)
        aliases = iter([x.detach().requires_grad_(True) for x in leaves])
        p = tree_map(lambda _: next(aliases), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, p, mb, dist, loops=loops)
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


def make_train_step(cfg, dist: Distribution, oc: OptConfig, *,
                    loops: str = "scan"):
    """One optimizer step: ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.

    With ``cfg.grad_accum = M > 1`` the batch is split into M microbatches
    (``_stack_micro``) run in a loop, one microbatch's activations alive at
    a time; their gradients are summed in f32, in order and in place in
    the step's own accumulator, and divided by M, and the loss is their
    mean.  With M = 1 the gradients are cast to f32.  Then AdamW."""
    M = max(1, cfg.grad_accum)
    gstep = make_grad_step(cfg, dist, loops=loops)
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
            # not alive beside the next microbatch's, nor the update (the
            # loop variables would keep the last leaves)
            del g, gi, acc

        # a true division: torch's CUDA division by a Python number
        # multiplies by its reciprocal
        m = torch.full((), M, dtype=F32, device=loss_sum.device)
        grads = tree_map(lambda g: g / m, grads)
        params2, opt2, om = ostep(params, opt_state, grads)
        return params2, opt2, {"loss": loss_sum / m, **om}
    return step


def make_prefill_step(cfg, dist: Distribution, *, loops: str = "scan"):
    def step(params, batch):
        return prefill(cfg, params, batch, dist, loops=loops)
    return step


def make_decode_step(cfg, dist: Distribution):
    def step(params, cache, token, pos):
        return decode_step(cfg, params, cache, token, pos, dist)
    return step


def jit_train_step(cfg, dist, oc, params_tree, opt_tree, batch_tree, *,
                   loops="scan", donate=True):
    """The train step under ``dist``'s mesh: the three sharding trees
    sanitised against ``params_tree``, ``opt_tree`` and ``batch_tree``
    (tensors of the inputs' shapes, meta ones too), and a step that moves
    each input to its sharding's device (a no-op where it lies there) and
    runs ``make_train_step``.  ``donate`` is accepted for the reference's
    signature only and changes nothing: the step never writes its
    inputs."""
    return _placed(make_train_step(cfg, dist, oc, loops=loops),
                   _param_shardings(cfg, dist, params_tree),
                   _opt_shardings(cfg, dist, oc, params_tree, opt_tree),
                   _batch_shardings(cfg, dist, batch_tree))


def _param_shardings(cfg, dist, params_tree):
    return sanitize(param_shardings(cfg, params_tree, dist), params_tree,
                    dist.mesh)


def _batch_shardings(cfg, dist, batch_tree):
    return sanitize(batch_specs(cfg, batch_tree, dist), batch_tree,
                    dist.mesh)


def _opt_shardings(cfg, dist, oc, params_tree, opt_tree):
    osh = map_with_path(lambda _, s: _ns(dist, s),
                        opt_specs(param_specs(cfg, params_tree, dist), oc,
                                  dist))
    return sanitize(osh, opt_tree, dist.mesh)


def _placed(fn, *shardings):
    """``fn`` with each argument's tensors moved to its sharding tree's
    devices (a no-op where a tensor lies there)."""
    def place(sh_tree, tree):
        return _zip_map(lambda sh, x: x.to(sh.device)
                        if isinstance(x, torch.Tensor) else x, sh_tree, tree)

    def step(*args):
        return fn(*(place(sh, a) for sh, a in zip(shardings, args)))
    return step


def _micro_batch_sds(batch_tree, M):
    """One microbatch's inputs as meta tensors: every leaf's batch axis
    divided by ``M`` (axis 1 of ``mrope_positions``, axis 0 of the rest)."""
    def one(path, x):
        ax = 1 if path.split("/")[-1] == "mrope_positions" else 0
        shp = list(x.shape)
        shp[ax] //= M
        return torch.empty(shp, dtype=x.dtype, device="meta")
    return map_with_path(one, batch_tree)


def jit_grad_step_micro(cfg, dist, params_tree, batch_tree, M, *,
                        loops="unroll"):
    """fwd + bwd of ONE microbatch, the dry run's train cost unit:
    ``(step, (params_tree, microbatch))``, the microbatch as meta tensors
    (:func:`_micro_batch_sds`)."""
    mb = _micro_batch_sds(batch_tree, M)
    step = _placed(make_grad_step(cfg, dist, loops=loops),
                   _param_shardings(cfg, dist, params_tree),
                   _batch_shardings(cfg, dist, mb))
    return step, (params_tree, mb)


def jit_opt_step(cfg, dist, oc, params_tree, opt_tree):
    """The AdamW update alone: ``(step, (params_tree, opt_tree, grads))``,
    the f32 gradients as meta tensors of the parameters' shapes."""
    g32 = tree_map(lambda x: torch.empty(x.shape, dtype=F32, device="meta"),
                   params_tree)
    step = _placed(make_opt_step(cfg, oc),
                   _param_shardings(cfg, dist, params_tree),
                   _opt_shardings(cfg, dist, oc, params_tree, opt_tree),
                   _param_shardings(cfg, dist, g32))
    return step, (params_tree, opt_tree, g32)


def jit_prefill_step(cfg, dist, params_tree, batch_tree, *, loops="scan"):
    return _placed(make_prefill_step(cfg, dist, loops=loops),
                   _param_shardings(cfg, dist, params_tree),
                   _batch_shardings(cfg, dist, batch_tree))


def jit_decode_step(cfg, dist, params_tree, cache_tree, *, donate=True):
    """The decode step under ``dist``'s mesh; the token is sharded over the
    data axes when the batch divides them, else replicated.  ``donate`` is
    accepted for the reference's signature: the step writes the cache in
    place (``transformer._attn_mixer``).  A meta ``pos`` has no value; the
    step costs the same at every slot (the cache is read whole, under a
    mask), so it then runs at slot 0."""
    B = tree_leaves(cache_tree)[0].shape[0]
    dp = dist.dp_axes
    tsh = _ns(dist, P(dp) if B % _axis_size(dist.mesh, dp) == 0 else P(None))
    fn = _placed(make_decode_step(cfg, dist),
                 _param_shardings(cfg, dist, params_tree),
                 sanitize(cache_specs(cfg, cache_tree, dist), cache_tree,
                          dist.mesh), tsh, _ns(dist, P()))

    def step(params, cache, token, pos):
        if isinstance(pos, torch.Tensor) and pos.is_meta:
            pos = 0
        return fn(params, cache, token, pos)
    return step
