"""Per-block costs of each cell's layer stack (counterpart of
``repro.launch.bodies``).

XLA's cost analysis counts a while-loop body once, so JAX's dry run lowers
each layer-stack scan body alone and adds ``(trips - 1) x body`` to the
step's cost.  The port's step runs eagerly, one pass of every block, and
its count (``analysis.StepCounter``) already covers every trip: the dry run
records each body's cost beside the step's and adds no correction, and
``trips x body`` is the step's share in its blocks.  One block group is
costed on meta tensors with the inputs the model gives it: its cache slice
in decode, the M-RoPE positions or the encoded frames where the cell has
them, and, for train, a backward through ``_remat_wrap`` from the block's
cotangents (the decoder's into the encoded frames too).

JAX's cost-only override of the attention chunks above S = 8192 (larger
chunks: the same FLOPs, fewer unrolled blocks to compile) is not
applicable: on the card's route, attention is the flash kernel's one
operator whatever the chunk, and the port compiles nothing.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.launch.analysis import analyze_step
from repro_torch.models import transformer as T
from repro_torch.models.sharding import Distribution
from repro_torch.utils import tree_leaves, tree_map


def _grad_of(block, bp, h, enc, dy, daux):
    """``block``'s output and its gradients with respect to the block's
    parameters, its input and the encoded frames ``enc`` (None but in a
    decoder block), on detached aliases as ``steps.make_grad_step`` takes
    them, from the cotangents ``dy`` of the output and ``daux`` of the MoE
    layers' load-balance loss (where the block has one)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(bp)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), bp)
    inputs = [t.detach().requires_grad_(True) for t in (h, enc)
              if t is not None]
    with torch.enable_grad():
        y, aux = block(p, *inputs)
        outs, cots = ([y, aux], [dy, daux]) if aux.requires_grad else (y, dy)
        grads = torch.autograd.grad(outs, leaves + inputs, cots,
                                    allow_unused=True, materialize_grads=True)
    return y.detach(), grads


def scan_bodies(cfg, dist: Distribution, shape, params,
                cache=None) -> List[Dict[str, Any]]:
    """Returns [{name, trips, cost() -> analysis.CostSummary}] per layer
    group: ``params`` and ``cache`` are the step's (meta) trees, and the
    group's first block is costed."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train" and cfg.grad_accum > 1:
        B = B // cfg.grad_accum          # bodies run at microbatch size
    decode = shape.kind == "decode"
    dev = tree_leaves(params)[0].device
    adt = cfg.adtype
    h = torch.empty((B, 1 if decode else S, cfg.d_model), dtype=adt,
                    device=dev)
    mrope = (torch.empty((3, B, S), dtype=torch.int32, device=dev)
             if cfg.mrope_sections and not decode else None)
    # made once, outside the counted step, as the model makes them once
    ctx = {"dist": dist, "loops": "unroll", "collect": shape.kind != "train",
           "mrope_positions": mrope,
           "positions": (torch.zeros((1, 1), dtype=torch.long, device=dev)
                         if decode else
                         torch.arange(S, device=dev)[None, :]),
           "cache_pos": 0 if decode else None}
    out = []

    def add_group(name, key, lo, kinds, trips, encoder=False, cross=False):
        bp = params[key][lo:lo + len(kinds)]
        gctx = {**ctx, "causal": not encoder}
        enc = (torch.empty((B, S, cfg.d_model), dtype=adt, device=dev)
               if cross else None)

        if decode:
            bc = cache["layers"][lo:lo + len(kinds)]

            def body(bp, bc, h):
                for p, kind, c in zip(bp, kinds, bc):
                    h = T._apply_layer(cfg, p, h, kind, gctx, cache=c)[0]
                return h
            args = (bp, bc, h)
        else:
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            if encoder:
                def fwd(bp, h):
                    return (T._apply_layer(cfg, bp[0], h, kinds[0], gctx)[0],
                            aux)
            else:
                def fwd(bp, h, enc=enc):
                    return T.run_layers(cfg, bp, kinds, h, aux, gctx,
                                        enc)[:2]
            block = T._remat_wrap(cfg, fwd)
            if shape.kind == "train":
                def body(bp, h, enc, dy, daux):
                    return _grad_of(block, bp, h, enc, dy, daux)
                args = (bp, h, enc, torch.empty_like(h),
                        torch.empty_like(aux))
            else:
                body, args = block, (bp, h)

        def cost(body=body, args=args):
            return analyze_step(body, *args)

        out.append({"name": name, "trips": trips, "cost": cost})

    kinds = cfg.layer_kinds()
    if cfg.is_encdec:
        if not decode:
            add_group("enc_block", "enc_layers", 0, [("attn", "dense")],
                      cfg.encoder_layers, encoder=True)
        add_group("dec_block", "layers", 0, [("attn", "dense")],
                  cfg.n_layers, cross=not decode)
    else:
        first = cfg.moe.first_k_dense if cfg.moe else 0
        bl = cfg.block_len
        add_group("block", "layers", first, kinds[first:first + bl],
                  (cfg.n_layers - first) // bl)
    return out
