"""Training launcher: data pipeline -> train step -> checkpoints (counterpart
of ``repro.launch.train``, with the same flags and defaults).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --steps 200 --global-batch 8 --seq 128 --ckpt-dir CKPT \
        --device cpu

Auto-resumes from the latest checkpoint in ``--ckpt-dir`` (fault
tolerance: kill it mid-run and relaunch).  Checkpoints hold ``{"params",
"opt"}`` in the JAX package's stacked layout and on-disk format, so a
directory written by either launcher resumes in the other.  Random weights
from ``--seed`` (none are downloaded); it runs on the card unless
``--device cpu``.

``--mesh dp,tp`` trains under ``dist_for(make_mesh((dp, tp), ("data",
"model")), fsdp=cfg.fsdp)`` through ``jit_train_step``; a resume restores
the parameters onto the mesh's shardings.  On the CPU the one CPU device
is repeated dp * tp times (the counterpart of the forced XLA host devices
the reference's ``--mesh`` runs on); on the card the mesh takes the first
dp * tp cards and raises where there are fewer (``make_mesh(...,
devices=[...])`` repeats a card from Python).  The port's mesh layout
(``repro_torch.models.sharding``) keeps every tensor whole on the mesh's
first device, so a dense model trains to the same bits on any mesh whose
tp does not exceed its kv heads (``models.sharding`` says what differs
elsewhere).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import dist_for, make_mesh
from repro_torch.launch.steps import (jit_train_step, make_train_step,
                                      param_shardings)
from repro_torch.models import LOCAL, init_params
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.utils import resolve_device


def host_state(cfg, params, opt) -> dict:
    """The checkpointed tree: parameters and AdamW state in JAX's layout,
    as CPU tensors."""
    return {"params": convert.lm_params_to_host(cfg, params),
            "opt": convert.opt_state_to_host(cfg, opt)}


def main(argv=None, cfg_override=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "const"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="dp,tp (the CPU repeated, or dp * tp cards)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = cfg_override or (reduced_config(args.arch) if args.reduced
                           else get_config(args.arch))
    cfg = cfg.replace(grad_accum=args.grad_accum)
    if args.arch == "minicpm-2b":
        args.schedule = "wsd"        # MiniCPM trains with WSD (DESIGN.md)

    if args.mesh:
        dp, tp = map(int, args.mesh.split(","))
        devices = [dev] * (dp * tp) if dev.type == "cpu" else None
        mesh = make_mesh((dp, tp), ("data", "model"), devices=devices)
        dist = dist_for(mesh, fsdp=cfg.fsdp)
        dev = mesh.devices.flat[0]
    else:
        dist = LOCAL

    oc = OptConfig(lr=args.lr, schedule=args.schedule,
                   total_steps=args.steps, warmup_steps=min(20, args.steps))
    params = init_params(cfg, args.seed, device=dev)
    opt = adamw_init(params, oc)
    data = SyntheticLM(cfg.vocab, args.seq, args.global_batch,
                       seed=args.seed)

    start = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            like = host_state(cfg, params, opt)
            shardings = (param_shardings(cfg, like["params"], dist)
                         if dist.mesh is not None else None)
            state, _ = ckpt.restore(like, last, args.ckpt_dir,
                                    shardings={"params": shardings,
                                               "opt": None} if shardings
                                    else None)
            params = convert.lm_params_from_host(cfg, state["params"],
                                                 device=dev)
            opt = convert.opt_state_from_host(cfg, state["opt"], device=dev)
            # restored onto a mesh, the stacked leaves lie on its device
            del like, state
            start = last
            print(f"[train] resumed from step {start}")

    if dist.mesh is not None:
        batch0 = {k: torch.from_numpy(v) for k, v in data(start).items()}
        step_fn = jit_train_step(cfg, dist, oc, params, opt, batch0)
    else:
        step_fn = make_train_step(cfg, LOCAL, oc)
    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data(step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            print(f"[train] step {step+1} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms/step")
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(host_state(cfg, params, opt), step + 1,
                            args.ckpt_dir)
    if args.ckpt_dir:
        ckpt.wait_pending()
        ckpt.save(host_state(cfg, params, opt), args.steps, args.ckpt_dir)
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
