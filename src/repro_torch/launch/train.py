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
``--device cpu``.  ``--mesh`` is refused: distribution is ROADMAP Queue 1
item 20.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
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
                    help="dp,tp (not ported: ROADMAP item 20)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: distribution is not ported (ROADMAP Queue 1 item 20); "
            "the port trains on one device")
    dev = resolve_device(args.device)

    cfg = cfg_override or (reduced_config(args.arch) if args.reduced
                           else get_config(args.arch))
    cfg = cfg.replace(grad_accum=args.grad_accum)
    if args.arch == "minicpm-2b":
        args.schedule = "wsd"        # MiniCPM trains with WSD (DESIGN.md)

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
            state, _ = ckpt.restore(host_state(cfg, params, opt), last,
                                    args.ckpt_dir)
            params = convert.lm_params_from_host(cfg, state["params"],
                                                 device=dev)
            opt = convert.opt_state_from_host(cfg, state["opt"], device=dev)
            start = last
            print(f"[train] resumed from step {start}")

    step_fn = make_train_step(cfg, oc)
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
