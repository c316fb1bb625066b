"""Serving driver: batched prefill + decode with throughput reporting.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --batch 4 --prompt-len 1024 --new-tokens 16

Counterpart of ``repro.launch.serve``.  Random weights from ``--seed`` (no
weights are downloaded); it runs on the card unless ``--device cpu``.  For
the encoder-decoder (whisper-base) the encoder's input is ``--batch`` x
``--prompt-len`` standard-normal frame embeddings from the same generator.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import init_params
from repro_torch.serving import generate
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    kw = {}
    if cfg.is_encdec:
        kw["enc_embeds"] = torch.randn(
            (args.batch, args.prompt_len, cfg.d_model), generator=gen,
            device=dev)
    stats = {}
    out = generate(cfg, params, prompt, max_new_tokens=args.new_tokens,
                   temperature=args.temperature, generator=gen, stats=stats,
                   **kw)
    n_dec = args.batch * (args.new_tokens - 1)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[serve] {args.arch} on {where}: prefill of {args.batch} x "
          f"{args.prompt_len} tokens in {stats['prefill_s']:.4f} s; "
          f"{n_dec} decode tokens in {stats['decode_s']:.4f} s "
          f"({n_dec / max(stats['decode_s'], 1e-12):.1f} tok/s, "
          "first call: kernel builds included)")
    print("[serve] sample:", out[0, :12].tolist())
    return out


if __name__ == "__main__":
    main()
