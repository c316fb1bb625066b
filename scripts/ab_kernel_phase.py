"""Run kernel phases of ``chip_smoke.py`` on two checkouts of the
repository, in turns (A, B, B, A), each run in its own process on its own
checkout, on one CUDA card.

    python3 scripts/ab_kernel_phase.py A_DIR B_DIR [--phase 1c 11b-wkv6]

Each run deletes its checkout's built libraries of the phases' sources,
builds them anew and prints each entry function's ``ptxas`` line (registers
and spills), then runs the phases with the seeds ``chip_smoke.py`` gives
them and prints their output.  Two versions compare only within one such
call.
"""
import argparse
import json
import subprocess
import sys

# phase -> (chip_smoke function, its generator's seed past SEED, sources)
PHASES = {"1b": ("phase_flash", 0, ["flash_attention"]),
          "1c": ("phase_wkv", 0, ["wkv6"]),
          "11b-flash": ("flash_bwd_check", 15,
                        ["flash_attention", "flash_attention_bwd"]),
          "11b-wkv6": ("wkv_bwd_check", 15, ["wkv6", "wkv6_bwd"])}

RUN = r'''
import json, sys
tree, phases = sys.argv[1], json.loads(sys.argv[2])
sys.path[:0] = [tree + "/src", tree]
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from repro_torch.kernels import _build
names = sorted({n for _, _, srcs in phases for n in srcs})
for n in names:
    for lib in _build.BUILD_DIR.glob(f"lib{n}-*.so"):
        lib.unlink()
logs = _build.build(names)
for n in names:
    for entry, usage in cs.ptxas_usage(logs.get(n, ""), "").items():
        print(f"ptxas {n} {entry}: {usage}")
for fn, seed, _ in phases:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + seed)
    getattr(cs, fn)(gen)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--phase", nargs="+", default=["1c"],
                    choices=sorted(PHASES))
    args = ap.parse_args()
    phases = json.dumps([PHASES[p] for p in args.phase])
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    print(card.stdout.strip())
    failed = 0
    for tree in (args.a, args.b, args.b, args.a):
        out = subprocess.run([sys.executable, "-c", RUN, tree, phases],
                             capture_output=True, text=True)
        print(f"== {tree}: exit {out.returncode}", flush=True)
        print(out.stdout, flush=True)
        if out.returncode:
            failed += 1
            print(out.stderr[-2000:])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
