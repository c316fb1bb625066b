"""Time ``chip_smoke.py`` phase 11 (e)'s train step through the kernels on
two checkouts of the repository, in turns (A, B, B, A), each run in its own
process on its own checkout, on one CUDA card.

    python3 scripts/ab_train_step.py A_DIR B_DIR [--arch qwen3-0.6b]

Each run builds its checkout's kernels, then takes phase 11 (e)'s steps of
the architecture (``chip_smoke.KERNEL_TRAIN``: its layers, batch and length)
and prints one ``RESULT`` line of JSON: the checkout, the step's median ms,
tokens/s, peak GB, launches and idle shares, beside the profiled step's
device busy seconds and its kernels' lines.  Two versions compare only
within one such call.
"""
import argparse
import json
import subprocess
import sys

RUN = r'''
import json, sys
tree, arch = sys.argv[1], sys.argv[2]
sys.path[:0] = [tree + "/src", tree]
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from repro_torch.kernels import _build
names = {"qwen3-0.6b": ("flash_attention", "flash_attention_bwd"),
         "rwkv6-7b": ("wkv6", "wkv6_bwd")}[arch]
_build.build(list(names))
if arch == "rwkv6-7b":
    from repro_torch.kernels.rwkv6 import kernel as k
else:
    from repro_torch.kernels.flash_attention import kernel as k
kernels = tuple(getattr(k, n) for n in names)
for fn in kernels:
    fn.launches = 0
_, layers, B, T = next(c for c in cs.KERNEL_TRAIN if c[0] == arch)
res = cs.kernel_train(arch, layers, B, T, kernels)
print("RESULT " + json.dumps(dict(tree=tree, **{
    key: res[key] for key in ("step_ms", "tok_s", "peak_gb", "idle",
                              "idle_warm", "launches")})))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=("qwen3-0.6b", "rwkv6-7b"))
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    print(card.stdout.strip())
    failed = 0
    for tree in (args.a, args.b, args.b, args.a):
        out = subprocess.run([sys.executable, "-c", RUN, tree, args.arch],
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("RESULT") or "device_busy_s" in ln
                 or ln.startswith("  kernel ")]
        print(*lines, sep="\n", flush=True)
        if out.returncode:
            failed += 1
            print(f"{tree}: exit {out.returncode}\n{out.stderr[-2000:]}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
