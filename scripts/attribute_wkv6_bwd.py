"""Where the chunk-parallel WKV6 backward's main pass spends its time, on
one CUDA card: builds copies of ``csrc/wkv6_bwd.cu`` with some of
``wkv6_bwd_main``'s tensor-core products removed (into ``build/``, never
into the source tree) and times the main pass alone of each, in turns, at
the RWKV6-7B train and prefill shapes (chunk 256).

    python3 scripts/attribute_wkv6_bwd.py

What a variant saves against the full pass is the time of the products it
removes that nothing else hides; the variant without any product leaves
the loads, the scans, the synchronisations and the elementwise step.  The
variants compute wrong gradients and serve only for this timing.
"""
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wk  # noqa: E402

# the main pass's product calls, by phase (dQ; dv and dKf; dR, dK2, K2 dS')
PRODUCTS = {
    "P2": ["chain<kLower, 2>(DY, VI, KF, acc, t0w, kq);",
           "chain<kFull, 2>(DY, Y(s & 1), X(s & 1), acc, t0w, kq);"],
    "P3": ["if (dv_warp) chain<kUpper, 4>(KF, QI, DY, acc, t0w, jh);\n"
           "  else chain<kUpper, 4>(VI, DY, QI, acc, t0w, jh);",
           "if (dv_warp) chain<kFull, 4>(KF, Qj, DYj, acc, t0w, jh);\n"
           "    else chain<kFull, 4>(VI, DYj, Qj, acc, t0w, jh);"],
    "P1": ["prod_ab(QI, DSS, acc, t0w);",
           "prod_abt<kFull, 4>(A, B, a, t0w, 32 * half);"],
}
VARIANTS = {"full": (), "no P2": ("P2",), "no P3": ("P3",),
            "no P1": ("P1",), "no products": ("P2", "P3", "P1")}


def variant_lib(name, drop):
    src = (_build.CSRC / "wkv6_bwd.cu").read_text()
    for phase in drop:
        for call in PRODUCTS[phase]:
            if src.count(call) != 1:
                raise RuntimeError(f"{call!r} not found once in wkv6_bwd.cu")
            src = src.replace(call, ";")
    where = _build.BUILD_DIR.parent / "attrib" / name.replace(" ", "_")
    where.mkdir(parents=True, exist_ok=True)
    (where / "wkv6_bwd.cu").write_text(src)
    shutil.copy(_build.CSRC / "wkv6.cuh", where / "wkv6.cuh")
    csrc, _build.CSRC = _build.CSRC, where
    try:
        _build._libs.pop("wkv6_bwd", None)
        return _build.load("wkv6_bwd", wk._BWD_SIGNATURES)
    finally:
        _build.CSRC = csrc
        _build._libs.pop("wkv6_bwd", None)


def main() -> int:
    if not torch.cuda.is_available():
        print("attribute_wkv6_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _build.build(["wkv6"])
    libs = {name: variant_lib(name, drop) for name, drop in VARIANTS.items()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for B in (2, 4):
        r, k, v, w, u, S0 = cs.wkv_inputs(gen, B, 1024, 64, 64, -0.6, True)
        dy, dS = torch.randn_like(v), torch.randn_like(S0)
        for turn in range(2):
            for name, lib in libs.items():
                _build._libs["wkv6_bwd"] = lib
                main_pass = wk.bwd_pass_launchers(
                    r, k, v, w, u, dy, dS, chunk=256, S0=S0)["main"]
                print(f"B={B} T=1024 H=64 K=64 chunk 256, turn {turn}, "
                      f"{name}: main ms={cs.cuda_ms(main_pass, 20)!r}",
                      flush=True)
    _build._libs.pop("wkv6_bwd", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
