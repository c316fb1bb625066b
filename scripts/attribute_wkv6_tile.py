"""Where the tile-parallel WKV6 forward's output pass spends its time, on
one CUDA card: builds copies of ``csrc/wkv6.cu`` with parts of
``wkv6_tile_output`` removed (into ``build/``, never into the source tree)
and times the output pass alone of each, in turns, at RWKV6-7B's prompts
of 1,023, 1,000, 1,040 and 992 tokens (chunks 1, 8, 16 and 32; B 4, 64
heads of 64).

    python3 scripts/attribute_wkv6_tile.py

What a variant saves against the full pass is the time of the part it
removes that nothing else hides; the variant without both leaves the
loads, the scan, the exponentials, the synchronisations and the stores.
The variants compute wrong outputs and serve only for this timing.
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

# the output pass's parts: the chunks' own products (tensor cores) and the
# state walk (CUDA cores)
PARTS = {"attend": "if (L > 1) attend<kPow2>(Qs, Ks, Vs, acc, true, L);",
         "walk": "walk_tile<kPow2>(Rs, K2, Vs, Ws, diag, Qs, st, rows, L);"}
VARIANTS = {"full": (), "no attend": ("attend",), "no walk": ("walk",),
            "neither": ("attend", "walk")}
SHAPES = ((1023, 1), (1000, 8), (1040, 16), (992, 32))


def variant_lib(name, drop):
    src = (_build.CSRC / "wkv6.cu").read_text()
    for part in drop:
        if src.count(PARTS[part]) != 1:
            raise RuntimeError(f"{PARTS[part]!r} not found once in wkv6.cu")
        src = src.replace(PARTS[part], ";")
    where = _build.BUILD_DIR.parent / "attrib_tile" / name.replace(" ", "_")
    where.mkdir(parents=True, exist_ok=True)
    (where / "wkv6.cu").write_text(src)
    shutil.copy(_build.CSRC / "wkv6.cuh", where / "wkv6.cuh")
    csrc, _build.CSRC = _build.CSRC, where
    try:
        _build._libs.pop("wkv6", None)
        return _build.load("wkv6", wk._SIGNATURES)
    finally:
        _build.CSRC = csrc
        _build._libs.pop("wkv6", None)


def main() -> int:
    if not torch.cuda.is_available():
        print("attribute_wkv6_tile: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = {name: variant_lib(name, drop) for name, drop in VARIANTS.items()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for T, L in SHAPES:
        r, k, v, w, u, _ = cs.wkv_inputs(gen, 4, T, 64, 64, -0.6, False)
        for turn in range(2):
            for name, lib in libs.items():
                _build._libs["wkv6"] = lib
                passes = wk.pass_launchers(r, k, v, w, u, chunk=L)
                print(f"B=4 T={T} H=64 K=64 chunk {L}, turn {turn}, {name}: "
                      f"output ms={cs.cuda_ms(passes['output'], 20)!r}"
                      + (f" state ms={cs.cuda_ms(passes['state'], 20)!r} "
                         f"prefix ms={cs.cuda_ms(passes['prefix'], 20)!r}"
                         if name == "full" else ""), flush=True)
    _build._libs.pop("wkv6", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
