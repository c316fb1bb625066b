"""Where flash attention's backward spends its time, kernel by kernel, on
one CUDA card.

    python3 scripts/profile_flash_bwd.py

At each shape of ``SHAPES`` this runs ``flash_attention_bwd`` under
``torch.profiler`` and reads, from the profiler's trace, each of the
route's two kernels (dQ, then dK / dV): its device ms a call (the mean of
``REPS`` calls) and the grid and block it launched, beside the card's SM
count.  The card's name and power limit come first.  It exits non-zero
where the profiler recorded none of the kernels at a shape.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

REPS = 5
# (B, S, Hq, Hkv, hd), dtype, causal: phase 11 (b)'s head-width-32 cases
# and the Qwen3-0.6B shape in both dtypes
SHAPES = (((1, 1000, 4, 2, 32), torch.bfloat16, True),
          ((1, 1000, 4, 2, 32), torch.bfloat16, False),
          ((1, 1000, 4, 2, 32), torch.float32, True),
          ((4, 1024, 16, 8, 32), torch.bfloat16, True),
          ((4, 1024, 16, 8, 32), torch.float32, True),
          ((4, 1024, 16, 8, 128), torch.bfloat16, True),
          ((4, 1024, 16, 8, 128), torch.float32, True))
TRACE = ROOT / "build" / "profile_flash_bwd" / "trace.json"


def kernel_spans(call):
    """{kernel name: (device ms a call, grid, block)} of the flash backward
    kernels that ``call`` launches, from the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    events = json.loads(TRACE.read_text())["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") != "kernel" or "flash_bwd" not in e.get("name", ""):
            continue
        name = e["name"].split("<")[0].split("::")[-1].split("(")[0]
        args = e.get("args", {})
        ms, _, _ = out.get(name, (0.0, None, None))
        out[name] = (ms + e["dur"] / 1e3 / REPS, args.get("grid"),
                     args.get("block"))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_flash_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"SMs: {sms}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for shape, dtype, causal in SHAPES:
        B, S, Hq, Hkv, hd = shape
        q, k, v = cs.flash_inputs(gen, *shape, dtype)
        do = torch.randn((B, S, Hq, hd), generator=gen,
                         device="cuda").to(dtype)
        lse = torch.empty((B, Hq, S), device="cuda")
        o = fk._forward(q, k, v, causal, lse)
        spans = kernel_spans(lambda: fk.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal))
        label = (f"{shape} {str(dtype)[6:]} causal={causal} "
                 f"route={fk.route(q)}")
        if not spans:
            print(f"{label}: the profiler recorded no backward kernel",
                  file=sys.stderr)
            return 1
        for name, (ms, grid, block) in spans.items():
            print(f"{label} {name}: ms={ms!r} grid={grid} block={block}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
