#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, every source
at once), then runs these phases, each of which raises on failure:

1. every kernel against its plain PyTorch version on the card, at its main
   path's shapes and at ragged shapes (the RM sweep also in f32 and on an
   operand off a 16-byte boundary, each case with the access it took,
   and bit for bit against ``emulated_sweep`` at a few lanes; the fused
   middle bit for bit in f64 and f32, with every price distinct, at a
   tie, at a cold start, with signed-zero bids and past one staged chunk),
   with its time, the plain version's time, the card's least time for the
   same work (the fused middle's counting only the distinct prices and
   live classes these inputs need) and, where one PyTorch call computes
   the same function, that call's time; and ``layers.dot`` on bf16
   operands against the f32 product;
2. the allocator's main path at the paper's scale (Sec. 5.3: 256 lanes of
   100-500 job classes, capacity factor 0.95, f64): ``CapacityEngine.solve``
   under the fused-kernel, sweep-kernel and default configurations, plus
   the RM's (P5) solve of single instances through
   ``rm_solve(sweep_fn=...)``, with every kernel's launch count read
   around it;
3. the pinned loop (``eps_bar=0``, 48 steps, 64 lanes of 500 classes): the
   fused kernel path against the plain middle, bit for bit, then the fused
   solve's median wall, its device busy time and the idle gaps next to
   the fused kernel;
4. solve times and the device's idle share in one fused solve;
5. the tenant LM serving path (``repro_torch.serving.generate``, as
   ``python -m repro_torch.launch.serve`` drives it) for Qwen3-0.6B and
   RWKV6-7B at full width and depth, random weights from a seed: batch 4,
   prompt 1024, 16 new tokens, greedy.  Every kernel's launch count is
   read around each generate; tokens, logits and the last decode step
   against a forward pass over the prompt and the generated tokens are
   checked; prefill seconds, decode tokens/s and (Qwen3) the device's idle
   share are printed;
6. the admission window (``CapacityEngine.open_window`` /
   ``WindowSession.stream``) at the same scale, n_max 512: a trace of
   arrivals, departures, SLA edits and capacity changes, a burst that grows
   the window to 1,024 columns, flushes of 8 events under the fused and
   sweep configurations with the centralized cross-check on, and the fused
   session compacted after 8 flushes at the grown width.  Each flush must
   resolve exactly the lanes its events touched and pass the others
   through bit for bit, launch its kernel once per loop step, and, every
   8th flush, equal a cold solve of the same window (resolved lanes bit for
   bit), while the kernel is held to its plain version on that window
   (rows with holes, at the grown and the compacted width); the window
   must equal an event-by-event replay of the trace, and a lane's
   constants ``derive`` on the card.  Events per second, flush and
   cold re-solve walls, dirty lanes and launches per flush and one flush's
   device idle share are printed;
7. lane shards, resident sessions and the facades at phase 2's scale:
   (a) phase 2's fused and sweep solves over ``lane_mesh()`` (1 shard) and
   ``lane_mesh(devices=["cuda:0"] * 3)`` (258 padded lanes, 2 inert), and
   2 lanes over the 3 shards, each bit for bit phase 2's unsharded solve,
   with one launch a loop step a shard; (b) phase 6's fused session over
   its trace, resident on the 3 shards and then on 1, every report bit for
   bit the round-trip session's, the fused middle bit for bit its plain
   version on the padded resident batch every 8th flush and after the
   compaction, a lane pair that moves B across a multiple of 3, and
   ``release_resident`` leaving the round-trip window leaf by leaf; (c)
   ``allocator.solve_batch`` and ``solve_coalesced`` bit for bit their
   engine calls, warning; and a CPU mesh under card tensors refused.
   255 of phase 6's lanes at the odd width 501 on the 3 shards are bit
   for bit the unsharded solve too: on the card the loop widens the class
   axis to a multiple of 4 (``game._aligned_classes``), so torch's row
   sums add every row in the same order in any shard; there the fused
   solve is also bit for bit the unsharded plain middle's and the sweep
   solve within phase 2's gate of the default configuration's.  Resident
   flush walls, events per second and one flush's idle share are printed
   beside phase 6's;
8. the capacity planner (``repro_torch.core.solve_plan``) over
   ``benchmarks/plan_perf.py``'s full design space (1,024 candidates of 12
   classes) under the fused and sweep configurations: chunks of 64 and 48
   and one shot bit for bit, warm starts bit for bit the cold solve where
   both stop at the same iteration, the same frontier and cheapest design
   in both configurations, one launch a loop step a chunk; the same
   invariance at 101 classes (256 candidates) and at 257 classes in
   chunks of 37.  At each of the three widths the fused plan is bit for
   bit the plain middle's and the sweep plan within phase 2's gate of the
   default configuration's, and each kernel is held to its plain version
   on the operands of a ragged last chunk as the loop sees them (inert
   lanes, classes widened to a multiple of 4).  Candidates per second
   (cold and warm, grid excluded), one chunk's idle share, and
   ``repro_torch.launch.plan.main`` once;
9. the admission daemon (``repro_torch.serving.AllocDaemon``): 4 tenants
   of 64 lanes (100-500 classes, n_max 512), 96 events each, flushes of 8,
   fused, open loop at 400 events/s on a Poisson and a flash-crowd
   schedule, in process and over loopback TCP (``AllocServer`` and
   ``AllocClient``, tenants resident on a 1-device mesh): every tenant's
   flushes bit for bit an offline ``WindowSession`` replay, the wire's bit
   for bit the in-process ones, no rejection, one launch a loop step;
   events per second, admission latency, one flush's idle share, and
   ``repro_torch.launch.allocd.main --conformance`` once;
10. the ``kernels`` line, whose launch counts add phases 2 and 6-9.

The last line is ``{"ok": true, "device": {...}}``.  Without a card, or
without the repository's ``src/`` beside it, the script fails before
printing any result.
"""
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

# H100 SXM data sheet: HBM3 bandwidth, the FP64 and FP32 (non-tensor-core)
# rates and the dense TF32 and bf16 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
F64 = torch.float64

# main path: the paper's scalability sizes (benchmarks/paper_scalability.py)
MAIN_B, MAIN_N_LO, MAIN_N_MAX = 256, 100, 500
PIN_B, PIN_N, PIN_STEPS = 64, 500, 48
SMALL_NS = (37, 5, 29)  # ragged, N not a multiple of any tile, Nc = N + 2
# the fused middle past one staged chunk of classes (1,024) and one
# compacted segment of candidates (2,048): ragged, longest N = 2,100
CHUNK_NS = (2100, 1500, 900, 2100)
SEED = 0
ORDER_LANES = 8  # lanes of a sweep case held bit for bit to emulated_sweep
ALLOCATOR_KERNELS = ("fused_iter_sweep", "rm_sweep_batched", "rm_sweep")

# the serving path: both configurations at full width and depth
SERVE_ARCHS = ("qwen3-0.6b", "rwkv6-7b")
SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 1024, 16
# RWKV's decode-vs-forward check runs at a prompt of 1040 (chunk 16): at
# 1024 the model's chunk rule picks 256, where the reference's chunked form
# departs from the exact recurrence (ROADMAP Queue 3), so a prefill and a
# forward over a longer sequence compute different functions there
RWKV_AGREE_PROMPT = 1040
# flash attention: the Qwen3-0.6B prefill, then a ragged shape (bf16 runs
# the tensor-core kernel, f32 the CUDA-core one)
FLASH_MAIN = (4, 1024, 16, 8, 128)           # B, S, Hq, Hkv, hd
FLASH_RAGGED = (2, 200, 6, 3, 64)
# WKV6: (B, T, H, K, chunk, decay shift, with S0); the RWKV6-7B prefill,
# a 1040-token forward's chunk 16, and a ragged chunk-4 case whose
# cumulative decays pass the +-30 clamp (the per-head kernel); then the
# chunk-parallel kernels' prefix from a state, chunk 128, a single chunk and
# K = V = 32
WKV_CASES = ((4, 1024, 64, 64, 256, -0.6, False),
             (4, 1040, 64, 64, 16, -0.6, False),
             (2, 300, 4, 64, 4, 2.0, False),
             (2, 300, 4, 64, 4, 2.0, True),
             (4, 1024, 64, 64, 256, -0.6, True),
             (4, 1024, 64, 64, 128, -0.6, False),
             (2, 256, 4, 64, 256, -0.6, False),
             (2, 512, 4, 32, 64, -0.6, False))
# layers.dot on the card: bf16 (M x D) . (D x N), the Qwen3 MLP's up
# projection at the serving prefill (4 x 1024 tokens, d 1024, d_ff 3072)
DOT_SHAPE = (4096, 1024, 3072)
# the admission window: MAIN_B lanes at n_max 512 (grown to 1,024 by a
# burst), flushes of 8 events, a cold re-solve against every 8th flush, and
# the fused session compacted after 8 flushes at the grown width
WIN_N_MAX, WIN_EVENTS, WIN_FLUSH = 512, 256, 8
WIN_GATE_EVERY, WIN_COMPACT_AFTER = 8, 8
# phase 7's odd width: 255 lanes at n_max 501 put shards 1 and 2 of a 3-shard
# mesh off the 16-byte boundary
ODD_N_MAX = 501
# the capacity planner: benchmarks/plan_perf.py's full design space (12
# classes sized against a bursty trace; 8 cluster sizes x 4 tiers x 4
# penalty scales x 8 deadline scales = 1,024 candidates) in chunks of 64;
# the same axes at an odd class count (one penalty scale: 256 candidates,
# 101 classes) and past 128 classes at a chunk that shifts every chunk's
# rows by 8 bytes mod 32 (two tiers: 128 candidates, 257 classes, chunk 37)
PLAN_CLASSES, PLAN_PROFILE, PLAN_RATE, PLAN_EVENTS = 12, "bursty", 50.0, 1024
PLAN_CLUSTERS = tuple(float(r) for r in np.geomspace(1000.0, 128000.0,
                                                     8).round())
PLAN_TIERS = (("small", 1.0, 6.0), ("mid", 2.0, 10.0),
              ("large", 4.0, 16.0), ("xlarge", 8.0, 28.0))
PLAN_PENALTIES = (0.5, 1.0, 2.0, 4.0)
PLAN_DEADLINES = tuple(float(d) for d in np.linspace(0.7, 1.4, 8).round(2))
PLAN_CHUNK, PLAN_CHUNKS = 64, (48,)
PLAN_ODD = ((101, 4, (64, 48)), (257, 2, (37,)))   # classes, tiers, chunks
# the admission daemon: 4 tenants of 64 lanes (100-500 classes, n_max 512),
# 96 events each, flushes of 8, open loop at allocd_perf's 400 events/s
DAEMON_TENANTS, DAEMON_LANES, DAEMON_EVENTS = 4, 64, 96
DAEMON_RATE, DAEMON_FLUSH, DAEMON_QUEUE = 400.0, 8, 4096
DAEMON_FRAME = 1 << 24      # a flush frame at 64 lanes x 512 is ~1.4 MB


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps, warmup=2) -> float:
    """Mean milliseconds per call of ``reps`` calls captured in one CUDA
    graph, by CUDA events around its replay: the device's time per call
    without the host's cost of each launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn, reps=3) -> float:
    """Median host seconds of ``fn`` ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bound(nbytes, ops, ops_per_s=FP64_OPS_PER_S):
    """(ms, 'bytes' | 'operations'): the least time for the work on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bitwise(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}
        a, b = a.view(bits[a.element_size()]), b.view(bits[b.element_size()])
    return bool(torch.equal(a, b))


def sample_scenarios(gen, ns):
    from repro_torch.core import sample_scenario
    return [sample_scenario(gen, int(n), capacity_factor=0.95) for n in ns]


def sample_batch(gen, ns, n_max):
    from repro_torch.core import stack_scenarios
    return stack_scenarios(sample_scenarios(gen, ns), n_max=n_max)


def trajectory_bids(batch, steps=3):
    """Bids after a few plain Alg. 4.1 steps: a mixed admission pattern."""
    from repro_torch.core import cold_start
    from repro_torch.kernels.gnep_iter import ref
    scns, mask = batch.scenarios, batch.mask
    prep = ref.prepare(scns, mask)
    init = cold_start(batch)
    r, bids = init.r, init.bids
    for _ in range(steps):
        r, _, bids, _ = ref.iter_step(prep, scns, mask, r, bids, 0.05)
    return prep, bids


# --------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------------


def check_sweep(inc, spare, p, kernel, plain, label):
    """Kernel vs plain sweep within (2N + 8) ULPs of each row's running-sum
    scale: the two sum N terms in different orders (the kernel's striped
    warp scan and butterfly; torch.cumsum's scan and a tree reduction in
    the plain version),
    and the textbook bound for the difference of two summation orders of N
    terms is about 2N rounding units of the sum of their magnitudes."""
    got = kernel(inc, spare, p)
    want = plain(inc, spare, p)
    n = inc.shape[-1]
    eps = torch.finfo(inc.dtype).eps
    # the ratios in f64, where the floor of 1e-300 on the scale holds
    scale = inc.double().abs().sum(-1)
    pscale = (inc.double() * p.double().unsqueeze(-2)).abs().sum(-1)
    tol = (2 * n + 8) * eps
    errs = [(g.double() - w.double()).abs() for g, w in zip(got, want)]
    ratio = max(float((errs[0] / (tol * scale[..., None]).clamp_min(1e-300)
                       ).max()),
                float((errs[1] / (tol * scale).clamp_min(1e-300)).max()),
                float((errs[2] / (tol * pscale).clamp_min(1e-300)).max()))
    max_err = max(float(e.max()) for e in errs)
    print(f"  {label}: max_abs_err={max_err!r} worst/tolerance={ratio!r}")
    if not ratio <= 1.0:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"sweep beyond (2N+8) ULPs (ratio {ratio})")
    return max_err


def check_fused(args, kernel, plain, label):
    got = kernel(*args)
    want = plain(*args)
    names = ("fill_best", "obj", "best", "rho")
    bad = [nm for nm, g, w in zip(names, got, want) if not bitwise(g, w)]
    max_err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
    # the lanes whose winner is the rho_bar group (its price admits every
    # class), whose replay the kernel can take off the critical path
    ints = {8: torch.int64, 4: torch.int32}[args[5].element_size()]
    won = int((got[3].view(ints) == args[5].view(ints)).sum())
    print(f"  {label}: bitwise={not bad} max_abs_err={max_err!r} "
          f"rho_bar group wins {won} of {args[5].shape[0]} lanes")
    if bad:
        raise AssertionError(f"{label}: kernel not bitwise equal to the "
                             f"plain middle in {bad}")
    return max_err


def fused_args(batch, prep, bids):
    from repro_torch.kernels.gnep_iter.ref import candidates
    bids_eff, cand = candidates(batch.scenarios, batch.mask, bids)
    bids_sorted = torch.gather(bids_eff, 1, prep.order)
    return (bids_sorted, prep.inc_max_sorted, prep.p_sorted, cand, prep.spare,
            prep.rho_bar, prep.sum_r_low, prep.p_r_low, prep.const)


def fused_work(args):
    """Per lane of a fused-middle case: D, the number of distinct candidate
    bit patterns, and L, one past the last class that can change an
    accumulator (every class but those with zero headroom and a finite
    penalty rate)."""
    _, inc_max, p, cand = args[:4]
    ints = {8: torch.int64, 4: torch.int32}[cand.element_size()]
    D = torch.tensor([torch.unique(row).numel() for row in cand.view(ints)],
                     dtype=torch.float64)
    live = ~((inc_max == 0) & torch.isfinite(p))
    col = torch.arange(1, p.shape[1] + 1, device=p.device)
    L = torch.where(live, col, 0).amax(1).double().cpu()
    return D, L


def fused_bound(args, outs):
    """(ms, 'bytes' | 'operations') of the fused middle on these inputs: the
    operands read once and the outputs written once, against the work these
    inputs need: nine operations for every (distinct price, live class)
    step (compare, cum add, two subtracts, max, min, two adds, multiply),
    six for every distinct price's objective and six for every replayed
    live class.  The rate is half the data sheet's, which counts an FMA as
    two operations: the kernel builds with -fmad=false, so each of its
    operations is one instruction."""
    D, L = fused_work(args)
    ops = float((9 * D * L + 6 * D + 6 * L).sum())
    rate = (FP64_OPS_PER_S if args[0].dtype == F64 else FP32_OPS_PER_S) / 2
    return bound(nbytes(*args) + nbytes(*outs), ops, rate)


def fused_label(name, args):
    D, L = fused_work(args)
    B, N = args[0].shape
    return (f"fused_iter_sweep {name} {str(args[0].dtype)[6:]} B={B} N={N} "
            f"Nc={args[3].shape[1]} (distinct prices a lane: mean "
            f"{float(D.mean())!r}, max {int(D.max())}; live classes: max "
            f"{int(L.max())})")


def fused_cases(batch, prep, args):
    """Further bitwise cases of the fused middle beside the main one: the
    main batch in f32; with bids drawn uniformly in [rho_bar, rho_up] per
    class (every price distinct, as phase 2 draws rm_solve's bids); with
    spare = sum_r_low = 0 (every objective equal, so best is 0); at a cold
    start (bids = rho_bar: two prices a lane, the rho_bar group led by real
    slot 0); with bids drawn from {-0, +0, -1.5, 1} (signed zeros are equal
    prices but two bit patterns); and a batch past one staged chunk and one
    candidate segment."""
    from repro_torch.core import cold_start
    gen = torch.Generator().manual_seed(SEED + 1)
    scns, mask = batch.scenarios, batch.mask
    u = torch.rand(mask.shape, generator=gen, dtype=F64).to(mask.device)
    rb = scns.rho_bar[:, None]
    zero = torch.zeros_like(args[4])
    signed = torch.tensor([-0.0, 0.0, -1.5, 1.0], dtype=F64)[
        torch.randint(0, 4, mask.shape, generator=gen)].to(mask.device)
    chunk_batch = sample_batch(gen, CHUNK_NS, max(CHUNK_NS))
    chunk_prep, chunk_bids = trajectory_bids(chunk_batch)
    return {
        "main": tuple(t.float() for t in args),
        "all-distinct": fused_args(batch, prep, rb + u * (scns.rho_up - rb)),
        "tie": args[:4] + (zero, args[5], zero) + args[7:],
        "cold-start": fused_args(batch, prep, cold_start(batch).bids),
        "signed zeros": fused_args(batch, prep, signed),
        "chunked": fused_args(chunk_batch, chunk_prep, chunk_bids),
    }


def emulated_sweep(inc, spare, p_sorted, width):
    """``src/repro_torch/csrc/gnep_sweep.cu``'s arithmetic, step for step,
    in torch: (fill, sum_fill, p_fill) of (B, Nc, N) / (B,) / (B, N)
    operands at ``width`` values per access (``access_width``).

    A warp owns a row; stripe k holds 32 x ``width`` values, thread t the
    ``width`` consecutive ones at k * 32 * width + t * width.  Each thread
    adds its values in order; five shift-and-add steps (``__shfl_up_sync``
    by 1, 2, 4, 8, 16) give the inclusive scan of the 32 thread totals,
    a shift by one the exclusive prefix, and thread 31's total carries to
    the next stripe.  From carry + prefix each thread walks its values in
    order: cum, fill, and its own sum_fill and p_fill terms, which a
    butterfly (``__shfl_xor_sync`` by 16, 8, 4, 2, 1) adds; thread 0's sum
    is the result.  Values past N are zeros, as the kernel's are.  Each
    step is one elementwise torch operation, so nothing contracts into an
    FMA (the kernel builds with -fmad=false): on the card the kernel
    matches this bit for bit (phase 1), and the CPU tests hold it to the
    plain version and to the JAX reference."""
    B, Nc, N = inc.shape
    S = 32 * width
    K = -(-N // S)
    pad = K * S - N
    x = torch.nn.functional.pad(inc, (0, pad)).reshape(B, Nc, K, 32, width)
    pv = torch.nn.functional.pad(p_sorted, (0, pad)).reshape(B, 1, K, 32,
                                                              width)
    lane = torch.arange(32, device=inc.device)
    s = x[..., 0]
    for v in range(1, width):
        s = s + x[..., v]
    incl = s
    for d in (1, 2, 4, 8, 16):
        up = torch.zeros_like(incl)
        up[..., d:] = incl[..., :-d]
        incl = torch.where(lane >= d, incl + up, incl)
    excl = torch.zeros_like(incl)
    excl[..., 1:] = incl[..., :-1]
    sp = spare[:, None, None]
    carry = inc.new_zeros((B, Nc, 1))
    sacc = inc.new_zeros((B, Nc, 32))
    pacc = inc.new_zeros((B, Nc, 32))
    fill = torch.empty_like(x)
    for k in range(K):
        cum = carry + excl[:, :, k]
        carry = carry + incl[:, :, k, 31:]
        for v in range(width):
            xv = x[:, :, k, :, v]
            cum = cum + xv
            f = torch.minimum(torch.clamp(sp - (cum - xv), min=0.0), xv)
            fill[:, :, k, :, v] = f
            sacc = sacc + f
            pacc = pacc + f * pv[:, :, k, :, v]
    for d in (16, 8, 4, 2, 1):
        sacc = sacc + sacc[..., lane ^ d]
        pacc = pacc + pacc[..., lane ^ d]
    return (fill.reshape(B, Nc, K * S)[..., :N], sacc[..., 0], pacc[..., 0])


def check_sweep_order(inc, spare, p, kernel, label):
    """``kernel`` on (B, Nc, N) operands bit for bit against
    ``emulated_sweep`` at the access width the wrapper takes for them."""
    from repro_torch.kernels.gnep_sweep.kernel import access_width
    got = kernel(inc, spare, p)
    want = emulated_sweep(inc, spare, p, access_width(inc, p))
    ok = all(bitwise(g.reshape(w.shape), w) for g, w in zip(got, want))
    print(f"  {label}, {inc.shape[0]} lane(s): bitwise to emulated_sweep "
          f"{ok}")
    if not ok:
        raise AssertionError(f"{label}: the kernel's order of operations "
                             "is not the one emulated_sweep writes out")


def sweep_label(name, inc, p):
    from repro_torch.kernels.gnep_sweep.kernel import access_width
    w = access_width(inc, p)
    how = f"16-byte access, {w} values" if w > 1 else "scalar access"
    return f"{name} {tuple(inc.shape)} {str(inc.dtype)[6:]} ({how})"


def offset_copy(t):
    """A contiguous copy of ``t`` whose base lies one element past a 16-byte
    boundary (a view into a buffer one element longer)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_v16_refusal():
    """The 16-byte entry point returns an error, and launches nothing, for
    a base that is not on a 16-byte boundary."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.gnep_sweep import kernel as sk
    lib = _build.load("gnep_sweep", sk._SIGNATURES)
    buf = torch.zeros(2 * 4 * 4 + 2, dtype=F64, device="cuda")
    spare = torch.ones(2, dtype=F64, device="cuda")
    out = torch.zeros(2 * 4 * 4 + 2 * 4 * 2, dtype=F64, device="cuda")
    err = lib.rm_sweep_v16_f64(buf[1:].data_ptr(), spare.data_ptr(),
                               buf.data_ptr(), out.data_ptr(),
                               out[32:].data_ptr(), out[40:].data_ptr(),
                               2, 4, 4, _build.stream_of(buf))
    torch.cuda.synchronize()
    msg = lib.error_string(err).decode()
    print(f"  rm_sweep_v16_f64 on a base 8 bytes past a 16-byte boundary: "
          f"error {err} ({msg})")
    if err == 0 or torch.count_nonzero(out):
        raise AssertionError("the 16-byte sweep entry point took a "
                             "misaligned operand")


def phase_kernels(main, small):
    from repro_torch.core.game import _rm_candidates
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_iter.ref import fused_middle_reference
    from repro_torch.kernels.gnep_sweep.kernel import (rm_sweep,
                                                       rm_sweep_batched)
    from repro_torch.kernels.gnep_sweep.ref import (reference,
                                                    reference_batched)
    rows = {}
    print("phase 1: kernels against their plain versions on the card")
    for label, batch in (("main", main), ("ragged", small)):
        prep, bids = trajectory_bids(batch)
        scns, mask = batch.scenarios, batch.mask
        # the batched sweep at the shapes the sweep configuration gives it
        _, inc, spare, p_sorted, _ = _rm_candidates(scns, bids, mask)
        spare = spare.contiguous()
        # one instance, as rm_solve(sweep_fn=make_sweep_fn()) gives it
        lane = batch.instance(0)
        _, inc1, spare1, p1, _ = _rm_candidates(
            lane, bids[0][batch.mask[0]],
            torch.ones(lane.n, dtype=torch.bool, device=bids.device))
        # f64 as the main path runs them; at the main shapes also f32
        # (four values to a 16-byte access) and the batched sweep on an
        # operand one element off a 16-byte boundary (scalar access)
        cases = [(inc, spare, p_sorted, inc1, spare1, p1)]
        if label == "main":
            cases.append(tuple(t.float() for t in cases[0]))
        err_b = err_1 = 0.0   # the kernels' rows report the f64 errors
        cut = slice(0, ORDER_LANES)
        for ib, sb, pb, i1, s1, p1_ in cases:
            what_b = sweep_label(f"rm_sweep_batched {label}", ib, pb)
            what_1 = sweep_label(f"rm_sweep {label}", i1, p1_)
            e_b = check_sweep(ib, sb, pb, rm_sweep_batched, reference_batched,
                              what_b)
            e_1 = check_sweep(i1, s1, p1_, rm_sweep, reference, what_1)
            if ib.dtype == F64:
                err_b, err_1 = max(err_b, e_b), max(err_1, e_1)
            check_sweep_order(ib[cut], sb[cut], pb[cut], rm_sweep_batched,
                              what_b)
            check_sweep_order(i1[None], s1.reshape(1), p1_[None],
                              lambda i, s_, p_: rm_sweep(i[0], s_[0], p_[0]),
                              what_1)
        if label == "main":
            inc_off = offset_copy(inc)
            what = sweep_label("rm_sweep_batched main, offset view", inc_off,
                               p_sorted)
            err_b = max(err_b, check_sweep(
                inc_off, spare, p_sorted, rm_sweep_batched, reference_batched,
                what))
            check_sweep_order(inc_off[cut], spare[cut], p_sorted[cut],
                              rm_sweep_batched, what)
            t_scalar = cuda_ms(
                lambda: rm_sweep_batched(inc_off, spare, p_sorted), 20)
            del inc_off
            check_v16_refusal()
        args = fused_args(batch, prep, bids)
        err_f = check_fused(args, fused_iter_sweep, fused_middle_reference,
                            fused_label(label, args))
        if label != "main":
            for name, err in (("rm_sweep_batched", err_b), ("rm_sweep", err_1),
                              ("fused_iter_sweep", err_f)):
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            continue

        # times and bounds at the main path's shapes
        B, Nc, N = inc.shape
        t_k = cuda_ms(lambda: rm_sweep_batched(inc, spare, p_sorted), 20)
        t_p = cuda_ms(lambda: reference_batched(inc, spare, p_sorted), 5)
        t_32 = cuda_ms(lambda: rm_sweep_batched(*cases[1][:3]), 20)
        # inc read and fill written once, spare/p read, sums written;
        # eight operations per (candidate, class) element
        b_ms, b_by = bound(nbytes(inc, spare, p_sorted) + nbytes(inc)
                           + 2 * B * Nc * inc.element_size(), 8 * B * Nc * N)
        b_32, _ = bound(nbytes(*cases[1][:3]) + nbytes(cases[1][0])
                        + 2 * B * Nc * 4, 8 * B * Nc * N, FP32_OPS_PER_S)
        # the practical floor of the same traffic: one copy of inc (its
        # bytes read and written once), a yardstick the port never calls
        dst = torch.empty_like(inc)
        t_copy = cuda_ms(lambda: dst.copy_(inc), 20)
        del dst
        print(f"  rm_sweep_batched f32: ms={t_32!r} bound_ms={b_32!r}; "
              f"f64 with scalar access (offset view): ms={t_scalar!r}; "
              f"(yardstick) inc.copy_ of the f64 main shape: ms={t_copy!r}")
        rows["rm_sweep_batched"] = dict(
            name="rm_sweep_batched", route="cuda",
            source="src/repro_torch/csrc/gnep_sweep.cu",
            replaces="src/repro/kernels/gnep_sweep/kernel.py:146",
            max_abs_err=err_b, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
            bound_by=b_by, library_ms=None)

        # the single instance's 2.6 MB sit in L2 and its kernel takes a few
        # microseconds, less than the wrapper's host work: its time is the
        # device's per call in one CUDA graph of back-to-back calls; the
        # stream-launched loop, paced by the host, is what the main path
        # pays and how earlier rows were timed (stream_ms, plain_stream_ms)
        Nc1, N1 = inc1.shape
        t_k = graph_ms(lambda: rm_sweep(inc1, spare1, p1), 50)
        t_p = graph_ms(lambda: reference(inc1, spare1, p1), 20)
        t_k_host = cuda_ms(lambda: rm_sweep(inc1, spare1, p1), 50)
        t_p_host = cuda_ms(lambda: reference(inc1, spare1, p1), 20)
        print(f"  rm_sweep stream-launched loop: ms={t_k_host!r} "
              f"plain_ms={t_p_host!r}")
        b_ms, b_by = bound(nbytes(inc1, spare1, p1) + nbytes(inc1)
                           + 2 * Nc1 * inc1.element_size(), 8 * Nc1 * N1)
        rows["rm_sweep"] = dict(
            name="rm_sweep", route="cuda",
            source="src/repro_torch/csrc/gnep_sweep.cu",
            replaces="src/repro/kernels/gnep_sweep/kernel.py:64",
            max_abs_err=err_1, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, stream_ms=t_k_host,
            plain_stream_ms=t_p_host)

        more = fused_cases(batch, prep, args)
        for name, case in more.items():
            e = check_fused(case, fused_iter_sweep, fused_middle_reference,
                            fused_label(name, case))
            if case[0].dtype == F64:
                err_f = max(err_f, e)
        tie_best = fused_iter_sweep(*more["tie"])[2]
        if torch.count_nonzero(tie_best):
            raise AssertionError("fused_iter_sweep tie: best is not 0 in "
                                 "every lane")

        # each case's time per call in a stream-launched loop of 20 calls
        # (ms, as every PR has timed this kernel; at a few microseconds it
        # is paced by the wrapper's host work) and in one CUDA graph of 20
        # calls (graph_ms, the device's own time); the B = 1 case is the
        # longest lane alone, the floor that the chain of one lane's walk
        # sets
        lane = int(batch.n_classes.argmax())
        one = tuple(t[lane:lane + 1].contiguous() for t in args)
        timed_cases = {"main f64": args, "main f32": more["main"],
                       "all-distinct": more["all-distinct"],
                       f"B=1 lane {lane} (n={int(batch.n_classes[lane])})":
                       one}
        fused_times = {}
        for name, case in timed_cases.items():
            t = cuda_ms(lambda: fused_iter_sweep(*case), 20)
            t_graph = graph_ms(lambda: fused_iter_sweep(*case), 20)
            b_ms, b_by = fused_bound(case, fused_iter_sweep(*case))
            fused_times[name] = dict(ms=t, graph_ms=t_graph, bound_ms=b_ms,
                                     bound_by=b_by)
            print(f"  fused_iter_sweep {name}: ms={t!r} graph_ms={t_graph!r}"
                  f" bound_ms={b_ms!r} ({b_by})")
        main_t = fused_times["main f64"]
        t_p = cuda_ms(lambda: fused_middle_reference(*args), 3, warmup=1)
        rows["fused_iter_sweep"] = dict(
            name="fused_iter_sweep", route="cuda",
            source="src/repro_torch/csrc/gnep_iter.cu",
            replaces="src/repro/kernels/gnep_iter/kernel.py:137",
            max_abs_err=err_f, ms=main_t["ms"], plain_ms=t_p,
            bound_ms=main_t["bound_ms"], bound_by=main_t["bound_by"],
            library_ms=None, graph_ms=main_t["graph_ms"],
            cases=fused_times)
    for row in rows.values():
        print(f"  {row['name']}: ms={row['ms']!r} plain_ms={row['plain_ms']!r}"
              f" bound_ms={row['bound_ms']!r} ({row['bound_by']})")
    return rows


# --------------------------------------------------------------------------
# phase 2: the main path at paper scale
# --------------------------------------------------------------------------


def phase_main(batch, gen, counters):
    from repro_torch import core
    from repro_torch.kernels.gnep_iter.ops import make_fused_iter_fn
    from repro_torch.kernels.gnep_sweep.ops import (make_batched_sweep_fn,
                                                    make_sweep_fn)
    configs = {
        "fused": core.SolverConfig(iter_fn=make_fused_iter_fn()),
        "sweep": core.SolverConfig(sweep_fn=make_batched_sweep_fn()),
        "default": core.SolverConfig(),
    }
    rm_lanes = range(4)
    rm_bids = []
    for b in rm_lanes:
        lane = batch.instance(b)
        u = torch.rand(lane.n, generator=gen, dtype=F64).to(lane.rho_up.device)
        rm_bids.append(lane.rho_bar + u * (lane.rho_up - lane.rho_bar))

    print(f"phase 2: main path, B={batch.batch_size} lanes, classes "
          f"{int(batch.n_classes.min())}-{int(batch.n_classes.max())} padded "
          f"to {batch.n_max}, f64")
    for fn in counters:
        fn.launches = 0
    reports, launches = {}, {}
    for name, cfg in configs.items():
        before = {fn.__name__: fn.launches for fn in counters}
        reports[name] = core.CapacityEngine(cfg).solve(batch)
        launches[name] = {fn.__name__: fn.launches - before[fn.__name__]
                          for fn in counters}
    rm_out = []
    for b, bids in zip(rm_lanes, rm_bids):
        lane = batch.instance(b)
        rm_out.append((core.rm_solve(lane, bids, sweep_fn=make_sweep_fn()),
                       core.rm_solve(lane, bids)))
    counts = {fn.__name__: fn.launches for fn in counters}
    print(f"  launches in the main path: {counts}; per configuration "
          f"{launches}")
    if any(counts[n] == 0 for n in ALLOCATOR_KERNELS):
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    if any(v for n, v in counts.items() if n not in ALLOCATOR_KERNELS):
        raise AssertionError(f"a model kernel launched in the allocator "
                             f"path: {counts}")
    if any(launches["default"].values()):
        raise AssertionError("the default configuration launched a kernel")

    base = reports["default"]
    iters = base.iters
    print(f"  iterations per lane: min={int(iters.min())} "
          f"max={int(iters.max())}")
    for name, rep in reports.items():
        frac = rep.fractional
        for fld in ("r", "psi", "sM", "sR", "total"):
            if not torch.isfinite(getattr(frac, fld)).all():
                raise AssertionError(f"{name}: non-finite {fld}")
        if frac.r.shape != batch.mask.shape:
            raise AssertionError(f"{name}: r has shape {tuple(frac.r.shape)}")
        if not torch.equal(rep.iters, iters):
            raise AssertionError(f"{name}: iteration counts differ from the "
                                 "default configuration")
        if not torch.equal(rep.feasible, base.feasible):
            raise AssertionError(f"{name}: feasibility differs")
        # 1e-9 of each lane's largest allocation: the kernels reorder
        # prefix sums of <= 500 terms (an O(N eps) = 1e-13 relative move);
        # a different winning price would move r by far more
        scale = base.fractional.r.abs().amax(1, keepdim=True).clamp_min(1.0)
        dr = float(((frac.r - base.fractional.r).abs() / scale).max())
        print(f"  {name}: max |r - r_default| / max|r| = {dr!r}")
        if not dr <= 1e-9:
            raise AssertionError(f"{name}: r disagrees with the default "
                                 f"configuration ({dr})")
        integ = rep.integer
        if integ is None:
            raise AssertionError(f"{name}: rounding did not run")
        if not torch.equal(integ.r, torch.round(integ.r)):
            raise AssertionError(f"{name}: rounded r is not integral")
        if (integ.r.sum(1) > torch.floor(batch.scenarios.R)).any():
            raise AssertionError(f"{name}: rounded r exceeds capacity")

    central = core.solve_centralized_batch(batch)
    gap = base.fractional.total - central.total
    atol = core.CrossCheckPolicy().atol
    print(f"  gap of the equilibrium over the exact (P3) optimum: "
          f"min={float(gap.min())!r} max={float(gap.max())!r}")
    if (gap < -atol).any():
        raise AssertionError("an equilibrium undercuts the exact optimum")

    for b, ((rho_k, r_k, _), (rho_p, r_p, _)) in zip(rm_lanes, rm_out):
        scale = float(r_p.abs().max().clamp_min(1.0))
        if float(rho_k) != float(rho_p) or float(
                (r_k - r_p).abs().max()) > 1e-9 * scale:
            raise AssertionError(f"rm_solve lane {b}: the sweep kernel's "
                                 "price or allocation disagrees")
    print(f"  rm_solve(sweep_fn=make_sweep_fn()) on lanes "
          f"{list(rm_lanes)}: price equal, allocation within 1e-9")
    return configs, counts, reports


def phase_reference(gen):
    """A small batch on the card against the numpy serial baseline and the
    port on the CPU."""
    from repro_torch import core
    from repro_torch.kernels.gnep_iter.ops import make_fused_iter_fn
    scns = [core.sample_scenario(gen, n, capacity_factor=0.95, device="cpu")
            for n in (24, 7, 16, 3)]
    cpu = core.CapacityEngine(device="cpu").solve(scns)
    card = core.CapacityEngine(
        core.SolverConfig(iter_fn=make_fused_iter_fn())).solve(scns)
    for b, scn in enumerate(scns):
        sol, it, _ = core.solve_distributed_python(scn)
        r_card = card.fractional.r[b, :scn.n].cpu()
        scale = float(sol.r.abs().max().clamp_min(1.0))
        if it != int(card.iters[b]) or it != int(cpu.iters[b]):
            raise AssertionError(f"reference lane {b}: iterations differ")
        if float((r_card - sol.r).abs().max()) > 1e-9 * scale:
            raise AssertionError(f"reference lane {b}: r disagrees with the "
                                 "numpy serial baseline")
    print("  small batch (24, 7, 16, 3 classes): card == CPU port == numpy "
          "serial baseline (iterations exact, r within 1e-9)")


# --------------------------------------------------------------------------
# phase 3: the pinned loop, kernel against plain middle, bit for bit
# --------------------------------------------------------------------------


def phase_pinned(gen):
    from repro_torch import core
    from repro_torch.kernels.gnep_iter import ref
    from repro_torch.kernels.gnep_iter.ops import (FusedIterFn,
                                                   make_fused_iter_fn)
    batch = sample_batch(gen, [PIN_N] * PIN_B, PIN_N)
    print(f"phase 3: pinned loop, eps_bar=0, {PIN_STEPS} steps, "
          f"B={PIN_B} N={PIN_N}")
    kernel_fn = make_fused_iter_fn()
    plain_fn = FusedIterFn("plain middle", None)
    scns, mask = batch.scenarios, batch.mask
    prep = ref.prepare(scns, mask)
    init = core.cold_start(batch)
    rk, bk, rp, bp = init.r, init.bids, init.r, init.bids
    changed = 0
    for step in range(PIN_STEPS):
        rk, rhok, bk_new, _ = kernel_fn.step(prep, scns, mask, rk, bk, 0.05)
        rp, rhop, bp, _ = plain_fn.step(prep, scns, mask, rp, bp, 0.05)
        changed += int(not torch.equal(bk_new, bk))
        bk = bk_new
        for nm, a, b in (("r", rk, rp), ("rho", rhok, rhop), ("bids", bk, bp)):
            if not bitwise(a, b):
                raise AssertionError(f"pinned step {step}: {nm} differs "
                                     "between the kernel and the plain middle")
    print(f"  {PIN_STEPS} steps bitwise equal (r, rho, bids); bids changed "
          f"on {changed} of {PIN_STEPS} steps")

    times, reports = {}, {}
    for name, fn in (("fused kernel", kernel_fn), ("plain middle", plain_fn)):
        eng = core.CapacityEngine(core.SolverConfig(
            eps_bar=0.0, max_iters=PIN_STEPS, iter_fn=fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports[name] = eng.solve(batch)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    a, b = reports["fused kernel"], reports["plain middle"]
    if not (bitwise(a.fractional.r, b.fractional.r)
            and bitwise(a.fractional.aux, b.fractional.aux)
            and torch.equal(a.iters, b.iters)
            and bool((a.iters == PIN_STEPS).all())):
        raise AssertionError("pinned solve: the kernel path and the plain "
                             "middle differ")
    if not (bitwise(a.fractional.r, rp) and bitwise(a.fractional.aux, rhop)):
        raise AssertionError("pinned solve differs from the stepped loop")
    print(f"  engine solves bitwise equal, {PIN_STEPS} iterations per lane; "
          f"s: {times}")

    # the fused solve again: its median wall over repeats, and one under the
    # profiler, with the gaps beside the kernel's spans
    from torch.profiler import ProfilerActivity, profile
    eng = core.CapacityEngine(core.SolverConfig(
        eps_bar=0.0, max_iters=PIN_STEPS, iter_fn=kernel_fn))
    median = wall_s(lambda: eng.solve(batch), reps=7)
    print(f"  fused kernel solve, median of 7: s={median!r}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.solve(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_idle(prof, wall, "one pinned fused solve", rows=4)
    report_gaps(prof, "fused_iter")
    return times


# --------------------------------------------------------------------------
# phase 4: timing and idle share
# --------------------------------------------------------------------------


def phase_timing(batch, configs):
    from repro_torch import core
    from torch.profiler import ProfilerActivity, profile
    print("phase 4: solve times at the main path (median of 3, s)")
    times = {}
    for name, cfg in configs.items():
        eng = core.CapacityEngine(cfg)
        times[name] = wall_s(lambda: eng.solve(batch))
        print(f"  {name}: {times[name]!r}")
    eng = core.CapacityEngine(configs["fused"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.solve(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle, _ = report_idle(prof, wall, "one fused solve")
    return times, idle


def report_idle(prof, wall, what, rows=6):
    """Print the device's busy time (the union of its kernel spans) and idle
    share over ``wall`` seconds; None where the profiler saw no device."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy_us += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy_us += cur[1] - cur[0]
    if not spans:
        print("  idle share: not measured (the profiler saw no device time)")
        return None, None
    idle = 1.0 - busy_us * 1e-6 / wall
    print(f"  {what} under the profiler: wall_s={wall!r} "
          f"device_busy_s={busy_us * 1e-6!r} idle_share={idle!r} "
          f"device_events={len(spans)}")
    top = prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=rows)
    print("\n".join("  " + ln for ln in top.splitlines()))
    return idle, busy_us * 1e-6


# --------------------------------------------------------------------------
# phase 1b: the model kernels against their plain versions
# --------------------------------------------------------------------------


def report_gaps(prof, name):
    """Print the mean device time of the kernels whose name holds ``name``
    and the mean idle gap (us) between neighbouring device spans, for the
    gaps next to such a kernel and for all others: a kernel that makes its
    neighbours wait (a shared-memory carveout switch, say) widens the
    first."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    own = [e - s for s, e, n in spans if name in n]
    near, other = [], []
    for (_, e0, n0), (s1, _, n1) in zip(spans, spans[1:]):
        (near if name in n0 or name in n1 else other).append(s1 - e0)

    def mean(xs):
        return sum(xs) / len(xs) if xs else None
    print(f"  {name} spans: {len(own)}, mean us={mean(own)!r}; gaps next to "
          f"them: {len(near)}, mean us={mean(near)!r}, median us="
          f"{statistics.median(near) if near else None!r}; other gaps: "
          f"{len(other)}, mean us={mean(other)!r}, median us="
          f"{statistics.median(other) if other else None!r}")


def check_close(got, want, atol, rtol, label):
    """|got - want| <= atol + rtol |want| everywhere; returns the max error."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    worst = float((err / (atol + rtol * want.abs())).max())
    max_err = float(err.max())
    print(f"  {label}: max_abs_err={max_err!r} worst/tolerance={worst!r}")
    if not (torch.isfinite(got).all() and worst <= 1.0):
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version (worst/tolerance {worst})")
    return max_err


def flash_inputs(gen, B, S, Hq, Hkv, hd, dtype):
    q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda")
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda")
    v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def sdpa(q, k, v, causal):
    """PyTorch's own attention on the same (B, S, H, hd) inputs: a yardstick
    that the port never calls."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True).transpose(1, 2)


def phase_flash(gen):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import reference
    print("phase 1b: flash_attention against its plain version")
    errs, row = [], None
    # bf16: both sides round the same f32 result to bf16 once, and two
    # roundings of nearly equal values differ by at most one bf16 spacing
    # (2^-7 of the value); f32: the same sums in another order, with the
    # online softmax's rescaling, within 1e-4 relative.
    bf16, f32 = (torch.bfloat16, 1e-5, 2.0 ** -7), (torch.float32, 1e-5, 1e-4)
    cases = [(FLASH_MAIN, True, *bf16)] + [
        (FLASH_RAGGED, c, *f32) for c in (True, False)] + [
        (FLASH_MAIN, False, *bf16)] + [
        (FLASH_RAGGED, c, *bf16) for c in (True, False)]
    for shape, causal, dtype, atol, rtol in cases:
        q, k, v = flash_inputs(gen, *shape, dtype)
        errs.append(check_close(
            flash_attention(q, k, v, causal=causal),
            reference(q, k, v, causal=causal), atol, rtol,
            f"flash_attention {shape} {str(dtype)[6:]} causal={causal}"))
        if shape != FLASH_MAIN:
            continue
        # the kernel, SDPA and the plain version in turns: k, l, p, l, k
        B, S, Hq, Hkv, hd = shape
        fns = {"kernel": (lambda: flash_attention(q, k, v, causal=causal), 20),
               "library": (lambda: sdpa(q, k, v, causal), 20),
               "plain": (lambda: reference(q, k, v, causal=causal), 5)}
        times = {name: [] for name in fns}
        for name in ("kernel", "library", "plain", "library", "kernel"):
            fn, reps = fns[name]
            times[name].append(cuda_ms(fn, reps))
        t_k, t_l, t_p = (statistics.mean(times[n])
                         for n in ("kernel", "library", "plain"))
        lib_err = float((sdpa(q, k, v, causal).double()
                         - reference(q, k, v, causal=causal).double()
                         ).abs().max())
        print(f"  (yardstick, not checked) scaled_dot_product_attention: "
              f"max_abs_err={lib_err!r}")
        # q, k, v read and o written once; two products of 2 * hd
        # operations for every (query, key) pair the mask keeps
        pairs = S * (S + 1) // 2 if causal else S * S
        ops = 4 * hd * B * Hq * pairs
        b_ms, b_by = bound(nbytes(q, k, v, q), ops, BF16_OPS_PER_S)
        # the kernel's own floor: P V runs twice (P_hi and P_lo)
        split_ms = 1.5 * ops / BF16_OPS_PER_S * 1e3
        print(f"  flash_attention causal={causal}: ms={t_k!r} "
              f"plain_ms={t_p!r} library_ms={t_l!r} bound_ms={b_ms!r} "
              f"({b_by}, bf16 tensor-core rate) split_floor_ms={split_ms!r} "
              f"turns={times!r}")
        if causal:  # the main path's case: Qwen3's prefill is causal
            row = dict(name="flash_attention", route="cuda",
                       source="src/repro_torch/csrc/flash_attention.cu",
                       replaces="src/repro/kernels/flash_attention/kernel.py"
                                ":71",
                       ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                       library_ms=t_l)
    check_tma_refusal(flash_attention)
    row["max_abs_err"] = max(errs)
    return row


def check_tma_refusal(flash_attention):
    """A bf16 view whose base is not 16-byte aligned (q taken one element
    into the head axis of a wider tensor) is refused before any launch."""
    B, S, Hq, Hkv, hd = FLASH_RAGGED
    wide = torch.zeros((B, S, Hq, hd + 8), dtype=torch.bfloat16,
                       device="cuda")
    q = wide[..., 1:hd + 1]
    k = torch.zeros((B, S, Hkv, hd), dtype=torch.bfloat16, device="cuda")
    before = flash_attention.launches
    try:
        flash_attention(q, k, k, causal=True)
    except ValueError as exc:
        print(f"  misaligned q refused: {exc}")
    else:
        raise AssertionError("flash_attention launched on a q view that TMA "
                             "cannot read")
    if flash_attention.launches != before:
        raise AssertionError("flash_attention counted a refused launch")


def wkv_inputs(gen, B, T, H, K, shift, with_state):
    """Model-like WKV operands: w_log = clip(-exp(N(shift, 0.5)), -8, -1e-5)."""
    r, k, v = (torch.randn((B, T, H, K), generator=gen, device="cuda")
               for _ in range(3))
    w = -torch.exp(torch.randn((B, T, H, K), generator=gen, device="cuda")
                   * 0.5 + shift)
    w = w.clamp(-8.0, -1e-5)
    u = torch.randn((H, K), generator=gen, device="cuda") * 0.3
    S0 = (torch.randn((B, H, K, K), generator=gen, device="cuda")
          if with_state else None)
    return r, k, v, w, u, S0


def wkv_ops(B, T, H, K, L):
    """Operations of the chunked form at chunk L: the strictly lower
    intra-chunk product and its product with v, the inter-chunk product and
    the state update (2 per multiply-add), and about 12 per (row, channel)
    for the decay cumsum, the four exponentials and their products."""
    pairs = L * (L - 1) // 2
    per_chunk = 2 * (pairs * K + pairs * K + 2 * L * K * K + K * K) \
        + 12 * L * K
    return B * H * (T // L) * per_chunk


def phase_wkv(gen):
    from repro_torch.kernels.rwkv6.kernel import pass_launchers, route, wkv6
    from repro_torch.kernels.rwkv6.ref import chunked_reference
    print("phase 1c: wkv6 against its plain version (the chunked form at "
          "the same chunk)")
    errs, row = [], None
    for B, T, H, K, L, shift, with_state in WKV_CASES:
        r, k, v, w, u, S0 = wkv_inputs(gen, B, T, H, K, shift, with_state)
        S0_plain = S0 if with_state else torch.zeros(
            (B, H, K, K), device="cuda")
        how = route(r, k, v, w, L)
        if (L % 64 == 0) != (how == "chunk-parallel"):
            raise AssertionError(f"wkv6 chunk {L} K {K} took the {how} "
                                 "route")
        y, S = wkv6(r, k, v, w, u, chunk=L, S0=S0)
        y_p, S_p = chunked_reference(r, k, v, w, u, S0_plain, chunk=L)
        # the same f32 formula summed in another order (the products in
        # three TF32 parts on the chunk-parallel route): within 1e-4 of the
        # largest magnitude of each output
        label = (f"wkv6 B={B} T={T} H={H} K={K} chunk={L} "
                 f"{'S0' if with_state else 'zero state'} route={how}")
        errs.append(max(
            check_close(y, y_p, 1e-4 * float(y_p.abs().max()), 0.0,
                        label + " y"),
            check_close(S, S_p, 1e-4 * float(S_p.abs().max()), 0.0,
                        label + " S")))
        if row is not None:
            continue
        from repro_torch.kernels.rwkv6.ref import reference
        y_rec, _ = reference(r, k, v, w, u, S0_plain)
        dep = float((y - y_rec).abs().max() / y_rec.abs().max())
        print(f"  (not checked) the chunked form at chunk {L} against the "
              f"exact recurrence: max|diff|/max|y| = {dep!r}; the kernel "
              "and its plain version alike (ROADMAP Queue 3)")
        t_k = cuda_ms(lambda: wkv6(r, k, v, w, u, chunk=L), 20)
        t_p = cuda_ms(lambda: chunked_reference(r, k, v, w, u, S0_plain,
                                                chunk=L), 5)
        passes = {name: cuda_ms(fn, 20) for name, fn in
                  pass_launchers(r, k, v, w, u, chunk=L).items()}
        # the least time: the bytes (inputs read once, y and S written
        # once) against the operations on the tensor cores as the kernel
        # runs them, each product as three TF32 products, and the decay
        # work (12 per (row, channel)) at the f32 rate; beside it the
        # operations all at the f32 rate (the CUDA-core kernel's bound)
        moved = nbytes(r, k, v, w, u, y, S)
        elem = 12 * B * T * H * K
        prod = wkv_ops(B, T, H, K, L) - elem
        t_ops = (3 * prod / TF32_OPS_PER_S + elem / FP32_OPS_PER_S) * 1e3
        b_ms, b_by = max((moved / HBM_BYTES_PER_S * 1e3, "bytes"),
                         (t_ops, "operations"))
        f32_ms, _ = bound(moved, wkv_ops(B, T, H, K, L), FP32_OPS_PER_S)
        row = dict(name="wkv6", route="cuda",
                   source="src/repro_torch/csrc/wkv6.cu",
                   replaces="src/repro/kernels/rwkv6/kernel.py:73",
                   ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None)
        print(f"  wkv6 ({how}): ms={t_k!r} plain_ms={t_p!r} "
              f"bound_ms={b_ms!r} ({b_by}, split TF32 products) "
              f"f32_rate_bound_ms={f32_ms!r} passes_ms={passes!r}")
    row["max_abs_err"] = max(errs)
    return row


def phase_dot(gen):
    """``layers.dot`` on bf16 operands: an f32 result within 1e-5 of the
    largest |x.float() @ w.float()| (TF32 off: a full f32 product), where a
    bf16-rounded result departs by about 2^-9 of it."""
    from repro_torch.models import layers
    M, D, N = DOT_SHAPE
    x = torch.randn((M, D), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((D, N), generator=gen, device="cuda")
         * D ** -0.5).bfloat16()
    got = layers.dot(x, w)
    want = x.float() @ w.float()
    if got.dtype != torch.float32:
        raise AssertionError(f"layers.dot returned {got.dtype} for bf16")
    err = float((got - want).abs().max() / want.abs().max())
    bf16_err = float((torch.matmul(x, w).float() - want).abs().max()
                     / want.abs().max())
    print(f"phase 1d: layers.dot bf16 {DOT_SHAPE}: max|dot - f32 "
          f"product|/max = {err!r} (a bf16-rounded product: {bf16_err!r})")
    if not err <= 1e-5:
        raise AssertionError(f"layers.dot departs from the f32 product by "
                             f"{err} of its largest value")


# --------------------------------------------------------------------------
# phase 5: the tenant LM serving path at full width
# --------------------------------------------------------------------------


def phase_serving(arch, counters):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import generate
    cfg = get_config(arch)
    B, S0, N = SERVE_B, SERVE_PROMPT, SERVE_NEW
    print(f"phase 5: serving {arch} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}), batch {B}, prompt {S0}, {N} new "
          "tokens, greedy")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  init_params: {n_params} parameters in "
          f"{time.perf_counter() - t0:.2f} s")
    prompt = torch.randint(0, cfg.vocab, (B, S0), generator=gen,
                           device="cuda")

    for fn in counters:
        fn.launches = 0
    toks, logits = generate(cfg, params, prompt, max_new_tokens=N,
                            return_logits=True)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in counters}
    print(f"  launches in one generate: {counts}")
    want = {"flash_attention": cfg.n_layers if not cfg.rwkv else 0,
            "wkv6": cfg.n_layers if cfg.rwkv else 0}
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{arch}: {name} launched {n} times in one "
                                 f"generate, expected {want.get(name, 0)}")

    if toks.shape != (B, N) or logits.shape != (B, N, cfg.vocab):
        raise AssertionError(f"{arch}: shapes {tuple(toks.shape)}, "
                             f"{tuple(logits.shape)}")
    if not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{arch}: a token is outside the vocabulary")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: non-finite logits")
    if not torch.equal(toks, logits.argmax(-1)):
        raise AssertionError(f"{arch}: greedy tokens are not the argmax")
    rel = decode_vs_forward(cfg, params, prompt, toks, logits)
    if not cfg.rwkv:
        # bf16 keeps 8 significant bits (u = 2^-8); each layer rounds the
        # residual stream a few times, and ~6 roundings x 28 layers
        # accumulating as a random walk give sqrt(168) u = 0.051, so the
        # logits must agree within 5e-2 of the largest one
        if not rel <= 5e-2:
            raise AssertionError(f"{arch}: decode disagrees with the "
                                 f"forward pass ({rel})")
    else:
        print(f"  (not checked: the prefill's chunk "
              f"{math.gcd(S0, max(256, S0 // 128))} gives the reference's "
              "clamped form, the longer forward's chunk 1 the exact "
              "recurrence; ROADMAP Queue 3)")
        prompt2 = torch.randint(0, cfg.vocab, (B, RWKV_AGREE_PROMPT),
                                generator=gen, device="cuda")
        toks2, logits2 = generate(cfg, params, prompt2, max_new_tokens=N,
                                  return_logits=True)
        decode_vs_forward(cfg, params, prompt2, toks2, logits2)
        print("  (not checked in bf16: the random-init RWKV's logits drift "
              "under bf16 rounding past any bound derived from it; the same "
              "path in f32, below, is held to the JAX test's 2e-4)")

    stats = {}
    generate(cfg, params, prompt, max_new_tokens=N, stats=stats)
    dec_tok_s = B * (N - 1) / stats["decode_s"]
    print(f"  generate (warm): prefill_s={stats['prefill_s']!r} "
          f"decode_s={stats['decode_s']!r} decode_tok_s={dec_tok_s!r}")
    out = dict(prefill_s=stats["prefill_s"], decode_tok_s=dec_tok_s,
               counts=counts, idle=None, idle_warm=None)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(cfg, params, prompt, max_new_tokens=N)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["idle"], busy = report_idle(prof, wall, f"one {arch} generate",
                                    rows=8)
    if busy is not None:
        # the profiler slows the host; against the unprofiled warm run
        warm = stats["prefill_s"] + stats["decode_s"]
        out["idle_warm"] = 1.0 - busy / warm
        print(f"  device busy over the unprofiled warm generate "
              f"({warm!r} s): idle_share={out['idle_warm']!r}")
    del params
    torch.cuda.empty_cache()
    if cfg.rwkv:
        out["f32_rel"] = rwkv_f32_agreement(cfg)
    return out


def rwkv_f32_agreement(cfg):
    """The same serving code path with f32 activations and weights (the bf16
    weights' unrounded draws), full width and depth, prompt 1040: the last
    decode step against the forward, within the 2e-4 that the JAX test
    (``tests/test_models.py::_decode_consistency``) holds f32 models to."""
    from repro_torch.models import init_params
    from repro_torch.serving import generate
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg32, gen, device="cuda")
    prompt = torch.randint(0, cfg32.vocab, (SERVE_B, RWKV_AGREE_PROMPT),
                           generator=gen, device="cuda")
    toks, logits = generate(cfg32, params, prompt, max_new_tokens=SERVE_NEW,
                            return_logits=True)
    rel = decode_vs_forward(cfg32, params, prompt, toks, logits,
                            what=f"{cfg.name} in f32: ")
    del params
    torch.cuda.empty_cache()
    if not rel <= 2e-4:
        raise AssertionError(f"{cfg.name} f32: decode disagrees with the "
                             f"forward pass ({rel})")
    return rel


def decode_vs_forward(cfg, params, prompt, toks, logits, what=""):
    """Max |difference| of the last decode step's logits and a forward over
    the prompt and the generated tokens, over the largest logit."""
    from repro_torch.models import forward
    full = torch.cat([prompt, toks[:, :-1]], dim=1)
    with torch.inference_mode():
        ref_logits, _, _ = forward(cfg, params, {"tokens": full})
    a, b = ref_logits[:, -1], logits[:, -1]
    rel = float((a - b).abs().max() / a.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).double().mean())
    print(f"  {what}last decode step after a {prompt.shape[1]}-token "
          f"prompt vs a forward over {full.shape[1]} tokens: "
          f"max|diff|/max|logit| = "
          f"{rel!r}, argmax agreement {agree!r}")
    return rel


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


# --------------------------------------------------------------------------
# phase 6: the admission window
# --------------------------------------------------------------------------


def window_trace(scns):
    """The phase's trace, sampled so that every event addresses a slot that
    is occupied when it is applied: 256 events of the reference mix; a
    burst of arrivals that fills the fullest lane and grows the window
    512 -> 1,024; then 256 events sampled on a window with the trace so far
    replayed, cut where the fused session compacts (after its 8th flush at
    the grown width; flushes fall every ``WIN_FLUSH`` events) and the rest
    sampled on the compacted window.  Returns the trace, the event count at
    the compaction, the count through the burst (the sweep session's) and
    the burst lane."""
    from repro_torch import core
    base = core.AdmissionWindow(scns, n_max=WIN_N_MAX)
    first = core.sample_event_trace(0, base, WIN_EVENTS)
    scratch = core.AdmissionWindow(scns, n_max=WIN_N_MAX)
    core.replay(scratch, first)
    lane = int(np.argmax(scratch.n_classes))
    free = WIN_N_MAX - int(scratch.n_classes[lane])
    gen = torch.Generator().manual_seed(SEED + 7)
    burst = [core.ClassArrival(lane=lane, params=core.sample_class_params(gen))
             for _ in range(free + 8)]
    width = scratch.n_max
    core.replay(scratch, burst)
    if width != WIN_N_MAX or scratch.n_max != 2 * WIN_N_MAX:
        raise AssertionError(f"the window grew {width} -> {scratch.n_max}")
    grew = len(first) + free           # the arrival that finds its row full
    cut = WIN_FLUSH * (grew // WIN_FLUSH + WIN_COMPACT_AFTER)
    head = len(first) + len(burst)
    mid = core.sample_event_trace(1, scratch, cut - head)
    core.replay(scratch, mid)
    scratch.compact()
    last = core.sample_event_trace(2, scratch, WIN_EVENTS - (cut - head))
    return first + burst + mid + last, cut, head, lane


def holey_lanes(mask):
    """Lanes with an empty slot before their last occupied one."""
    n = mask.shape[1]
    col = torch.arange(1, n + 1, device=mask.device)
    end = torch.where(mask, col, 0).amax(1)
    return torch.nonzero(mask.sum(1) < end)[:, 0]


def passes_through(prev, rep, slot_map=None):
    """Gate 1: lanes ``rep`` did not resolve keep ``prev``'s r, price and
    iterations bit for bit (the common columns after a growth, through
    ``slot_map`` after a compaction)."""
    frozen = torch.as_tensor(~rep.resolved, device=rep.mask.device)
    if slot_map is None:
        n = min(prev.mask.shape[1], rep.mask.shape[1])
        old, new = prev.fractional.r[:, :n], rep.fractional.r[:, :n]
    else:
        occ = torch.as_tensor(slot_map >= 0, device=rep.mask.device)
        dst = torch.as_tensor(slot_map.clip(min=0), device=rep.mask.device)
        old = torch.where(occ, prev.fractional.r, 0.0)
        new = torch.where(occ, torch.gather(rep.fractional.r, 1, dst), 0.0)
    return (bitwise(old[frozen], new[frozen])
            and bitwise(prev.fractional.aux[frozen], rep.fractional.aux[frozen])
            and torch.equal(prev.iters[frozen], rep.iters[frozen]))


def against_cold(rep, batch, cfg):
    """Gate 2: the flush against a cold solve of the window it solved
    (``batch``, held as it was) under the same kernel configuration: resolved lanes bit for bit (each lane's trajectory is
    its own row's), frozen lanes within 1e-9 of their largest r with equal
    iterations, feasibility equal.  Returns the cold solve, its wall and
    the frozen lanes' largest departure."""
    from repro_torch import core
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = core.solve_distributed_batch(batch, sweep_fn=cfg.sweep_fn,
                                        iter_fn=cfg.iter_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = torch.as_tensor(rep.resolved, device=rep.mask.device)
    got, want = rep.fractional, cold
    if not (bitwise(got.r[res], want.r[res])
            and bitwise(got.aux[res], want.aux[res])
            and torch.equal(rep.iters, cold.iters)
            and torch.equal(rep.feasible, cold.feasible)):
        raise AssertionError("gate 2: a resolved lane, an iteration count or "
                             "a feasibility flag differs from the cold solve")
    scale = want.r.abs().amax(1).clamp_min(1.0)
    dr = float(((got.r - want.r).abs().amax(1) / scale).max())
    drho = float(((got.aux - want.aux).abs() / want.aux.abs()).max())
    if not (dr <= 1e-9 and drho <= 1e-9):
        raise AssertionError(f"gate 2: a frozen lane departs from the cold "
                             f"solve ({dr}, {drho})")
    return cold, wall, max(dr, drho)


def against_plain(batch, cfg, cold, label):
    """Gate 2, the kernel itself: the flush's kernel against its plain
    version on this window (rows with holes, the grown or compacted
    width), at bids three cold Alg. 4.1 steps in (every re-solved lane
    starts cold).  The fused middle bit for bit, and ``cold`` bit for bit
    equal to a cold solve with the plain middle; the sweep within
    (2N + 8) ULPs on every lane, and bit for bit to ``emulated_sweep`` on
    lanes with holes.  Returns the max abs error and the holey lanes'
    count."""
    from repro_torch import core
    from repro_torch.core.game import _rm_candidates
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_iter.ops import FusedIterFn
    from repro_torch.kernels.gnep_iter.ref import fused_middle_reference
    from repro_torch.kernels.gnep_sweep.kernel import rm_sweep_batched
    from repro_torch.kernels.gnep_sweep.ref import reference_batched
    holey = holey_lanes(batch.mask)
    label = f"{label}, {holey.numel()} lanes with holes"
    prep, bids = trajectory_bids(batch)
    if cfg.iter_fn is not None:
        args = fused_args(batch, prep, bids)
        err = check_fused(args, fused_iter_sweep, fused_middle_reference,
                          fused_label(label, args))
        plain = core.solve_distributed_batch(
            batch, iter_fn=FusedIterFn("plain middle", None))
        if not (bitwise(cold.r, plain.r) and bitwise(cold.aux, plain.aux)
                and torch.equal(cold.iters, plain.iters)):
            raise AssertionError(f"{label}: the cold solve through the kernel "
                                 "differs from the plain middle's")
        return err, holey.numel()
    _, inc, spare, p_sorted, _ = _rm_candidates(batch.scenarios, bids,
                                                batch.mask)
    spare = spare.contiguous()
    what = sweep_label(f"rm_sweep_batched {label}", inc, p_sorted)
    err = check_sweep(inc, spare, p_sorted, rm_sweep_batched,
                      reference_batched, what)
    some = holey[:ORDER_LANES]
    if some.numel():
        check_sweep_order(inc[some], spare[some], p_sorted[some],
                          rm_sweep_batched, what)
    return err, holey.numel()


def window_session(name, cfg, scns, trace, kernel, compact_at=None):
    """Drive one session over the trace and hold gates 1, 2, 4 and 5 at
    every flush, compacting after the flush that ends at event
    ``compact_at``.  Returns the session and its measurements."""
    from repro_torch import core
    from torch.profiler import ProfilerActivity, profile
    pol = core.Policies(flush=core.FlushPolicy(max_events=WIN_FLUSH),
                        cross_check=core.CrossCheckPolicy(True))
    session = core.CapacityEngine(cfg, pol).open_window(
        core.AdmissionWindow(scns, n_max=WIN_N_MAX))
    window = session.window
    kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prev = session.solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernel.launches
    if not prev.resolved.all() or launches != int(prev.iters.max()):
        raise AssertionError(f"{name}: the first solve resolved "
                             f"{int(prev.resolved.sum())} lanes in "
                             f"{launches} launches")
    # the cross-check solved all 256 lanes in one batched call: its totals
    # against the reference's one solve a lane, on a few lanes
    batch, lanes = window.batch, min(8, window.batch_size)
    per_lane = torch.stack([core.solve_centralized(
        core.Scenario(**{f.name: getattr(batch.scenarios, f.name)[b]
                         for f in dataclasses.fields(core.Scenario)}),
        mask=batch.mask[b]).total for b in range(lanes)])
    memo = torch.tensor(window.baseline_totals[:lanes], dtype=F64,
                        device=per_lane.device)
    cc_rel = float(((memo - per_lane).abs() / per_lane.abs()).max())
    print(f"  {name}: the batched cross-check's totals against one solve a "
          f"lane (lanes 0-{lanes - 1}): max relative difference {cc_rel!r}")
    if not cc_rel <= 1e-12:
        raise AssertionError(f"{name}: the batched cross-check departs from "
                             f"per-lane solves ({cc_rel})")
    stream = session.stream(trace)
    walls, cold_walls, dirty, per_flush, widths = [], [], [], [], []
    compacted_at, slot_map, idle, worst = None, None, None, 0.0
    timed_events, profiled_once, gated = 0, False, []
    while True:
        before, start = kernel.launches, session.events_folded
        # profile the flush after the first one at the grown width (the
        # last flush where the trace ends with the growth); its wall is
        # left out of the timings
        profiled = not profiled_once and (
            widths[-1:] == [2 * WIN_N_MAX]
            or len(trace) - start <= WIN_FLUSH)
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if profiled else contextlib.nullcontext())
        with prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = next(stream, None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if rep is None:
            break
        end = session.events_folded
        if profiled:
            profiled_once = True
            idle, _ = report_idle(prof, wall, f"{name}: one flush at width "
                                  f"{rep.mask.shape[1]}", rows=6)
        else:
            walls.append(wall)
            timed_events += end - start
        n = kernel.launches - before
        widths.append(rep.mask.shape[1])
        dirty.append(int(rep.resolved.sum()))
        per_flush.append(n)
        launches += n
        # gate 1: resolved = the lanes the flushed events touched
        touched = np.zeros(window.batch_size, bool)
        touched[[ev.lane for ev in trace[start:end]]] = True
        if not np.array_equal(rep.resolved, touched):
            raise AssertionError(f"{name} flush {len(widths)}: resolved "
                                 "lanes are not the lanes its events touched")
        if not passes_through(prev, rep, slot_map):
            raise AssertionError(f"{name} flush {len(widths)}: a frozen lane "
                                 "did not pass through bit for bit")
        # gate 4: one launch per loop step; the loop runs until the slowest
        # resolved lane converges
        res = torch.as_tensor(rep.resolved, device=rep.iters.device)
        steps = int(rep.iters[res].max()) if rep.resolved.any() else 0
        if n != steps:
            raise AssertionError(f"{name} flush {len(widths)}: {n} launches "
                                 f"for {steps} loop steps")
        if len(widths) % WIN_GATE_EVERY == 0 or end == len(trace):
            # held for gate 2 after the stream, so that no check runs
            # between the timed flushes (a report and a batch never change)
            gated.append((len(widths), rep, window.batch,
                          compacted_at is not None))
        prev, slot_map = rep, None
        if end == compact_at:
            # gate 5: 8 flushes at the grown width, then a map that follows
            # the mask and a width that is the widest lane's
            if widths.count(2 * WIN_N_MAX) != WIN_COMPACT_AFTER:
                raise AssertionError(f"{name}: {widths.count(2 * WIN_N_MAX)} "
                                     f"flushes at width {2 * WIN_N_MAX} "
                                     "before the compaction")
            pre = window._mask.copy()
            slot_map = session.compact()
            compacted_at = end
            counts = pre.sum(1)
            packed = all(np.array_equal(slot_map[b, pre[b]],
                                        np.arange(counts[b]))
                         for b in range(window.batch_size))
            if not (np.array_equal(slot_map >= 0, pre) and packed
                    and np.array_equal(window._mask,
                                       np.arange(window.n_max)[None]
                                       < counts[:, None])
                    and window.n_max == int(counts.max())):
                raise AssertionError(f"{name}: compact() gave a slot map or "
                                     f"width ({window.n_max}) that does not "
                                     "follow the mask")
            print(f"  {name}: compact() after flush {len(widths)} (event "
                  f"{end}): n_max {2 * WIN_N_MAX} -> {window.n_max}")
    # gate 2 at every 8th flush and the last; its kernel checks held on
    # rows with holes at the grown width and, where the session compacts,
    # after the compaction
    plain_err, held = 0.0, set()
    for flush, rep, batch, compacted in gated:
        cold, cold_s, err = against_cold(rep, batch, session.engine.config)
        cold_walls.append(cold_s)
        worst = max(worst, err)
        err, holes = against_plain(
            batch, session.engine.config, cold,
            f"{name} flush {flush} width {batch.n_max}")
        plain_err = max(plain_err, err)
        if holes:
            held.add("compacted" if compacted else batch.n_max)
    want = {2 * WIN_N_MAX} | ({"compacted"} if compact_at else set())
    if not want <= held:
        raise AssertionError(f"{name}: the kernel was held to its plain "
                             f"version on windows with holes only at "
                             f"{held}")
    # gate 4, the clean window: a solve and a flush launch nothing
    before = kernel.launches
    echo = session.flush()
    clean = session.solve()
    if kernel.launches != before or clean.resolved.any() or (
            echo.fractional is not prev.fractional):
        raise AssertionError(f"{name}: a flush of a clean window solved")
    # gate 5: growth (and, where asked, compaction after 8 flushes at the
    # grown width) both happened
    at_full = widths.count(2 * WIN_N_MAX)
    if at_full < 1 or compacted_at != compact_at:
        raise AssertionError(f"{name}: {at_full} flushes at width "
                             f"{2 * WIN_N_MAX}, compacted at {compacted_at}")
    out = dict(flushes=len(widths), events=session.events_folded,
               events_per_s=timed_events / sum(walls),
               flush_s=statistics.median(walls),
               cold_s=statistics.median(cold_walls),
               dirty=statistics.median(dirty),
               launches_per_flush=statistics.mean(per_flush),
               launches=launches, idle=idle, first_s=first_s,
               widths=sorted(set(widths)), frozen_err=worst,
               plain_err=plain_err)
    print(f"  {name}: {out['flushes']} flushes of {out['events']} events "
          f"(widths {out['widths']}); events_per_s={out['events_per_s']!r} "
          f"median flush_s={out['flush_s']!r} median cold re-solve "
          f"s={out['cold_s']!r}; median dirty lanes a flush {out['dirty']!r}; "
          f"{kernel.__name__} launches a flush {out['launches_per_flush']!r} "
          f"({launches} in all, first solve {first_s!r} s); frozen lanes "
          f"against the cold solve within {worst!r}; kernel against its "
          f"plain version on the window: max_abs_err={plain_err!r}")
    return session, out


def phase_window(counters):
    """The runtime loop at the paper's scale: gates 1-6 (see each helper)."""
    from repro_torch import core
    from repro_torch.core.streaming import _CLASS_FIELDS
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_iter.ops import make_fused_iter_fn
    from repro_torch.kernels.gnep_sweep.kernel import rm_sweep_batched
    from repro_torch.kernels.gnep_sweep.ops import make_batched_sweep_fn
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 6)
    ns = torch.randint(MAIN_N_LO, MAIN_N_MAX + 1, (MAIN_B,), generator=gen)
    scns = sample_scenarios(gen, ns.tolist())
    trace, cut, head, lane = window_trace(scns)
    print(f"phase 6: the admission window, {MAIN_B} lanes of "
          f"{int(ns.min())}-{int(ns.max())} classes, n_max {WIN_N_MAX}, f64; "
          f"trace {WIN_EVENTS} events + a burst of {head - WIN_EVENTS} into "
          f"lane {lane} + {len(trace) - head} events (sampled on the window "
          f"compacted after event {cut}), a flush every {WIN_FLUSH}")
    for fn in counters:
        fn.launches = 0
    fused_cfg = core.SolverConfig(iter_fn=make_fused_iter_fn())
    session, fused = window_session("fused", fused_cfg, scns, trace,
                                    fused_iter_sweep, compact_at=cut)
    sweep_cfg = core.SolverConfig(sweep_fn=make_batched_sweep_fn())
    _, sweep = window_session("sweep", sweep_cfg, scns, trace[:head],
                              rm_sweep_batched)
    others = {fn.__name__: fn.launches for fn in counters
              if fn not in (fused_iter_sweep, rm_sweep_batched)}
    if any(others.values()):
        raise AssertionError(f"another kernel launched in phase 6: {others}")

    # gate 6: the coalesced session equals an event-by-event replay with the
    # same compaction, and the burst lane's constants equal derive afresh
    window = session.window
    replayed = core.AdmissionWindow(scns, n_max=WIN_N_MAX)
    core.replay(replayed, trace[:cut])
    replayed.compact()
    core.replay(replayed, trace[cut:])
    fields = [f.name for f in dataclasses.fields(core.Scenario)]
    bad = [f for f in fields if not bitwise(getattr(window._scn, f),
                                            getattr(replayed._scn, f))]
    if bad or not np.array_equal(window._mask, replayed._mask) or (
            window._raw != replayed._raw):
        raise AssertionError(f"gate 6: the session's window differs from the "
                             f"event-by-event replay in {bad}")
    slots = window.occupied(lane)
    raw = {f: torch.tensor([window._raw[(lane, s)][f] for s in slots],
                           dtype=F64, device=window.device)
           for f in core.RAW_CLASS_FIELDS}
    fresh = core.derive(**raw, R=window._scn.R[lane],
                        rho_bar=window._scn.rho_bar[lane])
    idx = torch.tensor(slots, device=window.device)
    bad = [f for f in _CLASS_FIELDS
           if not bitwise(getattr(window._scn, f)[lane, idx],
                          getattr(fresh, f))]
    if bad or not bitwise(window._scn.rho_hat[lane], fresh.rho_hat):
        raise AssertionError(f"gate 6: lane {lane}'s constants differ from "
                             f"derive on the card in {bad}")
    print(f"  gate 6: the window after {len(trace)} events equals their "
          f"event-by-event replay bit for bit; lane {lane}'s {len(slots)} "
          "classes equal derive on the card bit for bit")
    took = time.perf_counter() - t_phase
    print(f"  phase 6: {took!r} s")
    return {"fused": fused, "sweep": sweep, "seconds": took, "scns": scns,
            "trace": trace, "cut": cut}



# --------------------------------------------------------------------------
# phase 7: lane shards, resident window sessions and the facades
# --------------------------------------------------------------------------


def shard_steps(iters, n_shards, inert):
    """Loop steps of a sharded solve whose lanes iterated ``iters`` times:
    for each shard its lanes' most, summed over the shards, the inert
    padding lanes taking ``inert`` (1 cold, 0 warm: they are frozen)."""
    pad = -(-iters.shape[0] // n_shards) * n_shards - iters.shape[0]
    iters = torch.cat([iters, iters.new_full((pad,), inert)])
    return int(iters.view(n_shards, -1).amax(1).sum())


def resolved_iters(rep):
    """A window report's iterations on the lanes it resolved, 0 elsewhere."""
    res = torch.as_tensor(rep.resolved, device=rep.iters.device)
    return torch.where(res, rep.iters, 0)


def same_report(a, b):
    """The fields in which two reports differ bit for bit (empty if none)."""
    bad = [f.name for f in dataclasses.fields(a.fractional)
           if not bitwise(getattr(a.fractional, f.name),
                          getattr(b.fractional, f.name))]
    if (a.integer is None) != (b.integer is None):
        bad.append("integer")
    elif a.integer is not None:
        bad += [f"integer.{f}" for f, x, y in zip(a.integer._fields,
                                                  a.integer, b.integer)
                if not bitwise(x, y)]
    if not np.array_equal(getattr(a, "resolved", None),
                          getattr(b, "resolved", None)):
        bad.append("resolved")
    for name in ("iters", "mask", "n_classes", "centralized_gap"):
        x, y = getattr(a, name, None), getattr(b, name, None)
        if (x is None) != (y is None) or (x is not None
                                          and not bitwise(x, y)):
            bad.append(name)
    return bad


def counted(tally, kernel, fn, *args, **kw):
    """``fn(*args, **kw)``, adding ``kernel``'s launches in it to ``tally``."""
    before = kernel.launches
    out = fn(*args, **kw)
    n = kernel.launches - before
    tally[kernel.__name__] = tally.get(kernel.__name__, 0) + n
    return out, n


def sharded_solves(batch, configs, reports, window, kernels, tally):
    """7a: phase 2's batch over a 1-shard and a 3-shard mesh on the card
    (258 padded lanes, 2 inert), each configuration against phase 2's
    unsharded report bit for bit, with one launch a loop step a shard; then
    2 lanes over the 3 shards (a shard of inert lanes only), and 255 of
    phase 6's lanes at an odd width on the 3 shards (``odd_width``)."""
    from repro_torch import core
    meshes = {1: core.lane_mesh(), 3: core.lane_mesh(devices=["cuda:0"] * 3)}
    for name in ("fused", "sweep"):
        kernel = kernels[name]
        for d, mesh in meshes.items():
            cfg = dataclasses.replace(configs[name], mesh=mesh)
            if f"|mesh={d}:lanes" not in cfg.fingerprint():
                raise AssertionError(f"7a: fingerprint {cfg.fingerprint()}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep, n = counted(tally, kernel, core.CapacityEngine(cfg).solve,
                             batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = shard_steps(rep.iters, d, inert=1)
            bad = same_report(rep, reports[name])
            print(f"  7a {name} on {d} shard(s): {n} {kernel.__name__} "
                  f"launches (the shards' loop steps: {steps}), wall "
                  f"{wall!r} s; differs from phase 2's unsharded solve in "
                  f"{bad or 'nothing'}")
            if n != steps or bad:
                raise AssertionError(f"7a {name} on {d} shard(s): {n} "
                                     f"launches for {steps} steps; {bad}")
    two = batch.take([0, 1])
    for name in ("fused", "sweep"):
        cfg = dataclasses.replace(configs[name], mesh=meshes[3])
        rep, n = counted(tally, kernels[name],
                         core.CapacityEngine(cfg).solve, two)
        bad = same_report(rep, core.CapacityEngine(configs[name]).solve(two))
        steps = shard_steps(rep.iters, 3, inert=1)
        print(f"  7a {name}, 2 lanes on 3 shards (the last only an inert "
              f"lane): {n} launches for {steps} loop steps; differs from "
              f"the unsharded solve in {bad or 'nothing'}")
        if bad or n != steps:
            raise AssertionError(f"7a {name}, 2 lanes on 3 shards")
    odd_width(window, configs, meshes[3], kernels, tally)


def odd_width(window, configs, mesh, kernels, tally):
    """7a at an odd width: 255 of phase 6's lanes at n_max 501 on 3 shards
    of 85.  Shard d's rows start d * 85 * 501 * 8 bytes in (8 mod 16 for
    d = 1) and its rho_bar (a view the fused kernel reads) d * 85 * 8 bytes
    in.  torch's CUDA row sum (``sum(-1)``) adds a row in an order set by
    the row's 32-byte alignment, so the loop widens the class axis to a
    multiple of 4 with masked classes on the card
    (``game._aligned_classes``: 504 here), where every row of any shard
    starts on the boundary.  Every field of the report must equal the
    unsharded solve's bit for bit, under the fused, sweep and plain
    middles, with one launch a loop step a shard; and the unsharded solves
    against their plain versions (``odd_against_plain``).  The probes show
    the premise: that sum on a copy of shard 1 against the whole batch's, at
    widths ODD_N_MAX (differs) and MAIN_N_MAX and the widened width (the
    same); and the fused kernel on shard 1's row slice of the whole
    batch's operands, bit for bit its rows of the whole launch."""
    from repro_torch import core
    from repro_torch.core import game
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_iter.ops import FusedIterFn
    odd = core.stack_scenarios(window["scns"][:255], n_max=ODD_N_MAX)
    offsets = [odd.scenarios.A.narrow(0, 85, 85).data_ptr() % 16,
               odd.scenarios.rho_bar.narrow(0, 85, 85).data_ptr() % 16]
    if offsets != [8, 8]:
        raise AssertionError(f"7a: shard 1 starts at {offsets} mod 16")
    wide, _ = game._aligned_classes(odd, None)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    same_sum = {}
    for width in (ODD_N_MAX, MAIN_N_MAX, wide.n_max):
        x = torch.rand((255, width), generator=gen, device="cuda",
                       dtype=torch.float64)
        same_sum[width] = bitwise(x.narrow(0, 85, 85).clone().sum(-1),
                                  x.sum(-1)[85:170])
    plain = dict(configs, plain=core.SolverConfig(
        iter_fn=FusedIterFn("plain middle", None)))
    unsharded = {name: core.CapacityEngine(plain[name]).solve(odd)
                 for name in ("fused", "sweep", "plain", "default")}
    for name in ("fused", "sweep", "plain"):
        cfg = dataclasses.replace(plain[name], mesh=mesh)
        if name in kernels:
            rep, n = counted(tally, kernels[name],
                             core.CapacityEngine(cfg).solve, odd)
            steps = shard_steps(rep.iters, 3, inert=1)
        else:
            rep, n, steps = core.CapacityEngine(cfg).solve(odd), 0, 0
        bad = same_report(rep, unsharded[name])
        print(f"  7a {name}, 255 lanes at width {ODD_N_MAX} (the loop at "
              f"{wide.n_max}) on 3 shards (shard 1's rows and rho_bar at "
              f"{offsets} mod 16 bytes): {n} launches for {steps} loop "
              f"steps; differs from the unsharded solve bit for bit in "
              f"{bad or 'nothing'}")
        if bad or n != steps or rep.fractional.r.shape[1] != ODD_N_MAX:
            raise AssertionError(f"7a {name}, 255 lanes at width "
                                 f"{ODD_N_MAX} on 3 shards: {bad}")
    odd_against_plain(unsharded)
    prep, bids = trajectory_bids(odd)
    args = fused_args(odd, prep, bids)
    whole = fused_iter_sweep(*args)
    part = fused_iter_sweep(*(t.narrow(0, 85, 85) for t in args))
    rows = all(bitwise(p, w.narrow(0, 85, 85)) for p, w in zip(part, whole))
    print(f"  7a probes: row sum of a copy of shard 1 bit for bit the whole "
          f"batch's at width {ODD_N_MAX}: {same_sum[ODD_N_MAX]}, at "
          f"{MAIN_N_MAX}: {same_sum[MAIN_N_MAX]}, at the widened "
          f"{wide.n_max}: {same_sum[wide.n_max]}; fused kernel on shard 1's "
          f"row slice bit for bit its rows of the whole launch: {rows}")
    if not rows or not same_sum[MAIN_N_MAX] or not same_sum[wide.n_max]:
        raise AssertionError("7a probes: the kernel depends on the row "
                             "offset, or the row sum does at an aligned "
                             "width")


def odd_against_plain(unsharded):
    """7a at width 501: the unsharded fused solve bit for bit the plain
    middle's in every field, and the sweep solve against the default
    configuration's under phase 2's gate (iterations and feasibility
    exact, r within 1e-9 of each lane's largest allocation), both on the
    widened class axis."""
    bad = same_report(unsharded["fused"], unsharded["plain"])
    got, want = unsharded["sweep"], unsharded["default"]
    scale = want.fractional.r.abs().amax(1, keepdim=True).clamp_min(1.0)
    dr = float(((got.fractional.r - want.fractional.r).abs() / scale).max())
    exact = (torch.equal(got.iters, want.iters)
             and torch.equal(got.feasible, want.feasible))
    print(f"  7a at width {ODD_N_MAX}, unsharded: fused differs from the "
          f"plain middle bit for bit in {bad or 'nothing'}; sweep against "
          f"the default configuration: iterations and feasibility equal "
          f"{exact}, max |r - r_default| / max|r| = {dr!r}")
    if bad or not exact or not dr <= 1e-9:
        raise AssertionError(f"7a at width {ODD_N_MAX}: a kernel's solve "
                             f"departs from its plain version's ({bad}, "
                             f"{exact}, {dr})")


def drive(cfg, scns, trace, cut, kernel, tally=None, profile_at=None):
    """One session over phase 6's trace, compacting after the flush that
    ends at event ``cut``.  Returns a namespace: the ``session``, its
    ``reports`` (the first solve's, then a flush's), the compaction's
    ``slot_map``, the ``launches`` of each report, the flush ``walls`` and
    ``events`` (one profiled flush left out), the resident batches ``held``
    for the kernel check (every 8th flush and after the compaction) and
    the profiled ``idle`` share.  Launches count in ``tally`` when it is
    given."""
    from repro_torch import core
    from torch.profiler import ProfilerActivity, profile
    pol = core.Policies(flush=core.FlushPolicy(max_events=WIN_FLUSH),
                        cross_check=core.CrossCheckPolicy(True))
    session = core.CapacityEngine(cfg, pol).open_window(
        core.AdmissionWindow(scns, n_max=WIN_N_MAX))
    resident = cfg.residency == "resident"
    local = {}
    rep, n = counted(local, kernel, session.solve)
    reports, launches = [rep], [n]
    stream = session.stream(trace)
    walls, events, held, idle, slot_map = [], [], [], None, None
    profiled_once = False
    while True:
        start = session.events_folded
        profiled = (not profiled_once and profile_at is not None
                    and session.window.n_max == profile_at)
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if profiled else contextlib.nullcontext())
        with prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep, n = counted(local, kernel, next, stream, None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if rep is None:
            break
        if profiled:
            profiled_once = True
            idle, _ = report_idle(prof, wall, f"7b resident on "
                                  f"{cfg.mesh.devices.size} shard(s): one "
                                  f"flush at width {rep.mask.shape[1]}",
                                  rows=4)
        else:
            walls.append(wall)
            events.append(session.events_folded - start)
        reports.append(rep)
        launches.append(n)
        if resident and (len(reports) - 1) % WIN_GATE_EVERY == 0:
            held.append((f"flush {len(reports) - 1}",
                         session.window.resident_batch()))
        if session.events_folded == cut:
            slot_map = session.compact()
            if resident:
                held.append((f"compacted after flush {len(reports) - 1}",
                             session.window.resident_batch()))
    if tally is not None:
        for k, v in local.items():
            tally[k] = tally.get(k, 0) + v
    return types.SimpleNamespace(
        session=session, reports=reports, slot_map=slot_map,
        launches=launches, walls=walls, events=events, held=held, idle=idle)


def hold_session(label, got, want, n_shards):
    """Every report of ``got`` equals ``want``'s bit for bit, and each took
    one launch a loop step a shard."""
    if (len(got.reports) != len(want.reports)
            or not np.array_equal(got.slot_map, want.slot_map)):
        raise AssertionError(f"7b {label}: {len(got.reports)} reports "
                             f"against {len(want.reports)}, or the slot maps "
                             "differ")
    for i, (a, b, n) in enumerate(zip(got.reports, want.reports,
                                      got.launches)):
        bad = same_report(a, b)
        steps = shard_steps(resolved_iters(a), n_shards, inert=int(i == 0))
        if bad or n != steps:
            raise AssertionError(f"7b {label}, report {i}: {n} launches for "
                                 f"{steps} loop steps; differs from the "
                                 f"round trip in {bad}")


def resident_sessions(configs, window, kernels, tally):
    """7b: phase 6's fused session over its trace, resident on 3 shards of
    the card (258 padded lanes, 2 inert) and then on 1, every report held
    to the round-trip session's bit for bit; the fused middle held to its
    plain version on the padded resident batch; a lane pair that moves B
    across a multiple of 3; and release_resident.  Returns measurements."""
    from repro_torch import core
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_iter.ref import fused_middle_reference
    scns, trace, cut = window["scns"], window["trace"], window["cut"]
    kernel, rt_cfg = kernels["fused"], configs["fused"]
    rt = drive(rt_cfg, scns, trace, cut, kernel)
    mesh3 = core.lane_mesh(devices=["cuda:0"] * 3)
    res3 = drive(dataclasses.replace(rt_cfg, mesh=mesh3,
                                     residency="resident"),
                 scns, trace, cut, kernel, tally)
    hold_session("3 shards", res3, rt, 3)
    w = res3.session.window
    rows = -(-MAIN_B // 3) * 3
    if not (w.is_resident and w._scn.A.shape[0] == rows
            and not w._mask_dev[MAIN_B:].any()):
        raise AssertionError(f"7b: the window is not resident at {rows} "
                             "lanes")
    print(f"  7b resident on 3 shards: the first solve, "
          f"{len(res3.reports) - 1} flushes and the compaction equal the "
          f"round trip's bit for bit, {sum(res3.launches)} {kernel.__name__} "
          f"launches (one a loop step a shard); median flush "
          f"{statistics.median(res3.walls)!r} s (round trip "
          f"{statistics.median(rt.walls)!r} s)")
    err = 0.0
    for label, rbatch in res3.held:
        prep, bids = trajectory_bids(rbatch)
        args = fused_args(rbatch, prep, bids)
        err = max(err, check_fused(args, fused_iter_sweep,
                                   fused_middle_reference,
                                   fused_label(f"7b padded {label}", args)))
    # a lane pair that moves B across a multiple of 3: 256 -> 255 (no
    # padding lane; a capacity cut in each shard first, so the solve has
    # dirty lanes in every shard) -> 256 (258 rows; the new lane dirty),
    # each followed by a solve
    res, ref = res3.session, rt.session
    lane = ref.window.batch.instance(MAIN_B - 1)
    R = ref.window.batch.scenarios.R.tolist()
    cuts = [core.CapacityChange(b, R[b] * 0.97) for b in (0, 100, 200)]
    for step in ("remove_lane", "add_lane"):
        for s in (res, ref):
            if step == "remove_lane":
                for ev in cuts:
                    s.offer(ev)
                s.remove_lane(MAIN_B - 1)
            else:
                s.add_lane(lane)
        a, n = counted(tally, kernel, res.solve)
        bad = same_report(a, ref.solve())
        rows = w._scn.A.shape[0]
        steps = shard_steps(resolved_iters(a), 3, inert=0)
        print(f"  7b {step}: B={w.batch_size}, {rows} resident rows, "
              f"{int(np.sum(a.resolved))} lanes re-solved, {n} launches for "
              f"{steps} loop steps; differs from the round trip in "
              f"{bad or 'nothing'}")
        if bad or rows != -(-w.batch_size // 3) * 3 or n != steps or not n:
            raise AssertionError(f"7b {step}: {bad}, {rows} rows, {n} "
                                 f"launches for {steps} steps")
    w.release_resident()
    fields = [f.name for f in dataclasses.fields(core.Scenario)]
    bad = [f for f in fields if not bitwise(getattr(w._scn, f),
                                            getattr(ref.window._scn, f))]
    bad += [f for f, x, y in zip(core.WindowState._fields, w.state,
                                 ref.window.state) if not bitwise(x, y)]
    if bad or w.is_resident or not np.array_equal(w._mask, ref.window._mask) \
            or w._raw != ref.window._raw:
        raise AssertionError(f"7b: the released window differs in {bad}")
    print("  7b release_resident: the window equals the round trip's leaf "
          "by leaf")
    res1 = drive(dataclasses.replace(rt_cfg, mesh=core.lane_mesh(),
                                     residency="resident"),
                 scns, trace, cut, kernel, tally, profile_at=2 * WIN_N_MAX)
    hold_session("1 shard", res1, rt, 1)
    idle1 = res1.idle
    out = dict(flush3_s=statistics.median(res3.walls),
               flush1_s=statistics.median(res1.walls),
               flush_rt_s=statistics.median(rt.walls),
               events_per_s3=sum(res3.events) / sum(res3.walls),
               events_per_s1=sum(res1.events) / sum(res1.walls),
               launches_per_flush3=statistics.mean(res3.launches[1:]),
               launches_per_flush1=statistics.mean(res1.launches[1:]),
               idle1=idle1, plain_err=err)
    fused = window["fused"]
    print(f"  7b resident on 1 shard: every report equal to the round trip's "
          f"bit for bit; median flush {out['flush1_s']!r} s, "
          f"events_per_s={out['events_per_s1']!r}, idle share of one "
          f"profiled flush {idle1!r}; 3 shards: "
          f"events_per_s={out['events_per_s3']!r}, launches a flush "
          f"{out['launches_per_flush3']!r} (1 shard "
          f"{out['launches_per_flush1']!r}); phase 6's fused session: "
          f"median flush {fused['flush_s']!r} s, "
          f"events_per_s={fused['events_per_s']!r}, idle {fused['idle']!r}")
    return out


def facades(batch, configs, window, kernels, tally):
    """7c: the deprecated facades on the card, each bit for bit its engine
    call, each seen to warn and to launch its kernel."""
    import warnings
    from repro_torch import core
    kernel, sweep = kernels["sweep"], configs["sweep"].sweep_fn
    events = window["trace"][:4 * WIN_FLUSH]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got, n_batch = counted(tally, kernel, core.solve_batch, batch,
                               sweep_fn=sweep)
        w_shim = core.AdmissionWindow(window["scns"], n_max=WIN_N_MAX)
        got_c, n_coal = counted(tally, kernel, lambda: list(
            core.solve_coalesced(w_shim, events, sweep_fn=sweep)))
    warned = [str(x.message).split(" is deprecated")[0] for x in seen
              if issubclass(x.category, DeprecationWarning)]
    want = core.CapacityEngine(configs["sweep"]).solve(batch)
    eng = core.CapacityEngine(configs["sweep"], core.Policies(
        flush=core.FlushPolicy(max_events=WIN_FLUSH)))
    want_c = list(eng.open_window(core.AdmissionWindow(
        window["scns"], n_max=WIN_N_MAX)).stream(events))
    bad = same_report(got, want)
    bad += [f"flush {i}: {b}" for i, (x, y) in enumerate(zip(got_c, want_c))
            for b in same_report(x, y)]
    print(f"  7c solve_batch: {n_batch} launches; solve_coalesced: "
          f"{len(got_c)} flushes, {n_coal} launches; warned: {warned}; "
          f"differs from the engine calls in {bad or 'nothing'}")
    if (bad or len(got_c) != len(want_c) or not n_batch or not n_coal
            or warned != ["repro_torch.core.allocator.solve_batch",
                          "repro_torch.core.allocator.solve_coalesced"]):
        raise AssertionError("7c: a facade failed its gates")


def no_fallback(batch, window):
    """A CPU mesh under tensors on the card is refused, never taken."""
    from repro_torch import core
    cpu = core.lane_mesh(devices=["cpu"] * 2)
    w = core.AdmissionWindow(window["scns"][:4], n_max=WIN_N_MAX)
    for what, call in (("solve_sharded_batch",
                        lambda: core.solve_sharded_batch(batch, cpu)),
                       ("make_resident", lambda: w.make_resident(cpu))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"{what} took a CPU mesh for tensors on the "
                             "card")
    print("  no fallback: solve_sharded_batch and make_resident refuse a CPU "
          "mesh under tensors on the card")


def phase_shards(batch, configs, reports, window, counters):
    """Phase 7: 7a, 7b and 7c (see each helper).  The counts are set to 0
    before; the launches of the paths under test are tallied, those of the
    round-trip references and of the kernel checks are not."""
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_sweep.kernel import rm_sweep_batched
    t_phase = time.perf_counter()
    kernels = {"fused": fused_iter_sweep, "sweep": rm_sweep_batched}
    print(f"phase 7: lane shards, resident sessions and the facades on the "
          f"card, {batch.batch_size} lanes, f64")
    for fn in counters:
        fn.launches = 0
    tally = {}
    sharded_solves(batch, configs, reports, window, kernels, tally)
    out = resident_sessions(configs, window, kernels, tally)
    facades(batch, configs, window, kernels, tally)
    no_fallback(batch, window)
    others = {fn.__name__: fn.launches for fn in counters
              if fn not in kernels.values() and fn.launches}
    if others or set(tally) != {k.__name__ for k in kernels.values()} or (
            not all(tally.values())):
        raise AssertionError(f"phase 7 launches: {tally}, others {others}")
    out["launches"] = tally
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 7: launches of the paths under test {tally}; "
          f"{out['seconds']!r} s")
    return out


# --------------------------------------------------------------------------
# phase 8: the capacity planner
# --------------------------------------------------------------------------


def plan_spec(n_classes=None, tiers=None, penalties=None):
    """The phase's design space: plan_perf's axes, or ``n_classes``
    classes over the first ``tiers`` tiers and ``penalties``."""
    from repro_torch.core import PlanSpec, VMTier
    return PlanSpec(
        n_classes=n_classes or PLAN_CLASSES, profile=PLAN_PROFILE,
        rate=PLAN_RATE, trace_events=PLAN_EVENTS,
        cluster_sizes=PLAN_CLUSTERS,
        vm_tiers=tuple(VMTier(*t) for t in PLAN_TIERS[:tiers]),
        penalty_scales=penalties or PLAN_PENALTIES,
        deadline_scales=PLAN_DEADLINES, seed=SEED)


def plan_steps(iters, groups):
    """Loop steps of a plan: for each solve (a group of candidate rows) its
    lanes' most, at least 1 (inert padding lanes iterate once)."""
    return sum(max(1, int(iters[rows].max())) for rows in groups)


def cold_groups(n, chunk):
    return [np.arange(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def warm_groups(n, chunk, depth):
    """The rows of each solve of the warm mode: chains of ``depth`` deadline
    steps, ``chunk`` chains a solve, one solve a step."""
    cross = n // depth
    return [np.arange(c0, min(c0 + chunk, cross)) * depth + d
            for c0 in range(0, cross, chunk) for d in range(depth)]


def same_plan(a, b, rows=None):
    """The fields in which two plan reports differ bit for bit (on ``rows``
    when given)."""
    pick = slice(None) if rows is None else rows
    return [k for k in ("cost", "penalty", "total", "r", "iters", "feasible")
            if np.asarray(getattr(a, k))[pick].tobytes()
            != np.asarray(getattr(b, k))[pick].tobytes()]


def planned(counters, kernel, fn, *args, **kw):
    """``fn(*args, **kw)`` with every count set to 0 just before and read
    just after: returns its result and ``kernel``'s launches (0 for
    ``kernel=None``), and fails if another kernel launched."""
    for k in counters:
        k.launches = 0
    out = fn(*args, **kw)
    others = {k.__name__: k.launches for k in counters
              if k is not kernel and k.launches}
    if others:
        raise AssertionError(f"another kernel launched: {others}")
    return out, kernel.launches if kernel is not None else 0


def plan_against_plain(counters, grid, name, got, chunk):
    """The kernel's plan ``got`` against its plain version's on the same
    grid and chunk, solved with no kernel: the fused plan bit for bit in
    every field to the plain middle's (``FusedIterFn("plain middle",
    None)``, as phases 3 and 6 hold it); the sweep plan to the default
    configuration's with iterations and feasibility exact, r within 1e-9
    of each candidate's largest allocation and cost / penalty / total
    within 1e-9 of the largest of the three (phase 2's gate for the same
    pair of solves: the kernel sums a row's terms in another order)."""
    from repro_torch import core
    from repro_torch.core import solve_plan
    from repro_torch.kernels.gnep_iter.ops import FusedIterFn
    if name == "fused":
        what, cfg = "the plain middle", core.SolverConfig(
            iter_fn=FusedIterFn("plain middle", None))
    else:
        what, cfg = "the default configuration", core.SolverConfig()
    want, _ = planned(counters, None, solve_plan, grid, config=cfg,
                      chunk=chunk)
    if name == "fused":
        bad = same_plan(got, want)
        dev = "bit for bit"
    else:
        bad = [k for k in ("iters", "feasible")
               if not np.array_equal(getattr(got, k), getattr(want, k))]
        scale = np.maximum(np.abs(want.r).max(1), 1.0)
        dr = float((np.abs(got.r - want.r).max(1) / scale).max())
        big = np.maximum.reduce([np.abs(want.cost), np.abs(want.penalty),
                                 np.abs(want.total), np.ones_like(want.cost)])
        dt = max(float((np.abs(getattr(got, k) - getattr(want, k)) / big
                        ).max()) for k in ("cost", "penalty", "total"))
        bad += [k for k, d in (("r", dr), ("cost/penalty/total", dt))
                if not d <= 1e-9]
        dev = f"max relative departure r {dr!r}, cost/penalty/total {dt!r}"
    print(f"  {name}, {len(grid)} candidates, chunk {chunk}, against "
          f"{what} ({dev}): differs in {bad or 'nothing'}")
    if bad:
        raise AssertionError(f"phase 8 {name}: the plan departs from "
                             f"{what}'s in {bad}")


def plan_chunk_kernels(grid, name, chunk):
    """The kernel against its plain version on the operands of the plan's
    last chunk of ``chunk`` as the loop sees them: inert-lane padded to the
    chunk width and widened by ``game._aligned_classes`` (masked tail
    classes bidding rho_bar), at bids three cold Alg. 4.1 steps in and at
    bids drawn uniformly in [rho_bar, rho_up] per class (every price
    distinct).  The fused middle bit for bit; the sweep within (2N + 8)
    ULPs on every lane and bit for bit to ``emulated_sweep`` on the first
    and last lanes (real lanes with the masked tail, inert lanes when the
    chunk is ragged).  Returns the max abs error."""
    from repro_torch import core
    from repro_torch.core import game, sharding
    from repro_torch.core.game import _rm_candidates
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_iter.ref import fused_middle_reference
    from repro_torch.kernels.gnep_sweep.kernel import rm_sweep_batched
    from repro_torch.kernels.gnep_sweep.ref import reference_batched
    start = (len(grid) - 1) // chunk * chunk
    n_max = max(c.scenario.n for c in grid)
    batch = core.stack_scenarios([c.scenario for c in grid[start:]],
                                 n_max=n_max)
    batch = sharding.pad_batch_lanes(batch, chunk)
    wide, _ = game._aligned_classes(batch, None)
    scns, mask = wide.scenarios, wide.mask
    prep, stepped = trajectory_bids(wide)
    gen = torch.Generator().manual_seed(SEED + 2)
    u = torch.rand(mask.shape, generator=gen, dtype=F64).to(mask.device)
    rb = scns.rho_bar[:, None]
    label = (f"the plan's last chunk ({len(grid) - start} candidates and "
             f"{chunk - len(grid) + start} inert lanes, {n_max} classes "
             f"widened to {wide.n_max})")
    half = ORDER_LANES // 2
    lanes = torch.cat([torch.arange(half), torch.arange(chunk - half, chunk)]
                      ).to(mask.device)
    err = 0.0
    for how, bids in (("three steps in", stepped),
                      ("uniform bids", rb + u * (scns.rho_up - rb))):
        what = f"{label}, {how}"
        if name == "fused":
            args = fused_args(wide, prep, bids)
            err = max(err, check_fused(args, fused_iter_sweep,
                                       fused_middle_reference,
                                       fused_label(what, args)))
            continue
        _, inc, spare, p_sorted, _ = _rm_candidates(scns, bids, mask)
        spare = spare.contiguous()
        what = sweep_label(f"rm_sweep_batched {what}", inc, p_sorted)
        err = max(err, check_sweep(inc, spare, p_sorted, rm_sweep_batched,
                                   reference_batched, what))
        check_sweep_order(inc[lanes], spare[lanes], p_sorted[lanes],
                          rm_sweep_batched, what)
    return err


def plan_invariance(counters, cfg, kernel, name, n_classes, tiers, penalties,
                    chunks, tally):
    """Chunks ``chunks`` and one shot bit for bit the first chunk width's
    plan at ``n_classes`` classes, each one launch a loop step a chunk;
    that plan against its plain version's (``plan_against_plain``) and the
    kernel against its plain version on the last chunk of the last width
    (``plan_chunk_kernels``)."""
    from repro_torch.core import generate_grid, solve_plan
    grid = generate_grid(plan_spec(n_classes, tiers, penalties))
    n = len(grid)
    ref = None
    for chunk in chunks + (n,):
        rep, k = planned(counters, kernel, solve_plan, grid, config=cfg,
                         chunk=chunk)
        tally[name] += k
        steps = plan_steps(rep.iters, cold_groups(n, chunk))
        bad = [] if ref is None else same_plan(rep, ref)
        print(f"  {name}, {n} candidates of {n_classes} classes, chunk "
              f"{chunk}: {rep.n_chunks} chunks, {k} launches for {steps} "
              f"loop steps; differs from chunk {chunks[0]} in "
              f"{bad or 'nothing'}")
        if bad or k != steps or rep.r.shape != (n, n_classes):
            raise AssertionError(f"phase 8 {name} at {n_classes} classes, "
                                 f"chunk {chunk}: {k} launches for {steps} "
                                 f"steps; {bad}")
        if ref is None:
            ref = rep
    plan_against_plain(counters, grid, name, ref, chunks[0])
    plan_chunk_kernels(grid, name, chunks[-1])
    return ref


def phase_plan(counters):
    """Phase 8: the planner over plan_perf's full design space, under the
    fused and sweep configurations: chunk invariance, warm against cold,
    the frontier queries across configurations, launches, throughput and
    one chunk's idle share; then the odd widths and the launcher."""
    from repro_torch import core
    from repro_torch.core import generate_grid, solve_plan
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_iter.ops import make_fused_iter_fn
    from repro_torch.kernels.gnep_sweep.kernel import rm_sweep_batched
    from repro_torch.kernels.gnep_sweep.ops import make_batched_sweep_fn
    from repro_torch.launch import plan as plan_cli
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    spec = plan_spec()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = generate_grid(spec)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    n, depth = len(grid), len(spec.deadline_scales)
    print(f"phase 8: the capacity planner, {n} candidates "
          f"({'x'.join(map(str, spec.grid_shape))}) of {spec.n_classes} "
          f"classes sized against a {PLAN_PROFILE} trace of {PLAN_EVENTS} "
          f"events, chunks of {PLAN_CHUNK}; grid derived on the card in "
          f"{grid_s!r} s")
    paths = {"fused": (core.SolverConfig(iter_fn=make_fused_iter_fn()),
                       fused_iter_sweep),
             "sweep": (core.SolverConfig(sweep_fn=make_batched_sweep_fn()),
                       rm_sweep_batched)}
    tally = {"fused": 0, "sweep": 0}
    out = {}
    for name, (cfg, kernel) in paths.items():
        cold = plan_invariance(counters, cfg, kernel, name, PLAN_CLASSES,
                               len(PLAN_TIERS), PLAN_PENALTIES,
                               (PLAN_CHUNK,) + PLAN_CHUNKS, tally)
        warm, k = planned(counters, kernel, solve_plan, spec, config=cfg,
                          chunk=PLAN_CHUNK, warm_start=True)
        tally[name] += k
        steps = plan_steps(warm.iters, warm_groups(n, PLAN_CHUNK, depth))
        same = warm.iters == cold.iters
        bad = same_plan(warm, cold, same)
        if not same[::depth].all():
            bad.append("a chain's first step")
        print(f"  {name}, warm start: {warm.n_chunks} solves, {k} launches "
              f"for {steps} loop steps; {int(same.sum())} of {n} candidates "
              f"stop at the cold iteration, differing from it in "
              f"{bad or 'nothing'}")
        if bad or k != steps or not np.array_equal(warm.feasible,
                                                   cold.feasible):
            raise AssertionError(f"phase 8 {name}, warm start: {k} launches "
                                 f"for {steps} steps; {bad}")
        for label, rep in (("cold", cold), ("warm", warm)):
            if not (np.isfinite(rep.r).all() and np.isfinite(rep.total).all()
                    and rep.r.shape == (n, PLAN_CLASSES)):
                raise AssertionError(f"phase 8 {name} {label}: non-finite "
                                     "or misshapen results")
        # each plan's own clock (PlanReport.elapsed_s): from after the grid
        # is expanded to the last chunk's read-back, so the warm plan's
        # grid derivation (grid_s above) is not in its time
        cold_s = statistics.median(
            solve_plan(grid, config=cfg, chunk=PLAN_CHUNK).elapsed_s
            for _ in range(3))
        walls = {"cold": cold_s, "warm": warm.elapsed_s}
        out[name] = {"cold": cold, "warm": warm, "walls": walls,
                     "cands_per_s": {k_: n / w for k_, w in walls.items()}}
        print(f"  {name}: cold plan (median of 3) and warm plan (once), grid "
              f"excluded, {walls!r} s, candidates/s "
              f"{out[name]['cands_per_s']!r}")
    fronts = {name: (o["cold"].pareto_frontier().tolist(),
                     o["cold"].cheapest_feasible()) for name, o in out.items()}
    print(f"  frontier and cheapest feasible design: {fronts}; "
          f"{int(out['fused']['cold'].feasible.sum())} of {n} feasible")
    if fronts["fused"] != fronts["sweep"] or fronts["fused"][1] is None:
        raise AssertionError(f"phase 8: the configurations' frontiers "
                             f"differ: {fronts}")
    for n_classes, tiers, chunks in PLAN_ODD:
        for name, (cfg, kernel) in paths.items():
            plan_invariance(counters, cfg, kernel, name, n_classes, tiers,
                            (1.0,), chunks, tally)
    probes = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for width in [c for c, _, _ in PLAN_ODD]:
        x = torch.rand((128, width), generator=gen, device="cuda",
                       dtype=torch.float64)
        probes[width] = bitwise(x.narrow(0, 37, 64).clone().sum(-1),
                                x.sum(-1)[37:101])
    print(f"  probe: a row sum of a copy of rows 37-100 bit for bit the "
          f"whole's, by width (unwidened): {probes}")

    cfg, kernel = paths["fused"]
    engine = core.CapacityEngine(cfg, core.Policies(
        rounding=core.RoundingPolicy(False)))
    batch = core.stack_scenarios([c.scenario for c in grid[:PLAN_CHUNK]])
    engine.solve(batch, check_feasible=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.solve(batch, check_feasible=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle, busy = report_idle(prof, wall, f"one fused chunk of {PLAN_CHUNK}",
                             rows=4)
    t0 = time.perf_counter()
    rep = plan_cli.main(["--classes", str(PLAN_CLASSES), "--profile",
                         PLAN_PROFILE, "--warm-start"])
    if rep.cheapest_feasible() is None or rep.n_candidates != 18:
        raise AssertionError("phase 8: the launcher found no design")
    print(f"  repro_torch.launch.plan.main on the card: {rep.n_candidates} "
          f"candidates in {time.perf_counter() - t0!r} s")
    took = time.perf_counter() - t_phase
    print(f"  phase 8: launches {tally}; {took!r} s")
    return {"launches": tally, "seconds": took, "idle": idle, "busy": busy,
            "cands_per_s": {k: o["cands_per_s"] for k, o in out.items()},
            "chunks": out["fused"]["cold"].n_chunks}


# --------------------------------------------------------------------------
# phase 9: the admission daemon, in process and over the wire
# --------------------------------------------------------------------------


def daemon_tenants():
    """The tenants' lanes and traces: DAEMON_LANES lanes of 100-500 classes
    each (n_max 512), DAEMON_EVENTS events sampled on each window."""
    from repro_torch import core
    gen = torch.Generator().manual_seed(SEED + 9)
    lanes, traces = {}, {}
    for t in range(DAEMON_TENANTS):
        ns = torch.randint(MAIN_N_LO, MAIN_N_MAX + 1, (DAEMON_LANES,),
                           generator=gen)
        name = f"tenant-{t}"
        lanes[name] = [core.sample_scenario(gen, int(k), capacity_factor=1.3)
                       for k in ns]
        traces[name] = core.sample_event_trace(
            SEED + 7919 * t, core.AdmissionWindow(lanes[name],
                                                  n_max=WIN_N_MAX),
            DAEMON_EVENTS)
    return lanes, traces


def daemon_engine(cfg):
    from repro_torch import core
    return core.CapacityEngine(cfg, core.Policies(
        flush=core.FlushPolicy(max_events=DAEMON_FLUSH),
        rounding=core.RoundingPolicy(False)))


def host_bits(x):
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
    return np.asarray(x).dtype.str, np.asarray(x).shape, np.asarray(x).tobytes()


def same_flushes(got, want):
    """(flush, field) pairs in which two lists of flush reports differ bit
    for bit: every Solution leaf, the iterations and the mask."""
    from repro_torch.serving.wire import _SOLUTION_FIELDS
    if len(got) != len(want):
        return [("flushes", len(got), len(want))]
    bad = []
    for i, (a, b) in enumerate(zip(got, want)):
        pairs = [(f, getattr(a.fractional, f), getattr(b.fractional, f))
                 for f in _SOLUTION_FIELDS]
        pairs += [("iters", a.iters, b.iters), ("mask", a.mask, b.mask)]
        bad += [(i, f) for f, x, y in pairs if host_bits(x) != host_bits(y)]
    return bad


async def client_open_loop(client, schedule):
    """Offer a timed schedule over the wire open-loop (each offer at its
    scheduled offset, its latency measured from there), drain, and wait for
    every ticket's covering flush."""
    import asyncio
    t0 = time.perf_counter()
    tickets = []
    for t_off, tenant, event in schedule:
        delay = (t0 + t_off) - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        tickets.append(client.offer(tenant, event, t_submit=t0 + t_off))
    await client.drain()
    for tk in tickets:
        await tk.result()
    return tickets, time.perf_counter() - t0


def daemon_run(counters, cfg, lanes, schedule, kernel, wire=False):
    """One open-loop run of the daemon: in process, or behind an
    ``AllocServer`` driven by an ``AllocClient`` over loopback TCP (the
    tenants resident on the engine's mesh; frames up to DAEMON_FRAME
    bytes, as a flush report of 64 lanes at width 512 outgrows the default
    1 MiB).  Every count is set to 0 just before the schedule starts and
    read just after.  Returns the reports by tenant and the run's
    numbers."""
    import asyncio
    from repro_torch import core
    from repro_torch.serving import (AllocClient, AllocDaemon, AllocServer,
                                     drive_open_loop)

    async def run():
        engine = daemon_engine(cfg)
        daemon = AllocDaemon(engine, queue_limit=DAEMON_QUEUE)
        if not wire:
            for name, lns in lanes.items():
                daemon.add_tenant(name, core.AdmissionWindow(
                    lns, n_max=WIN_N_MAX))
            await daemon.start()
            for k in counters:
                k.launches = 0
            t0 = time.perf_counter()
            tickets = await drive_open_loop(daemon, schedule)
            await daemon.shutdown(drain=True)
            wall = time.perf_counter() - t0
            lat = [tk.t_done - tk.t_submit for tk in tickets]
            return ({n: list(daemon.reports(n)) for n in lanes}, lat, wall,
                    daemon, None, tickets)
        server = AllocServer(daemon, max_frame=DAEMON_FRAME)
        await server.start()
        client = await AllocClient.connect(*server.address,
                                           max_frame=DAEMON_FRAME)
        for name, lns in lanes.items():
            await client.register_tenant(name, lns, n_max=WIN_N_MAX)
        resident = all(daemon._tenants[n].session.window.is_resident
                       for n in lanes)
        for k in counters:
            k.launches = 0
        tickets, wall = await client_open_loop(client, schedule)
        got = {n: list(client.reports(n)) for n in lanes}
        daemon_side = {n: list(daemon.reports(n)) for n in lanes}
        await client.close()
        await server.close()
        lat = [tk.t_done - tk.t_submit for tk in tickets]
        return got, lat, wall, daemon, (daemon_side, resident), tickets

    got, lat, wall, daemon, extra, tickets = asyncio.run(run())
    launches = kernel.launches
    others = {k.__name__: k.launches for k in counters
              if k is not kernel and k.launches}
    if others:
        raise AssertionError(f"phase 9: another kernel launched: {others}")
    rep = daemon.report()
    lat = np.asarray(lat) * 1e3
    steps = sum(int(resolved_iters(r).max()) if r.resolved.any() else 0
                for n in lanes for r in daemon.reports(n))
    return types.SimpleNamespace(
        reports=got, launches=launches, steps=steps, report=rep,
        wall=wall, p50=float(np.percentile(lat, 50)),
        p99=float(np.percentile(lat, 99)), extra=extra,
        accepted=[tk.accepted for tk in tickets])


def phase_daemon(counters):
    """Phase 9: the admission daemon at DAEMON_TENANTS tenants of
    DAEMON_LANES lanes, under the fused configuration, open loop at
    DAEMON_RATE events/s on a Poisson and then a flash-crowd schedule, in
    process and over loopback TCP (tenants resident on a 1-device mesh):
    every tenant's flushes bit for bit an offline replay, the wire's bit for
    bit the in-process ones, no rejection, one launch a loop step; then the
    launcher with ``--conformance``."""
    from repro_torch import core
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_iter.ops import make_fused_iter_fn
    from repro_torch.launch import allocd as allocd_cli
    from repro_torch.serving import interleave_traces
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    lanes, traces = daemon_tenants()
    total = sum(len(t) for t in traces.values())
    print(f"phase 9: the admission daemon, {DAEMON_TENANTS} tenants of "
          f"{DAEMON_LANES} lanes (n_max {WIN_N_MAX}), {DAEMON_EVENTS} events "
          f"each, flushes of {DAEMON_FLUSH}, fused, open loop at "
          f"{DAEMON_RATE} events/s")
    cfg = core.SolverConfig(iter_fn=make_fused_iter_fn())
    resident = dataclasses.replace(
        cfg, mesh=core.lane_mesh(devices=["cuda:0"]), residency="resident")
    offline = {n: list(daemon_engine(cfg).open_window(core.AdmissionWindow(
        lanes[n], n_max=WIN_N_MAX)).stream(traces[n])) for n in lanes}
    schedules = {
        "poisson": core.poisson_times(SEED, total, DAEMON_RATE),
        "flash": core.flash_crowd_times(SEED, total, DAEMON_RATE)}
    runs, launches = {}, 0
    for arrival, times in schedules.items():
        schedule = interleave_traces(traces, times)
        for where in ("in process", "over TCP"):
            wire = where == "over TCP"
            run = daemon_run(counters, resident if wire else cfg, lanes,
                             schedule, fused_iter_sweep, wire=wire)
            bad = {n: same_flushes(run.reports[n], offline[n])
                   for n in lanes}
            bad = {n: b[:4] for n, b in bad.items() if b}
            if wire:
                daemon_side, all_resident = run.extra
                inproc = runs[(arrival, "in process")]
                for n in lanes:
                    for label, got, want in (
                            ("daemon side", daemon_side[n], offline[n]),
                            ("against in process", run.reports[n],
                             inproc.reports[n])):
                        diff = same_flushes(got, want)
                        if diff:
                            bad[f"{n} ({label})"] = diff[:4]
                if not all_resident:
                    bad["residency"] = "a tenant is not resident"
            rep = run.report
            launches += run.launches
            print(f"  {arrival} {where}: {rep['events_folded']:.0f} events "
                  f"in {run.wall!r} s, {total / run.wall!r} events/s, "
                  f"admission p50 {run.p50!r} ms / p99 {run.p99!r} ms, "
                  f"{rep['flushes']:.0f} flushes, {run.launches} "
                  f"fused_iter_sweep launches for {run.steps} loop steps, "
                  f"{rep['rejected']:.0f} rejected; differs from the "
                  f"offline replay in {bad or 'nothing'}")
            if bad or rep["rejected"] or not all(run.accepted) or (
                    run.launches != run.steps) or (
                    rep["events_folded"] != total):
                raise AssertionError(f"phase 9 {arrival} {where}: {bad}; "
                                     f"{run.launches} launches for "
                                     f"{run.steps} steps; {rep}")
            runs[(arrival, where)] = run

    session = daemon_engine(cfg).open_window(core.AdmissionWindow(
        lanes["tenant-0"], n_max=WIN_N_MAX))
    session.solve()
    for ev in traces["tenant-0"][:DAEMON_FLUSH]:
        session.offer(ev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle, busy = report_idle(prof, wall, f"one flush of {DAEMON_FLUSH} "
                             f"events on {DAEMON_LANES} lanes", rows=4)
    t0 = time.perf_counter()
    rep = allocd_cli.main(["--tenants", "2", "--lanes", "4", "--classes",
                           "64", "--events", "24", "--arrival", "flash",
                           "--conformance"])
    if rep["rejected"] or rep["events_folded"] != 48:
        raise AssertionError(f"phase 9: the launcher's run: {rep}")
    print(f"  repro_torch.launch.allocd.main --conformance on the card: "
          f"{time.perf_counter() - t0!r} s")
    took = time.perf_counter() - t_phase
    print(f"  phase 9: {launches} fused_iter_sweep launches; {took!r} s")
    return {"launches": launches, "seconds": took, "idle": idle,
            "busy": busy, "runs": {f"{a} {w}": {
                "events_per_s": total / r.wall, "p50_ms": r.p50,
                "p99_ms": r.p99, "flushes": r.report["flushes"],
                "launches": r.launches} for (a, w), r in runs.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on an "
              "NVIDIA card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_sweep.kernel import (rm_sweep,
                                                       rm_sweep_batched)
    from repro_torch.kernels.rwkv6.kernel import wkv6
    t_start = t0 = time.perf_counter()
    logs = _build.build(["gnep_sweep", "gnep_iter", "flash_attention",
                         "wkv6"])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")
    counters = (fused_iter_sweep, rm_sweep_batched, rm_sweep,
                flash_attention, wkv6)

    def timed(label, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"[{label}: {time.perf_counter() - t0:.2f} s]")
        return out

    gen = torch.Generator().manual_seed(SEED)
    ns = torch.randint(MAIN_N_LO, MAIN_N_MAX + 1, (MAIN_B,), generator=gen)
    main_batch = sample_batch(gen, ns.tolist(), MAIN_N_MAX)
    small = sample_batch(gen, SMALL_NS, max(SMALL_NS))

    rows = timed("phase 1", phase_kernels, main_batch, small)
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows["flash_attention"] = timed("phase 1b", phase_flash, cuda_gen)
    rows["wkv6"] = timed("phase 1c", phase_wkv, cuda_gen)
    timed("phase 1d", phase_dot, cuda_gen)
    configs, counts, reports = timed("phase 2", phase_main, main_batch, gen,
                                     counters)
    timed("phase 2 reference", phase_reference, gen)
    timed("phase 3", phase_pinned, gen)
    timed("phase 4", phase_timing, main_batch, configs)
    serving = {arch: timed(f"phase 5 {arch}", phase_serving, arch, counters)
               for arch in SERVE_ARCHS}
    counts["flash_attention"] = serving["qwen3-0.6b"]["counts"][
        "flash_attention"]
    counts["wkv6"] = serving["rwkv6-7b"]["counts"]["wkv6"]
    window = timed("phase 6", phase_window, counters)
    by_path = {name: {"phase 2": n} for name, n in counts.items()
               if name in ALLOCATOR_KERNELS}
    shards = timed("phase 7", phase_shards, main_batch, configs, reports,
                   window, counters)
    plan = timed("phase 8", phase_plan, counters)
    daemon = timed("phase 9", phase_daemon, counters)
    for name, session in (("fused_iter_sweep", "fused"),
                          ("rm_sweep_batched", "sweep")):
        by_path[name]["phase 6"] = window[session]["launches"]
        by_path[name]["phase 7"] = shards["launches"][name]
        by_path[name]["phase 8"] = plan["launches"][session]
        counts[name] += (window[session]["launches"]
                         + shards["launches"][name]
                         + plan["launches"][session])
    by_path["fused_iter_sweep"]["phase 9"] = daemon["launches"]
    counts["fused_iter_sweep"] += daemon["launches"]
    for arch, res in serving.items():
        print(f"  serving {arch}: f32 decode-vs-forward "
              f"{res.get('f32_rel')!r} prefill_s={res['prefill_s']!r} "
              f"decode_tok_s={res['decode_tok_s']!r} "
              f"idle_share={res['idle']!r} (profiled), "
              f"{res['idle_warm']!r} (against the unprofiled run)")
    print(f"total: {time.perf_counter() - t_start:.2f} s")

    for row in rows.values():
        row["launches"] = counts[row["name"]]
        if row["name"] in by_path:
            row["launches_by_path"] = by_path[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card_line())
    # the contract's keys first, then a row's own (rm_sweep's stream times)
    print(json.dumps({"kernels": [{**{k: row[k] for k in keys}, **row}
                                  for row in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
