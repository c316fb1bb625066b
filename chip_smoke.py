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
   the same function, that call's time (flash attention at every serving
   model's prefill shape: Qwen3-0.6B, DeepSeekMoE-16B, Jamba's 32 / 8
   heads, Qwen2-VL's 28 / 4, Whisper's non-causal encoder over 1,500
   frames and its causal decoder; its f32 route ``flash_fwd_tf32`` and its
   bf16 route at head width 32, each case on its route, twice bit for bit,
   an f32 view off 16-byte alignment bit for bit its contiguous copy, and
   misaligned bf16 views refused); ``wkv6`` on each of its three routes,
   every case timed (CUDA events, a CUDA graph), every case whose chunk is
   no multiple of 64 beside the per-head kernel on the same inputs, both
   held to the plain version (RWKV6-7B's prompts of 50,000 and 48,000
   tokens, chunks 10 and 375, too); and ``layers.dot``
   and ``layers.bmm`` on bf16 operands against the f32 product;
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
   ``python -m repro_torch.launch.serve`` drives it) for Qwen3-0.6B,
   RWKV6-7B, DeepSeekMoE-16B, Qwen2-VL-7B and Whisper-base at full width
   and depth and Jamba-v0.1-52B at full width and 8 layers (one
   super-block), random weights from a seed: batch 4, prompt 1024 (and
   Whisper's 1,500 encoder frames), 16 new tokens, greedy.  Every kernel's
   launch count is read around each generate (one flash launch a
   self-attention layer, the encoder's included); tokens, logits and the
   last decode step against a forward pass over the prompt and the
   generated tokens are checked; prefill seconds, decode tokens/s, peak
   memory and the device's idle share are printed.  RWKV6-7B also serves
   prompts of 1,000 and 1,023 tokens (chunks 8 and 1: one tile-parallel
   wkv6 launch a layer) and, at batch 1, of 50,000 and 48,000 tokens
   (chunks 10 and 375: tile- and chunk-parallel), their prefill seconds
   beside the 1,024 prompt's and beside the per-head kernel's.
   The MoE models
   (DeepSeekMoE, Jamba) also gate (b) a second generate bit for bit the
   first and (d) at a drop-free capacity factor the last decode step
   against a forward whose routing is pinned to the generate's (bf16);
   DeepSeekMoE (c) one full-width MoE layer in f32 at 4,096 tokens against
   ``moe_dense_ref``, drop-free and, at the capacity factor 1.25, with the
   dropped pairs' gates zeroed, and (d) unpinned in f32 at 4 layers;
   Jamba (c) one full-width ``mamba_mixer`` in f32 at 4,096 tokens and a
   decode step after it against the sequential recurrence, and (d) pinned
   in f32 at 5 layers (Mamba, MoE and attention).  Qwen2-VL gates (c)
   ``apply_mrope`` with equal streams bit for bit ``apply_rope`` and an
   ``embeds`` prefill bit for bit the tokens prefill, and (d) an image
   prefill (120 text tokens, 28 x 28 patches, 120 text tokens) on its
   M-RoPE positions, one flash launch a layer, 15 decode steps after it,
   and ``apply_mrope`` against its f64 evaluation.  Whisper gates (a) its
   flash launches (6 non-causal over the frames, 6 causal) and (b) a
   cross cache that ``pad_attn_cache`` does not pad and decode steps do
   not change;
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
10. the fleet simulator (``repro_torch.cluster``) at the paper's Sec. 5.3
   scale, 256 fleets of 100-500 tenants from a numpy seed: (a)
   ``epoch_batch`` under the default and the sweep configurations equal
   (chips, h, iterations; totals within 1e-9), one launch a loop step, and
   the sweep kernel held to its plain version on one epoch's batch as the
   loop sees it; (b) 8 fleets' ``epoch()`` equal to their lanes; (c)
   ``epoch_batch`` on a 3-shard lane mesh bit for bit the unsharded one;
   (d) ``fail_nodes`` / ``restore_nodes`` / ``mark_straggler`` on one
   fleet, and ``InfeasibleError`` where the reference raises it; (e)
   ``epoch_stream`` over 16 epochs of the reference's event mix in both
   configurations, compacting, its last epoch equal to a fresh
   ``epoch_batch``, and a duplicate tenant refused; walls, epochs/s and
   one sweep epoch's idle share are printed;
11. the training path (``repro_torch.models.loss_fn``,
   ``repro_torch.launch.steps``, ``repro_torch.optim``): (a) the chunked
   loss of Qwen3-0.6B at full width and depth (bf16, 4 x 1,024 tokens, 8
   chunks) under no_grad, with and without a mask of a quarter of the
   positions, within 1e-5 of an unchunked f32 cross entropy over
   ``forward``'s logits, one flash launch a layer in each pass; (b) the
   backward kernels against their plain versions: flash's dq, dk, dv at
   every serving prefill shape (bf16), the Qwen3 shape in f32 and a ragged
   head-width-32 shape in both dtypes, against autograd of
   ``ref.reference`` and against ``ref.backward`` fed the kernel's own
   logsumexp (itself held to ``ref.forward_lse``); ``wkv6``'s six
   gradients against autograd of ``wkv_chunked`` at the RWKV6-7B prefill
   and train shapes (chunk 256), chunks 1-32 at T = 992-1,040, 4 at T =
   300, the chunks that neither divide 64 nor are multiples of it (3, 10,
   48, 63 on m-row tiles, 65, 96, 375 with a ragged last sub-tile, K 32 at
   10 and 96) and RWKV6-7B's 50,000- and 48,000-token lengths at batch 1
   (chunks 10 and 375), from a state, with a final-state cotangent and at
   decays that saturate the clips, each case's backward on its forward's
   route (chunks of 64 and more chunk-parallel, the rest tile-parallel),
   and at the train shape and every case whose chunk is below 64 or no
   multiple of it the backward from the forward's saved scratch, each pass
   alone and the per-head backward on the same inputs (held, timed, each
   one's peak); a misaligned dy on the per-head route; each backward twice
   bit for bit, one backward launch a call, and its ms (CUDA events and a
   CUDA graph), bound, autograd's of the plain version and (flash)
   autograd's of SDPA; (c) RWKV6-7B at
   full width and 2 layers (B 2, T 256: the plain recurrence),
   ``make_train_step`` with 2 microbatches: remat none / dots / full with
   the loss bit for bit and the gradients within one bf16 ULP, the
   accumulated gradient against the
   microbatches' mean, 8 steps of each state tier (f32, bf16, int8) on one
   batch with a falling loss and no kernel launch, step ms, tokens/s and
   peak memory printed; (d) one AdamW update of each tier on the card
   against the CPU's (layer 0); (e) train steps through both directions
   of the kernels (2 microbatches, remat full, the f32 tier, 4 steps on
   one batch): Qwen3-0.6B at full width and depth (B 4 x T 1,024) and
   RWKV6-7B at full width and 2 layers (B 2 x T 1,024, chunk 256), each
   with exact forward and backward launch counts, a falling loss, remat
   none and full bit for bit on one microbatch, step ms, tokens/s, peak
   memory and one step's idle share; RWKV6-7B's grad step (2 layers) at B
   2 x T 1,023 and at B 1 x T 50,000 and 48,000 (chunks 1, 10 and 375)
   against the same step with the backward forced per-head: the loss bit
   for bit, every leaf within 2^-5 of its largest |g|, walls and peaks; and
   the reduced f32 configurations of both (head widths 32 and 16) at B 2 x
   T 512, a grad step on the card within 1e-4 of each leaf's largest |g|
   of the CPU's;
12. the training launcher (``repro_torch.launch.train.main``, as ``python
   -m repro_torch.launch.train`` drives it) at Qwen3-0.6B's full width and
   depth, B 4 x T 1,024 in 2 microbatches, remat full, the f32 state tier:
   run A trains 4 steps with a checkpoint every 2 (``save_async``, then
   the final ``save``), run B resumes from a directory that holds only A's
   step 2 (A's step 4 hashed and deleted first: at most two checkpoints of
   8.3 GB on disk).  Gates: B's losses A's last two bit for bit, B's step
   4 files (manifest and every leaf) A's by sha1, and exact flash forward
   and backward launches over the six steps.  Free disk, the checkpoint's
   bytes, each host layout, snapshot, writer-thread save, restore and step
   in seconds, and each run's peak memory are printed;
13. the ``kernels`` line, whose launch counts add phases 2, 5 (per model),
   6-10, 11 (a) and (e), 12, 14 and 15 (the backward kernels: phases 11
   (e), 12, 14 and 15; the forward's f32 route ``flash_fwd_tf32``, its own
   row: phase 11 (e)'s reduced steps, the only f32 attention on the path;
   phases 11 (a), 12 and 14 show by ``route_launches`` that their bf16
   forwards ran the wgmma route); the meta costings of phase 15 launch
   nothing;
14. distribution on the port's mesh layout (``repro_torch.models.sharding``:
   a mesh repeats the card, every tensor lies whole on it), run after
   phase 12: (a) ``launch.train.main --mesh 1,1 --device cuda`` resumed
   from phase 12's step 2 through ``restore(shardings=...)``: its losses
   and step 4 files bit for bit phase 12's run B, exact flash launches,
   step ms beside run B's; (b) Qwen3-0.6B on a (1, 16) mesh, whose tp of
   16 above its 8 kv heads runs the GQA repeat and the sequence-sharded
   decode: ``forward`` with one flash launch a layer at 16 kv heads
   against ``LOCAL``'s logits (bit for bit, or within phase 5's 5e-2),
   ``generate(dist=...)`` against phase 5's generate (logits within 5e-2
   up to the first differing token, which must be a near tie), and one
   ``jit_train_step`` on a (2, 2) mesh bit for bit a ``LOCAL`` step; (c)
   DeepSeekMoE-16B at full width and 4 layers on a (2, 4) mesh: one f32
   MoE layer drop-free against ``moe_dense_ref`` and, at capacity factor
   1.25, bit for bit the data-parallel ranks' ``LOCAL`` bodies and within
   1e-4 of the oracle with each rank's overflow zeroed; a bf16 forward, a
   train step (bf16 tier) and a generate bit for bit the (2, 1) mesh's.
   Peak memory of each case is printed;
15. the dry run (``repro_torch.launch.dryrun``), run after phase 14: (a)
   ``dryrun.main(["--all"])`` in process (a cell a worker process, one
   worker a CPU core) into ``chiprun_out/dryrun``: every cell of the 10
   architectures x 4 shapes costed on meta tensors on the 16 x 16 mesh, 32
   ok, 8 skipped, none failed, each cell's bottleneck, compute and memory
   terms on the H100's peaks, useful ratio and global peak GB, and the
   sweep's wall; (b) Qwen3-0.6B's train step at phase 11 (e)'s shape and
   RWKV6-7B's prefill at phase 5's costed on meta, then run on the card
   under the same counting mode (``analysis.StepCounter``): FLOPs and bytes
   equal, the card's memory growth over the step within 0.5 % of the
   tracker's, exact launches, and the roofline share (the bound over the
   median of 5 runs) at most 1.05, printed with the card's name and power
   limit.

The last line is ``{"ok": true, "device": {...}}``.  Without a card, or
without the repository's ``src/`` beside it, the script fails before
printing any result.
"""
import contextlib
import dataclasses
import io
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

# the serving path: every family at full width, and at full depth except
# Jamba, served at one super-block of 8 layers (26.6 GB in bf16; its 32
# layers, 104 GB, do not fit the card, and at 8 its f32 scan tensors, 2.1
# GB each at the prompt, leave room for the forward check)
SERVE_ARCHS = ("qwen3-0.6b", "rwkv6-7b", "deepseek-moe-16b",
               "jamba-v0.1-52b", "qwen2-vl-7b", "whisper-base")
SERVE_DEPTH = {"jamba-v0.1-52b": 8}
# Whisper's encoder input: 1,500 frames, its 30-second window after the
# conv stem that the configuration stubs
WHISPER_FRAMES = 1500
# Jamba's f32 decode-vs-forward check: 5 layers of full width hold Mamba
# (0-3), MoE (1, 3) and the attention layer (4); 8 f32 layers (53 GB) do
# not fit beside the drop-free forward
JAMBA_F32_LAYERS = 5
# Qwen2-VL's image prefill: 120 text tokens, a 28 x 28 grid of patch
# embeddings (a 392 x 392 image after the 2 x 2 merge), 120 text tokens;
# then 15 decode steps from its cache
VL_TEXT, VL_GRID, VL_STEPS = 120, 28, 15
# DeepSeekMoE-16B: one full-width MoE layer in f32 at 4 x 1024 tokens
# against moe_dense_ref, and the f32 decode-vs-forward check at 4 layers (1
# dense + 3 MoE; 28 f32 layers do not fit the card beside their caches)
MOE_LAYER_SHAPE, MOE_F32_LAYERS = (4, 1024), 4
SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 1024, 16
# RWKV's decode-vs-forward check runs at a prompt of 1040 (chunk 16): at
# 1024 the model's chunk rule picks 256, where the reference's chunked form
# departs from the exact recurrence (ROADMAP Queue 3), so a prefill and a
# forward over a longer sequence compute different functions there
RWKV_AGREE_PROMPT = 1040
# RWKV6-7B's prompts (batch, length) whose chunk is no multiple of 64,
# served beside the 1,024 prompt for their prefill: 1,000 and 1,023 (chunks
# 8 and 1: the tile-parallel route); at batch 1 (at 50,000 tokens a batch
# of 4's f32 prefill logits alone would take 52 GB) 50,000 (chunk 10: tiles
# of 60 rows) and 48,000 (chunk 375: chunk-parallel, a last sub-tile of 55
# rows)
RWKV_RAGGED_PROMPTS = ((SERVE_B, 1000), (SERVE_B, 1023), (1, 50000),
                       (1, 48000))
# flash attention: the Qwen3-0.6B prefill, then a ragged shape (bf16 runs
# the wgmma kernel, f32 the split-TF32 one)
FLASH_MAIN = (4, 1024, 16, 8, 128)           # B, S, Hq, Hkv, hd
FLASH_RAGGED = (2, 200, 6, 3, 64)
# every serving model's prefill self-attention (causal, except Whisper's
# encoder over 1,500 frames, ragged against the 128-row tile), each timed
FLASH_MODELS = (("qwen3-0.6b", FLASH_MAIN, True),
                ("deepseek-moe-16b", (4, 1024, 16, 16, 128), True),
                ("jamba-v0.1-52b", (4, 1024, 32, 8, 128), True),
                ("qwen2-vl-7b", (4, 1024, 28, 4, 128), True),
                ("whisper-base encoder", (4, 1500, 8, 8, 64), False),
                ("whisper-base decoder", (4, 1024, 8, 8, 64), True))
# WKV6: (B, T, H, K, chunk, decay shift, with S0); the RWKV6-7B prefill
# (chunk 256: chunk-parallel); RWKV6-7B's prompts of 1,023, 1,000, 1,040 and
# 992 tokens (chunks 1, 8, 16, 32: tile-parallel, each with a ragged last
# tile of 63, 40, 16 and 32 rows), a chunk-4 case whose cumulative decays
# pass the +-30 clamp, from zeros and from a state, K = V = 32 at chunk 8
# from a state, and whole tiles only (tile-parallel); chunks that neither
# divide 64 nor are multiples of it: below 64 on tiles of whole chunks (10:
# tiles of 60 rows, the last 20; 3: 63, the last 60, from a state; 48 and
# 63: one chunk a tile, 63 where the clip binds), above it chunk-parallel
# with a ragged last sub-tile (65: 1 row; 96: 32; 375: 55, from a state),
# and K = V = 32 at 10 and 96 from a state; then the chunk-parallel
# kernels' prefix from a state, chunk 128, a single chunk and K = V = 32
WKV_CASES = ((4, 1024, 64, 64, 256, -0.6, False),
             (4, 1023, 64, 64, 1, -0.6, False),
             (4, 1000, 64, 64, 8, -0.6, False),
             (4, 1040, 64, 64, 16, -0.6, False),
             (4, 992, 64, 64, 32, -0.6, False),
             (2, 300, 4, 64, 4, 2.0, False),
             (2, 300, 4, 64, 4, 2.0, True),
             (2, 520, 4, 32, 8, -0.6, True),
             (2, 256, 4, 64, 16, -0.6, False),
             (2, 500, 4, 64, 10, -0.6, False),
             (2, 501, 4, 64, 3, -0.6, True),
             (2, 480, 4, 64, 48, -0.6, False),
             (2, 630, 4, 64, 63, 2.0, False),
             (2, 650, 4, 64, 65, -0.6, False),
             (2, 960, 4, 64, 96, -0.6, False),
             (1, 750, 4, 64, 375, -0.6, True),
             (2, 520, 4, 32, 10, 2.0, True),
             (2, 480, 4, 32, 96, -0.6, True),
             (4, 1024, 64, 64, 256, -0.6, True),
             (4, 1024, 64, 64, 128, -0.6, False),
             (2, 256, 4, 64, 256, -0.6, False),
             (2, 512, 4, 32, 64, -0.6, False))
# RWKV6-7B's prompts of 50,000 and 48,000 tokens at batch 1 (chunks 10 and
# 375), held to the plain version and to the per-head kernel, which took
# them before
WKV_LONG_CASES = ((1, 50000, 64, 64, 10, -0.6, False),
                  (1, 48000, 64, 64, 375, -0.6, False))
# layers.dot on the card: bf16 (M x D) . (D x N), the Qwen3 MLP's up
# projection at the serving prefill (4 x 1024 tokens, d 1024, d_ff 3072)
DOT_SHAPE = (4096, 1024, 3072)
BMM_SHAPE = (64, 480, 2048, 1408)
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
# the fleet simulator: the paper's Sec. 5.3 scale (256 fleets of 100-500
# tenants), capacity factor 0.95 (Sec. 5.2.1), tenants in the ranges of
# examples/multi_tenant_cluster.py; 8 fleets held to their own epoch(), a
# 3-shard mesh, a 20 % node failure, and a stream of 16 epochs with events
# on a tenth of the fleets each, a fleet arriving and one leaving, opened
# with twice the widest fleet's headroom (n_max 1,024, occupancy about 0.3)
# and compacting below 0.6
FLEET_B, FLEET_N_LO, FLEET_N_HI, FLEET_CF = 256, 100, 500, 0.95
FLEET_TP = (1, 2, 4, 8, 16)
FLEET_ARCHS = (("qwen3-8b", "train_4k"), ("qwen3-32b", "prefill_32k"),
               ("deepseek-moe-16b", "decode_32k"), ("rwkv6-7b", "long_500k"))
FLEET_SAMPLED, FLEET_SHARDS, FLEET_FAIL = 8, 3, 0.2
FLEET_EPOCHS, FLEET_ARRIVE_AT, FLEET_DEPART_AT = 16, 5, 10
FLEET_COMPACT, FLEET_STREAM_N_MAX = 0.6, 1024
# the training path: (a) Qwen3-0.6B at full width and depth, the chunked
# loss (8 chunks) over B x S tokens against an unchunked f32 cross entropy;
# (c) RWKV6-7B at full width cut to 2 layers (0.98 B parameters), whose
# f32-tier state (bf16 weights, f32 gradients and accumulator, f32 m, v
# and master) and the functional update's second copy fit the card (its
# 32 layers, 7.6 B parameters, would not): at T = 256 the model's chunk
# rule gives 256 >= T, so every WKV runs the kernels at chunk 1 (the
# recurrence's function), held to the same step on wkv_recurrent
LOSS_ARCH, LOSS_B, LOSS_S = "qwen3-0.6b", 4, 1024
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_B, TRAIN_T = "rwkv6-7b", 2, 2, 256
TRAIN_ACCUM, TRAIN_STEPS = 2, 8
# (b) the backward kernels: flash at every serving prefill shape (bf16, as
# the models run: the tensor-core route) and the Qwen3 shape in f32, a
# ragged shape at head width 32 in both dtypes (each dtype's route), and
# ragged bf16 shapes at head widths 128 and 64 (the tensor-core route,
# 1,000 rows: no multiple of its 64- or 128-row tiles); wkv6 (B, T, H, K, chunk, decay shift, S0, a
# cotangent on the final state): the RWKV6-7B prefill and train shapes at
# chunk 256 (the chunk-parallel forward and backward); its training
# lengths of 1,023, 1,000, 1,040 and 992 tokens (chunks 1, 8, 16 and 32:
# the tile-parallel routes, each with a ragged last tile of 63, 40, 16 and
# 32 rows), each also through the per-head backward on the same inputs;
# decays that saturate the clips (shift 2.0) at chunk 256 and at chunk 4
# (tile-parallel); the chunks that neither divide 64 nor are multiples of it
# that WKV_CASES runs forward, both ways on the forward's route: below 64
# on m-row tiles (10: 60 rows, the last 20; 3 from a state: 63, the last
# 60; 48, and 63 at shift 2.0: one chunk a tile), above it chunk-parallel
# with a ragged last sub-tile (65: 1 row; 96: 32; 375 from a state: 55), and
# K = V = 32 at 10 and 96; each of the tile-parallel and ragged cases also
# through the per-head backward on the same inputs
FLASH_BWD_RAGGED = (1, 1000, 4, 2, 32)
FLASH_BWD_TC_RAGGED = ((1, 1000, 4, 2, 128), (1, 1000, 4, 4, 64))
# head width 32 where the grid fills the card (the Qwen3-0.6B shape's batch
# and heads), causal, in both dtypes
FLASH_HD32_FULL = (4, 1024, 16, 8, 32)
WKV_BWD_CASES = ((4, 1024, 64, 64, 256, -0.6, False, False),
                 (2, 1024, 64, 64, 256, -0.6, True, True),
                 (2, 1023, 64, 64, 1, -0.6, True, True),
                 (2, 1000, 64, 64, 8, -0.6, True, True),
                 (2, 1040, 64, 64, 16, -0.6, False, True),
                 (2, 992, 64, 64, 32, -0.6, True, True),
                 (2, 512, 8, 64, 256, 2.0, True, True),
                 (2, 300, 4, 64, 4, 2.0, True, True),
                 (2, 500, 4, 64, 10, -0.6, True, True),
                 (2, 501, 4, 64, 3, -0.6, True, True),
                 (2, 480, 4, 64, 48, -0.6, False, True),
                 (2, 630, 4, 64, 63, 2.0, False, True),
                 (2, 650, 4, 64, 65, -0.6, False, True),
                 (2, 960, 4, 64, 96, -0.6, False, True),
                 (1, 750, 4, 64, 375, -0.6, True, True),
                 (2, 520, 4, 32, 10, 2.0, True, True),
                 (2, 480, 4, 32, 96, -0.6, True, True))
# RWKV6-7B's training lengths of 50,000 and 48,000 tokens at batch 1, one
# layer's WKV (chunks 10 and 375: the tile- and chunk-parallel backwards,
# which the per-head one took before), held to autograd of the plain version
# and to the per-head backward, each timed in CUDA graphs beside it, with
# its peak and each pass alone
WKV_BWD_LONG_CASES = ((1, 50000, 64, 64, 10, -0.6, False, True),
                      (1, 48000, 64, 64, 375, -0.6, False, True))
# the kernels of each wkv6_bwd route (csrc/wkv6_bwd.cu): the instances at
# chunks that divide 64 or are multiples of it, then those of the other
# chunks (m-row tiles, a ragged last sub-tile)
WKV_BWD_KERNELS = {
    "chunk-parallel": ["wkv6_bwd_g<false, false>", "wkv6_bwd_prefix<1>",
                       "wkv6_bwd_main<false>", "wkv6_bwd_fixup",
                       "wkv6_bwd_g<false, true>", "wkv6_bwd_main<true>"],
    "tile-parallel": ["wkv6_bwd_g<true, false>", "wkv6_bwd_prefix<8>",
                      "wkv6_bwd_tile_walk<true>", "wkv6_bwd_tile<true>",
                      "wkv6_bwd_tile_du", "wkv6_bwd_tile_walk<false>",
                      "wkv6_bwd_tile<false>"],
    "per-head": ["wkv6_bwd_states", "wkv6_bwd"]}
WKV_BWD_MAIN = (2, 1024, 64, 64, 256)
# (e) train steps through both directions of the kernels, 2 microbatches,
# remat full, the f32 state tier, on one batch: Qwen3-0.6B at full width
# and depth, B 4 x T 1,024; RWKV6-7B at full width and TRAIN_LAYERS layers
# (the cut of (c)), B 2 x T 1,024 (chunk 256 < T: the chunk-parallel
# forward and backward) and B 2 x T 1,023 (chunk 1: the tile-parallel
# ones); then RWKV6-7B's grad step (one microbatch, the same cut) at B 2 x T
# 1,023 and at B 1 x T 50,000 (chunk 10: tile-parallel both ways) and T
# 48,000 (chunk 375: chunk-parallel both ways), each against the same grad
# step with the backward on the per-head route; then the two reduced
# configurations (f32) at B 2 x T 512, a grad step on the card against the
# CPU's
KERNEL_TRAIN = (("qwen3-0.6b", None, 4, 1024),
                ("rwkv6-7b", TRAIN_LAYERS, 2, 1024),
                ("rwkv6-7b", TRAIN_LAYERS, 2, 1023))
# (B, T, the backward's route)
STEP_VS_PER_HEAD = ((TRAIN_B, 1023, "tile-parallel"),
                    (1, 50000, "tile-parallel"),
                    (1, 48000, "chunk-parallel"))
KERNEL_TRAIN_STEPS, REDUCED_B, REDUCED_T = 4, 2, 512
# the training launcher (phase 12): ``repro_torch.launch.train.main`` on
# Qwen3-0.6B at full width and depth (remat full, f32 state tier), B 4 x T
# 1,024 in 2 microbatches, 4 steps with a checkpoint every 2; then a run
# resumed from the first run's step 2.  A checkpoint is about 8.3 GB (596 M
# parameters x 2 bytes of bf16 weight and 12 of f32 m, v and master); a
# final save writes its temporary beside two kept steps, so the phase needs
# room for three
LAUNCH_ARCH, LAUNCH_STEPS, LAUNCH_RESUME = "qwen3-0.6b", 4, 2
LAUNCH_ARGS = ["--arch", LAUNCH_ARCH, "--steps", str(LAUNCH_STEPS),
               "--global-batch", "4", "--seq", "1024", "--grad-accum", "2",
               "--ckpt-every", "2", "--log-every", "1", "--device", "cuda"]
LAUNCH_FREE_GB = 30
# the distribution phase (14): (a) the launcher under --mesh 1,1, resumed
# from phase 12's step 2; (b) Qwen3-0.6B on a (1, 16) mesh of the repeated
# card, whose tp of 16 above its 8 kv heads runs the GQA repeat (flash at
# Hkv 16) and the sequence-sharded decode, and a train step on a (2, 2)
# mesh; (c) DeepSeekMoE-16B at full width cut to 4 layers (1 dense + 3 MoE;
# its 28 layers serve in phase 5) on a (2, 4) mesh against (2, 1), its
# train step at B 2 x T 512 in the bf16 state tier (2.3 B parameters: the
# f32 tier's state and the update's second copy would not fit beside a
# second step's)
AXES = ("data", "model")
DIST_DENSE_ARCH, DIST_DENSE_MESH = "qwen3-0.6b", (1, 16)
DIST_TRAIN_MESH = (2, 2)
DIST_MOE_ARCH, DIST_MOE_LAYERS = "deepseek-moe-16b", 4
DIST_MOE_MESH, DIST_MOE_TP1, DIST_MOE_TRAIN = (2, 4), (2, 1), (2, 512)
STEP_BUILDERS = ("make_train_step", "jit_train_step")
# the dry run (phase 15): ``repro_torch.launch.dryrun --all`` on meta
# tensors, a cell a worker process, one worker a CPU core; then two steps
# costed on meta and run on the card under the same counting mode:
# Qwen3-0.6B's train step at phase 11 (e)'s shape (B 4 x T 1,024, 2
# microbatches, remat full, the f32 tier; per run 2 x 28 x 2 flash forwards
# and 2 x 28 backwards) and RWKV6-7B's prefill at phase 5's (B 4 x 1,024,
# chunk 256: 32 wkv6 launches a run)
DRYRUN_CELLS = {"ok": 32, "skipped": 8}
HELD_TRAIN = ("qwen3-0.6b", 4, 1024, 2)
HELD_PREFILL = ("rwkv6-7b", 4, 1024)
HELD_RUNS = 5        # timed runs of a held step: their median
# the card's growth over a held step against the tracker's: the tracker
# sees every storage an operator returns, but not the scratch a kernel's
# wrapper allocates and frees inside its operator (flash's backward: 512
# bytes a 64-row query tile a head; wkv6's backward: its own passes') nor
# the caching allocator's 512-byte blocks; 0.02 % on the probe's card run
HELD_PEAK_RTOL = 5e-3
# a roofline share above 1 would mean a count is short
HELD_SHARE_MAX = 1.05


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


def peaks():
    """``repro_torch.launch.analysis`` (``src`` on the path): the H100 SXM
    data sheet's HBM3 bandwidth, FP64 and FP32 (non-tensor-core) rates and
    dense TF32 and bf16 tensor-core rates, and the model kernels' operation
    counts, so the kernel table's bounds and the dry run share one count."""
    from repro_torch.launch import analysis
    return analysis


def bound(nbytes, ops, ops_per_s=None):
    """(ms, 'bytes' | 'operations'): the least time for the work on the card
    (at the FP64 rate unless ``ops_per_s`` is given)."""
    ops_per_s = ops_per_s or peaks().FP64_FLOPS
    t_bytes = nbytes / peaks().HBM_BW * 1e3
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
    rate = (peaks().FP64_FLOPS if args[0].dtype == F64
            else peaks().FP32_FLOPS) / 2
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
                        + 2 * B * Nc * 4, 8 * B * Nc * N, peaks().FP32_FLOPS)
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
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import reference
    flash_attention = fk.flash_attention
    print("phase 1b: flash_attention against its plain version")
    errs, cases_row = [], {}
    # bf16: both sides round the same f32 result to bf16 once, and two
    # roundings of nearly equal values differ by at most one bf16 spacing
    # (2^-7 of the value); f32: the same sums in another order, with the
    # online softmax's rescaling, within 1e-4 relative.
    bf16, f32 = (torch.bfloat16, 1e-5, 2.0 ** -7), (torch.float32, 1e-5, 1e-4)
    timed = {(shape, causal): label for label, shape, causal in FLASH_MODELS}
    timed[(FLASH_MAIN, False)] = None          # timed, not a serving shape
    cases = [(shape, causal, *bf16) for _, shape, causal in FLASH_MODELS] + [
        (FLASH_RAGGED, c, *f32) for c in (True, False)] + [
        (FLASH_MAIN, False, *bf16)] + [
        (FLASH_RAGGED, c, *bf16) for c in (True, False)]
    for shape, causal, dtype, atol, rtol in cases:
        q, k, v = flash_inputs(gen, *shape, dtype)
        errs.append(check_close(
            flash_attention(q, k, v, causal=causal),
            reference(q, k, v, causal=causal), atol, rtol,
            f"flash_attention {shape} {str(dtype)[6:]} causal={causal}"))
        if dtype != torch.bfloat16 or (shape, causal) not in timed:
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
        ops = peaks().flash_fwd_ops(B, S, S, Hq, hd, causal)
        b_ms, b_by = bound(nbytes(q, k, v, q), ops, peaks().BF16_FLOPS)
        # the kernel's own floor: P V runs twice (P_hi and P_lo)
        split_ms = 1.5 * ops / peaks().BF16_FLOPS * 1e3
        print(f"  flash_attention {shape} causal={causal}: ms={t_k!r} "
              f"plain_ms={t_p!r} library_ms={t_l!r} bound_ms={b_ms!r} "
              f"({b_by}, bf16 tensor-core rate) split_floor_ms={split_ms!r} "
              f"turns={times!r}")
        label = timed[(shape, causal)]
        if label is not None:
            cases_row[label] = dict(shape=shape, causal=causal, ms=t_k,
                                    plain_ms=t_p, library_ms=t_l,
                                    bound_ms=b_ms, bound_by=b_by)
    routes = forward_routes(gen, fk, reference)
    cases_row["routes"] = routes
    errs += [r["max_abs_err"] for r in routes.values()
             if r["route"] == "tensor_cores"]
    check_tma_refusal(flash_attention)
    # the row's own numbers are the first serving shape's, the Qwen3 prefill
    main = cases_row[FLASH_MODELS[0][0]]
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention/kernel.py:71",
               ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=main["library_ms"], max_abs_err=max(errs),
               cases=cases_row)
    # the f32 route's own row: flash_fwd_tf32 at the f32 Qwen3-0.6B shape
    tf32 = routes[f"{FLASH_MAIN} float32"]
    tf32_row = dict(name="flash_fwd_tf32", route="cuda",
                    source="src/repro_torch/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention/kernel.py:71",
                    ms=tf32["ms"], plain_ms=tf32["plain_ms"],
                    bound_ms=tf32["bound_ms"], bound_by=tf32["bound_by"],
                    library_ms=tf32["library_ms"],
                    max_abs_err=max(r["max_abs_err"] for r in routes.values()
                                    if r["route"] == "split_tf32"),
                    graph_ms=tf32["graph_ms"],
                    library_graph_ms=tf32["library_graph_ms"],
                    cases={k: r for k, r in routes.items()
                           if r["route"] == "split_tf32"})
    return row, tf32_row


def forward_routes(gen, fk, reference):
    """The forward's routes redesigned last, ``flash_fwd_tf32`` (f32) and
    ``flash_fwd_wgmma`` at head width 32 (bf16), held to the plain version
    at the phase's gates, two calls bit for bit, one launch a call on the
    route ``kernel.route`` names (``route_launches``), and timed against
    SDPA (events and CUDA graphs, in turns) and the bound: f32 at the
    Qwen3-0.6B shape, both dtypes at the ragged head-width-32 shape and at
    FLASH_HD32_FULL, causal.  Then f32 q, k, v one element into wider
    tensors (no base 16-byte aligned: copies of 4 bytes) give their
    contiguous copies' output bit for bit."""
    flash_attention = fk.flash_attention
    rows = {}
    for shape, dtype in ((FLASH_MAIN, torch.float32),
                         (FLASH_BWD_RAGGED, torch.float32),
                         (FLASH_BWD_RAGGED, torch.bfloat16),
                         (FLASH_HD32_FULL, torch.float32),
                         (FLASH_HD32_FULL, torch.bfloat16)):
        B, S, Hq, Hkv, hd = shape
        q, k, v = flash_inputs(gen, *shape, dtype)
        route = fk.route(q)
        label = f"flash_attention {shape} {str(dtype)[6:]} causal=True"
        if route != ("tensor_cores" if dtype == torch.bfloat16
                     else "split_tf32"):
            raise AssertionError(f"{label}: not the dtype's route")
        n0 = dict(flash_attention.route_launches)
        got = flash_attention(q, k, v, causal=True)
        moved = {r: n - n0[r]
                 for r, n in flash_attention.route_launches.items()}
        if moved != {r: int(r == route) for r in moved}:
            raise AssertionError(f"{label}: launches by route {moved}, "
                                 f"expected one on {route}")
        if not bitwise(got, flash_attention(q, k, v, causal=True)):
            raise AssertionError(f"{label}: two calls differ")
        rt = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
        err = check_close(got, reference(q, k, v, causal=True), 1e-5, rt,
                          f"{label} route={route}")
        fns = {"kernel": (lambda: flash_attention(q, k, v, causal=True), 20),
               "library": (lambda: sdpa(q, k, v, True), 20),
               "plain": (lambda: reference(q, k, v, causal=True), 5)}
        times = {name: [] for name in fns}
        for name in ("kernel", "library", "plain", "library", "kernel"):
            fn, reps = fns[name]
            times[name].append(cuda_ms(fn, reps))
        t_k, t_l, t_p = (statistics.mean(times[n])
                         for n in ("kernel", "library", "plain"))
        t_kg = graph_ms(fns["kernel"][0], 20)
        t_lg = graph_ms(fns["library"][0], 20)
        ops = peaks().flash_fwd_ops(B, S, S, Hq, hd, True)
        # bf16 at the bf16 tensor-core rate; f32 each product as three TF32
        # products, as the backward's f32 bound counts them
        rate = (peaks().BF16_FLOPS if dtype == torch.bfloat16
                else peaks().TF32_FLOPS / 3)
        b_ms, b_by = bound(nbytes(q, k, v, q), ops, rate)
        print(f"  {label} route={route}: ms={t_k!r} plain_ms={t_p!r} "
              f"library_ms={t_l!r} graph_ms={t_kg!r} library_graph_ms="
              f"{t_lg!r} bound_ms={b_ms!r} ({b_by}) turns={times!r}")
        rows[f"{shape} {str(dtype)[6:]}"] = dict(
            route=route, ms=t_k, plain_ms=t_p, library_ms=t_l, graph_ms=t_kg,
            library_graph_ms=t_lg, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err)
    for shape in (FLASH_BWD_RAGGED, FLASH_MAIN):
        hd = shape[-1]
        q, k, v = flash_inputs(gen, *shape, torch.float32)

        def off(t):
            wide = torch.empty(t.shape[:-1] + (hd + 1,), device="cuda")
            wide[..., 1:] = t
            return wide[..., 1:]
        views = [off(t) for t in (q, k, v)]
        n0 = dict(flash_attention.route_launches)
        got = flash_attention(*views, causal=True)
        moved = {r: n - n0[r]
                 for r, n in flash_attention.route_launches.items()}
        same = bitwise(got, flash_attention(q, k, v, causal=True))
        print(f"  flash_attention {shape} float32 causal=True, q / k / v "
              f"off 16-byte alignment: launches by route {moved}, output "
              f"{'bit for bit' if same else 'DIFFERS from'} the contiguous "
              "copies'")
        if views[0].data_ptr() % 16 == 0 or not same or \
                moved != {r: int(r == "split_tf32") for r in moved}:
            raise AssertionError(f"flash_attention {shape}: misaligned f32 "
                                 "views did not run the split-TF32 route "
                                 "to the contiguous copies' bits")
    return rows


def check_tma_refusal(flash_attention):
    """A bf16 view whose base is not 16-byte aligned (q taken one element
    into the head axis of a wider tensor) is refused before any launch, at
    head width 64 and at 32, with and without grad."""
    for shape in (FLASH_RAGGED, FLASH_BWD_RAGGED):
        B, S, Hq, Hkv, hd = shape
        wide = torch.zeros((B, S, Hq, hd + 8), dtype=torch.bfloat16,
                           device="cuda")
        k = torch.zeros((B, S, Hkv, hd), dtype=torch.bfloat16, device="cuda")
        for grad in (False, True):
            q = wide[..., 1:hd + 1].detach().requires_grad_(grad)
            before = flash_attention.launches
            try:
                flash_attention(q, k, k, causal=True)
            except ValueError as exc:
                print(f"  misaligned q {shape} (grad {grad}) refused: {exc}")
            else:
                raise AssertionError(f"flash_attention {shape} launched on "
                                     "a q view that TMA cannot read")
            if flash_attention.launches != before:
                raise AssertionError("flash_attention counted a refused "
                                     "launch")


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


def wkv_route_of(L):
    """The route ``kernel.route`` must give a WKV_CASES case at chunk L (K ==
    V, a multiple of 4, every operand 16-byte aligned)."""
    return "chunk-parallel" if L >= 64 else "tile-parallel"


def phase_wkv(gen):
    """wkv6 against ``chunked_reference`` at every ``WKV_CASES`` case, each
    case's route asserted, within 1e-4 of max |y| and of max |S|; every
    case timed by CUDA events and in a CUDA graph, beside the plain
    version's ms and the bound, with the chunk- and tile-parallel routes'
    passes alone; at every case whose chunk is no multiple of 64 the
    per-head kernel on the same inputs (``route_launcher``), held and timed
    the same way.  Then the ``WKV_LONG_CASES`` (RWKV6-7B's prompts of
    50,000 and 48,000 tokens), held and timed the same way.  The row's own
    numbers are the first case's (the RWKV6-7B prefill)."""
    from repro_torch.kernels.rwkv6.kernel import (pass_launchers, route,
                                                  route_launcher, wkv6)
    from repro_torch.kernels.rwkv6.ref import chunked_reference, reference
    print("phase 1c: wkv6 against its plain version (the chunked form at "
          "the same chunk)")
    errs, cases = [], {}
    for B, T, H, K, L, shift, with_state in WKV_CASES + WKV_LONG_CASES:
        r, k, v, w, u, S0 = wkv_inputs(gen, B, T, H, K, shift, with_state)
        S0_plain = S0 if with_state else torch.zeros(
            (B, H, K, K), device="cuda")
        how = route(r, k, v, w, L)
        if how != wkv_route_of(L):
            raise AssertionError(f"wkv6 chunk {L} K {K} took the {how} "
                                 "route")
        y, S = wkv6(r, k, v, w, u, chunk=L, S0=S0)
        label = (f"wkv6 B={B} T={T} H={H} K={K} chunk={L} "
                 f"{'S0' if with_state else 'zero state'} route={how}")
        if L % 64:
            # the per-head kernel, which took these chunks before, on the
            # same inputs
            per_head = route_launcher(r, k, v, w, u, chunk=L, how="per-head",
                                      S0=S0)
            y_h, S_h = per_head()
        # the same f32 formula summed in another order (the products in
        # three TF32 parts on the chunk- and tile-parallel routes): within
        # 1e-4 of the largest magnitude of each output.  Its second call is
        # timed, right after the first (the held one) has warmed it: at
        # chunk 10 over 50,000 tokens it walks 5,000 chunks in Python, some
        # 8 s a call, so one call
        plain = lambda: chunked_reference(r, k, v, w, u, S0_plain, chunk=L)
        y_p, S_p = plain()
        plain_ms = cuda_ms(plain, 1, warmup=0)
        tol_y, tol_S = (1e-4 * float(y_p.abs().max()),
                        1e-4 * float(S_p.abs().max()))
        errs.append(max(
            check_close(y, y_p, tol_y, 0.0, label + " y"),
            check_close(S, S_p, tol_S, 0.0, label + " S")))
        if not cases:
            y_rec, _ = reference(r, k, v, w, u, S0_plain)
            dep = float((y - y_rec).abs().max() / y_rec.abs().max())
            print(f"  (not checked) the chunked form at chunk {L} against "
                  f"the exact recurrence: max|diff|/max|y| = {dep!r}; the "
                  "kernel and its plain version alike (ROADMAP Queue 3)")
        call = lambda: wkv6(r, k, v, w, u, chunk=L, S0=S0)
        case = dict(route=how, ms=cuda_ms(call, 20),
                    graph_ms=graph_ms(call, 20), plain_ms=plain_ms)
        # the least time: the bytes (inputs read once, y and S written
        # once) against the operations on the tensor cores as the
        # tensor-core kernels run them, each product as three TF32
        # products, and the decay work (12 per (row, channel)) at the f32
        # rate; beside it the operations all at the f32 rate
        moved = nbytes(r, k, v, w, u, y, S) + (nbytes(S0) if with_state
                                               else 0)
        elem = 12 * B * T * H * K
        prod = peaks().wkv_ops(B, T, H, K, L) - elem
        t_ops = (3 * prod / peaks().TF32_FLOPS
                 + elem / peaks().FP32_FLOPS) * 1e3
        case["bound_ms"], case["bound_by"] = max(
            (moved / peaks().HBM_BW * 1e3, "bytes"), (t_ops, "operations"))
        f32_ms, _ = bound(moved, peaks().wkv_ops(B, T, H, K, L),
                          peaks().FP32_FLOPS)
        case["passes_ms"] = {
            name: cuda_ms(fn, 20) for name, fn in pass_launchers(
                r, k, v, w, u, chunk=L, S0=S0).items()}
        if L % 64:
            errs.append(max(
                check_close(y_h, y_p, tol_y, 0.0, label + " per-head y"),
                check_close(S_h, S_p, tol_S, 0.0, label + " per-head S")))
            case["per_head_ms"] = cuda_ms(per_head, 10)
            case["per_head_graph_ms"] = graph_ms(per_head, 10)
        print(f"  {label}: ms={case['ms']!r} graph_ms={case['graph_ms']!r} "
              f"plain_ms={case['plain_ms']!r} bound_ms={case['bound_ms']!r} "
              f"({case['bound_by']}, split TF32 products) "
              f"f32_rate_bound_ms={f32_ms!r} "
              f"passes_ms={case['passes_ms']!r}"
              + (f" per_head_ms={case['per_head_ms']!r} per_head_graph_ms="
                 f"{case['per_head_graph_ms']!r} per_head_over_graph="
                 f"{case['per_head_graph_ms'] / case['graph_ms']!r}"
                 if "per_head_ms" in case else ""))
        cases[label] = case
    first = next(iter(cases.values()))
    return dict(name="wkv6", route="cuda",
                source="src/repro_torch/csrc/wkv6.cu",
                replaces="src/repro/kernels/rwkv6/kernel.py:73",
                max_abs_err=max(errs), library_ms=None,
                **{k: first[k] for k in ("ms", "graph_ms", "plain_ms",
                                         "bound_ms", "bound_by")},
                passes_ms=first["passes_ms"], cases=cases)


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
    dot_grad_check(gen, layers.dot, x, w, f"layers.dot bf16 {DOT_SHAPE}")
    # layers.bmm, the MoE experts' product, at the DeepSeekMoE prefill's
    # dispatch buffer (64 experts x 480 slots, d 2048, f 1408), same gate
    E, C, D, N = BMM_SHAPE
    x = torch.randn((E, C, D), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((E, D, N), generator=gen, device="cuda")
         * D ** -0.5).bfloat16()
    got = layers.bmm(x, w)
    want = torch.bmm(x.float(), w.float())
    err = float((got - want).abs().max() / want.abs().max())
    print(f"phase 1d: layers.bmm bf16 {BMM_SHAPE}: max|bmm - f32 "
          f"product|/max = {err!r}")
    if got.dtype != torch.float32 or not err <= 1e-5:
        raise AssertionError(f"layers.bmm: {got.dtype}, {err} of the f32 "
                             "product's largest value")
    dot_grad_check(gen, layers.bmm, x, w, f"layers.bmm bf16 {BMM_SHAPE}")


def dot_grad_check(gen, fn, x, w, label):
    """The gradients of ``layers.dot`` / ``bmm`` on bf16 operands (the
    ``out_dtype`` product has no derivative in torch; ``_F32Product``
    gives it one) against autograd of the f32 product, under a random f32
    cotangent: bf16 gradients within one bf16 ULP of the largest |f32
    gradient| rounded to bf16 (the same f32 products, their sums perhaps
    in another order, each rounded to bf16 once)."""
    x, w = (t.detach().requires_grad_(True) for t in (x, w))
    out = fn(x, w)
    cot = torch.randn(out.shape, generator=gen, device="cuda")
    got = torch.autograd.grad(out, (x, w), cot)
    xf, wf = (t.detach().float().requires_grad_(True) for t in (x, w))
    want = torch.autograd.grad(torch.matmul(xf, wf), (xf, wf), cot)
    for name, a, b in zip(("dX", "dW"), got, want):
        ulps = _ulps_of_scale(a, b.bfloat16())
        print(f"phase 1d: {label} {name}: {a.dtype}, "
              f"{'bit for bit' if bitwise(a, b.bfloat16()) else 'not bitwise'}"
              f" the f32 gradient rounded to bf16, worst {ulps!r} bf16 ULPs "
              "of its largest |value|")
        if a.dtype != torch.bfloat16 or not ulps <= 1.0:
            raise AssertionError(f"{label} {name}: {a.dtype}, {ulps} bf16 "
                                 "ULPs from autograd of the f32 product")


# --------------------------------------------------------------------------
# phase 5: the tenant LM serving path at full width
# --------------------------------------------------------------------------


def phase_serving(arch, counters):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import generate
    cfg = get_config(arch)
    depth = ""
    if arch in SERVE_DEPTH:
        depth = f" of {cfg.n_layers}: depth cut"
        cfg = cfg.replace(n_layers=SERVE_DEPTH[arch])
    B, S0, N = SERVE_B, SERVE_PROMPT, SERVE_NEW
    print(f"phase 5: serving {arch} ({cfg.n_layers} layers{depth}, d_model "
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
    extra = {}
    if cfg.is_encdec:
        extra["enc_embeds"] = torch.randn((B, WHISPER_FRAMES, cfg.d_model),
                                          generator=gen, device="cuda")
        print(f"  encoder input: {B} x {WHISPER_FRAMES} frames")

    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    toks, logits = generate(cfg, params, prompt, max_new_tokens=N,
                            return_logits=True, **extra)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {fn.__name__: fn.launches for fn in counters}
    print(f"  launches in one generate: {counts}")
    # one flash launch a prefill self-attention layer, the encoder's too
    n_attn = (sum(1 for mixer, _ in cfg.layer_kinds() if mixer == "attn")
              + cfg.encoder_layers)
    want = {"flash_attention": n_attn,
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
    if cfg.moe is not None:
        torch.cuda.reset_peak_memory_stats()
        moe = moe_serving_checks(cfg, params, prompt, toks, logits)
    rel = decode_vs_forward(cfg, params, prompt, toks, logits, extra)
    if cfg.moe is not None:
        print(f"  (not gated: at capacity factor {cfg.moe.capacity_factor} "
              f"the {S0 + N - 1}-token forward drops "
              f"{moe['forward_drops']} of its token-expert pairs, which the "
              "decode step, 4 tokens a step, never drops)")
    elif not cfg.rwkv:
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
    family = {}
    if cfg.mrope_sections:
        family = vlm_checks(cfg, params, prompt)
    if cfg.is_encdec:
        family = encdec_checks(cfg, params, prompt, extra["enc_embeds"])

    stats = {}
    generate(cfg, params, prompt, max_new_tokens=N, stats=stats, **extra)
    dec_tok_s = B * (N - 1) / stats["decode_s"]
    print(f"  generate (warm): prefill_s={stats['prefill_s']!r} "
          f"decode_s={stats['decode_s']!r} decode_tok_s={dec_tok_s!r}")
    out = dict(prefill_s=stats["prefill_s"], decode_tok_s=dec_tok_s,
               counts=counts, idle=None, idle_warm=None, peak_gb=peak_gb,
               layers=cfg.n_layers, **family)
    if cfg.rwkv:
        out.update(rwkv_ragged_prompts(cfg, params, gen, stats["prefill_s"]))
    if arch == DIST_DENSE_ARCH:     # phase 14 (b) generates again on a mesh
        out["generated"] = (toks, logits)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(cfg, params, prompt, max_new_tokens=N, **extra)
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
    print(f"  {arch}: peak memory of one generate {peak_gb!r} GB")
    if cfg.moe is not None:
        moe["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"  {arch}: peak memory over the MoE checks {moe['peak_gb']!r} "
              "GB")
    del params
    torch.cuda.empty_cache()
    if cfg.rwkv:
        out["f32_rel"] = rwkv_f32_agreement(cfg)
    if cfg.moe is not None and cfg.mamba is None:
        moe.update(moe_layer_check(cfg))
        moe["f32_rel"] = moe_f32_agreement(cfg)
        out["f32_rel"] = moe["f32_rel"]
    if cfg.mamba is not None:
        out["mixer_rel"] = mamba_mixer_check(cfg)
        out["f32_rel"] = jamba_f32_agreement(cfg)
    if cfg.moe is not None:
        out["moe"] = moe
    return out


def drop_free(cfg):
    """``cfg`` at a capacity factor of E/k, where every expert has a slot
    for every token (cap >= T), so nothing drops."""
    mo = cfg.moe
    return cfg.replace(moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


def dropped_pairs(idx, cap):
    """Which (token, j) pairs overflow their expert's ``cap`` slots, counted
    independently of the layer's sort: each pair's place in its expert's
    queue is a cumulative count over the token-major pairs."""
    flat = idx.reshape(-1)
    one_hot = torch.nn.functional.one_hot(flat, int(flat.max()) + 1)
    rank = one_hot.cumsum(0).gather(1, flat[:, None])[:, 0] - 1
    return (rank >= cap).reshape(idx.shape)


@contextlib.contextmanager
def routing(mode, calls):
    """Record every MoE layer's routing (``mode="record"``: append the
    (B, S, k) indices of each ``moe.route`` call to ``calls``) or pin a
    forward's routing to recorded choices (``mode="pin"``: ``calls`` holds
    one (B, S, k) index tensor a MoE layer; each layer keeps its own
    probabilities and renormalised gates at the pinned experts, and the
    number of choices that differ from its own top-k is added to
    ``calls``'s ``flips``)."""
    from repro_torch.models import layers, moe
    route = moe.route
    state = {"layer": 0}

    def spy(cfg, p, x):
        gates, idx, aux = route(cfg, p, x)
        if mode == "record":
            calls.append(idx)
            return gates, idx, aux
        pinned = calls["idx"][state["layer"]]
        state["layer"] += 1
        own = torch.sort(idx, dim=-1).values
        calls["flips"] += int((own != torch.sort(pinned, dim=-1).values)
                              .any(-1).sum())
        probs = torch.softmax(layers.dot(x, p["router"]["wr_router"]), -1)
        g = probs.gather(-1, pinned)
        if cfg.moe.renorm_top_k:
            g = g / g.sum(-1, keepdim=True)
        return g, pinned, aux

    moe.route = spy
    try:
        yield calls
    finally:
        moe.route = route


def pinned_agreement(cfg, params, prompt, N, what=""):
    """Generate ``N`` tokens at ``cfg`` recording every MoE layer's
    routing, then a forward over the prompt and the generated tokens with
    each MoE layer's routing pinned to the generate's choices.  Returns the
    last decode step's max |difference| over the largest logit, the number
    of token-layer choices where the forward's own top-k differs, the
    number of choices, and the generate's tokens and logits."""
    from repro_torch.models import forward
    from repro_torch.serving import generate
    B, S0 = prompt.shape
    n_moe = sum(1 for _, f in cfg.layer_kinds() if f == "moe")
    calls = []
    with routing("record", calls):
        toks, logits = generate(cfg, params, prompt, max_new_tokens=N,
                                return_logits=True)
    # calls: the prefill's n_moe layers, then n_moe a decode step
    steps = [calls[i:i + n_moe] for i in range(0, len(calls), n_moe)]
    pinned = {"idx": [torch.cat([step[l] for step in steps], dim=1)
                      for l in range(n_moe)], "flips": 0}
    full = torch.cat([prompt, toks[:, :-1]], dim=1)
    with routing("pin", pinned), torch.inference_mode():
        ref_logits, _, _ = forward(cfg, params, {"tokens": full})
    a, b = ref_logits[:, -1], logits[:, -1]
    rel = float((a - b).abs().max() / a.abs().max())
    n_choices = n_moe * B * (S0 + N - 1)
    print(f"  {what}last decode step vs a forward over {full.shape[1]} "
          f"tokens with the generate's routing pinned: max|diff|/max|logit| "
          f"= {rel!r}, argmax agreement "
          f"{float((a.argmax(-1) == b.argmax(-1)).double().mean())!r}; "
          f"the forward's own top-k differs from the generate's at "
          f"{pinned['flips']} of {n_choices} token-layer choices")
    return rel, pinned["flips"], n_choices, toks, logits


def moe_serving_checks(cfg, params, prompt, toks, logits):
    """Phase 5's gates of the MoE models (DeepSeekMoE, Jamba) in bf16:
    (b) a second generate bit for bit the first; (d) at a drop-free
    capacity factor, the last decode step against a forward over the prompt
    and the generated tokens with each MoE layer's routing pinned to the
    generate's choices, within the 5e-2 that bf16 rounding allows (the
    Qwen3 bound); the unpinned forward's routing flips are counted.  Also
    counts the pairs that the 1039-token forward drops at the
    configuration's capacity factor."""
    from repro_torch.models import forward, moe
    from repro_torch.serving import generate
    N = toks.shape[1]
    toks2, logits2 = generate(cfg, params, prompt, max_new_tokens=N,
                              return_logits=True)
    same = bitwise(toks2, toks) and bitwise(logits2, logits)
    print(f"  (b) a second generate from the same weights and prompt: "
          f"tokens and logits bit for bit the first: {same}")
    if not same:
        raise AssertionError(f"{cfg.name}: two generates differ")

    full = torch.cat([prompt, toks[:, :-1]], dim=1)
    calls = []
    with routing("record", calls), torch.inference_mode():
        forward(cfg, params, {"tokens": full})
    cap = moe.capacity(cfg, full.numel())
    drops = sum(int(dropped_pairs(idx, cap).sum()) for idx in calls)
    free = drop_free(cfg)
    rel, flips, n_choices, toks_f, logits_f = pinned_agreement(
        free, params, prompt, N,
        what=f"(d) drop-free (capacity factor "
             f"{free.moe.capacity_factor!r}): ")
    unpinned = decode_vs_forward(free, params, prompt, toks_f, logits_f,
                                 what="(d) unpinned, not gated: ")
    if not rel <= 5e-2:
        raise AssertionError(f"{cfg.name}: drop-free decode disagrees with "
                             f"the pinned forward ({rel})")
    n_moe = sum(1 for _, f in cfg.layer_kinds() if f == "moe")
    return dict(forward_drops=drops, forward_pairs=n_moe * full.numel()
                * cfg.moe.top_k, pinned_rel=rel, unpinned_rel=unpinned,
                flips=flips, choices=n_choices)


def moe_layer_check(cfg):
    """(c) One full-width MoE layer in f32 at MOE_LAYER_SHAPE tokens of unit
    RMS (the routed input after its RMS norm) that share one common
    component, as a residual stream's tokens do, so that the experts' loads
    are uneven and the configuration's capacity drops pairs: drop-free
    against
    ``moe_dense_ref``, and at the configuration's capacity factor against
    ``moe_dense_ref`` with the gates of the dropped pairs (counted by
    ``dropped_pairs``) zeroed, each within 1e-4 of the largest output (f32
    products of 2,048 and 1,408 terms in another order: the worst-case
    order bound is about n u = 1.2e-4, the typical sqrt(n) u = 3e-6)."""
    from repro_torch.models import moe
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    p = moe.moe_init(cfg32, gen)
    x = torch.randn((*MOE_LAYER_SHAPE, cfg.d_model), generator=gen,
                    device="cuda")
    common = torch.randn((cfg.d_model,), generator=gen, device="cuda")
    x = (x + common) * 0.5 ** 0.5
    T = x.shape[0] * x.shape[1]
    gates, idx, aux = moe.route(cfg32, p, x)
    out = {}
    for label, c in (("drop-free", drop_free(cfg32)), ("dropping", cfg32)):
        cap = moe.capacity(c, T)
        dropped = dropped_pairs(idx, cap)
        kept = torch.where(dropped, torch.zeros_like(gates), gates)
        got = moe.moe_apply(c, p, x, gates, idx)
        want = moe.moe_dense_ref(c, p, x, kept, idx)
        rel = float((got - want).abs().max() / want.abs().max())
        n = int(dropped.sum())
        print(f"  (c) one MoE layer, f32, {T} tokens, {label} (capacity "
              f"factor {c.moe.capacity_factor!r}, cap {cap}): {n} of "
              f"{idx.numel()} pairs dropped; moe_apply against moe_dense_ref"
              f"{' with their gates zeroed' if n else ''}: max|diff|/max|ref|"
              f" = {rel!r} (gate 1e-4)")
        if (label == "drop-free") == bool(n) or not rel <= 1e-4:
            raise AssertionError(f"{cfg.name} layer {label}: {n} drops, "
                                 f"rel {rel}")
        out[f"layer_{label}"] = dict(rel=rel, dropped=n, pairs=idx.numel())
    del p
    torch.cuda.empty_cache()
    return out


def moe_f32_agreement(cfg):
    """(d) in f32 at MOE_F32_LAYERS layers of full width, drop-free: the
    last decode step against the forward, unpinned, within the JAX test's
    2e-4 (``tests/test_models.py::_decode_consistency``)."""
    from repro_torch.models import init_params
    from repro_torch.serving import generate
    cfg32 = drop_free(cfg).replace(n_layers=MOE_F32_LAYERS, dtype="float32",
                                   param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg32, gen, device="cuda")
    prompt = torch.randint(0, cfg32.vocab, (SERVE_B, SERVE_PROMPT),
                           generator=gen, device="cuda")
    toks, logits = generate(cfg32, params, prompt, max_new_tokens=SERVE_NEW,
                            return_logits=True)
    rel = decode_vs_forward(cfg32, params, prompt, toks, logits,
                            what=f"(d) {cfg.name} in f32 at {MOE_F32_LAYERS}"
                                 " layers, drop-free: ")
    del params
    torch.cuda.empty_cache()
    if not rel <= 2e-4:
        raise AssertionError(f"{cfg.name} f32: decode disagrees with the "
                             f"forward pass ({rel})")
    return rel


def rwkv_ragged_prompts(cfg, params, gen, prefill_1024):
    """RWKV6 ``generate`` at the prompts of ``RWKV_RAGGED_PROMPTS``, whose
    chunks (8, 1, 10, 375) are no multiples of 64, each a prefill and a
    decode step (2 new tokens): one wkv6 launch a layer on the chunk's route
    (chunk-parallel from 64 up, else tile-parallel) and no other, the
    counts set to 0 just before each generate and read just after, and that
    generate's peak memory; then a warm generate's prefill seconds, printed
    beside the 1,024 prompt's, and (not the main path) one with
    ``kernel.route`` sending every call to the per-head kernel, which took
    these chunks before."""
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.kernels.rwkv6.kernel import wkv6
    from repro_torch.serving import generate
    prefill, launches = {(SERVE_B, SERVE_PROMPT): prefill_1024}, 0
    per_head, peak = {}, {}
    for B, P in RWKV_RAGGED_PROMPTS:
        chunk = math.gcd(P, max(256, P // 128))
        how = wkv_route_of(chunk)
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                               device="cuda")
        wkv6.launches = 0
        wkv6.route_launches = dict.fromkeys(wkv6.route_launches, 0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        toks, logits = generate(cfg, params, prompt, max_new_tokens=2,
                                return_logits=True)
        torch.cuda.synchronize()
        peak[(B, P)] = torch.cuda.max_memory_allocated() / 1e9
        got = dict(wkv6.route_launches)
        want = {h: cfg.n_layers if h == how else 0 for h in got}
        if got != want or wkv6.launches != cfg.n_layers:
            raise AssertionError(f"{cfg.name} prompt {P} (chunk {chunk}): "
                                 f"wkv6 launches by route {got}, expected "
                                 f"{want}")
        if not (torch.isfinite(logits).all()
                and torch.equal(toks, logits.argmax(-1))):
            raise AssertionError(f"{cfg.name} prompt {P}: non-finite logits "
                                 "or tokens that are not their argmax")
        launches += wkv6.launches
        # the prefill, warm
        stats = {}
        generate(cfg, params, prompt, max_new_tokens=2, stats=stats)
        prefill[(B, P)] = stats["prefill_s"]
        route = wk.route
        wk.route = lambda *a: "per-head"
        try:
            before, old = {}, wkv6.route_launches["per-head"]
            toks_h = generate(cfg, params, prompt, max_new_tokens=2,
                              stats=before)
        finally:
            wk.route = route
        if wkv6.route_launches["per-head"] - old != cfg.n_layers:
            raise AssertionError(f"{cfg.name} prompt {P}: the per-head "
                                 "route was not taken")
        per_head[(B, P)] = before["prefill_s"]
        print(f"  batch {B} prompt {P} (chunk {chunk}): wkv6 launches by "
              f"route {got}; peak_gb={peak[(B, P)]!r} (allocated before "
              f"it {base / 1e9!r}); generate (warm) prefill_s="
              f"{stats['prefill_s']!r}; through the per-head kernel "
              f"prefill_s={before['prefill_s']!r}, tokens equal "
              f"{bool(torch.equal(toks_h, toks))} (not gated: bf16)")
    print(f"  {cfg.name} prefill_s by (batch, prompt length): {prefill!r}; "
          f"through the per-head kernel {per_head!r}; peak GB {peak!r}")
    return dict(prefill_by_prompt=prefill, prefill_per_head=per_head,
                ragged_peak_gb=peak, ragged_launches=launches)


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


def decode_vs_forward(cfg, params, prompt, toks, logits, extra=None,
                      what=""):
    """Max |difference| of the last decode step's logits and a forward over
    the prompt and the generated tokens (and ``extra``'s inputs, the
    encoder's frames), over the largest logit."""
    from repro_torch.models import forward
    full = torch.cat([prompt, toks[:, :-1]], dim=1)
    with torch.inference_mode():
        ref_logits, _, _ = forward(cfg, params,
                                   {"tokens": full, **(extra or {})})
    a, b = ref_logits[:, -1], logits[:, -1]
    rel = float((a - b).abs().max() / a.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).double().mean())
    print(f"  {what}last decode step after a {prompt.shape[1]}-token "
          f"prompt vs a forward over {full.shape[1]} tokens: "
          f"max|diff|/max|logit| = "
          f"{rel!r}, argmax agreement {agree!r}")
    return rel


@contextlib.contextmanager
def sequential_scan():
    """Swap the Mamba mixer's chunked scan for the plain sequential
    recurrence (``tests/test_models.py``'s naive loop, in torch); the
    mixer's projections stay as they are."""
    from repro_torch.models import mamba
    chunked = mamba._ssm_scan_chunked

    def naive(decay, inc, h0, *, chunk):
        h, outs = h0, []
        for t in range(decay.shape[1]):
            h = decay[:, t] * h + inc[:, t]
            outs.append(h)
        return torch.stack(outs, dim=1), h

    mamba._ssm_scan_chunked = naive
    try:
        yield
    finally:
        mamba._ssm_scan_chunked = chunked


def mamba_mixer_check(cfg):
    """(c) One full-width ``mamba_mixer`` in f32 at SERVE_B x SERVE_PROMPT
    tokens of unit variance, at the model's chunk rule (64), against the
    sequential recurrence with the same projections, and one decode step
    from each one's state: outputs and states within 1e-5 of their largest
    value (the same f32 recurrence, its products and sums reordered by the
    doubling scan: a few roundings of h, carried through 8,192-term f32
    products), the conv tails bit for bit."""
    from repro_torch.models import mamba
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    p = mamba.mamba_init(cfg32, gen)
    B, S = SERVE_B, SERVE_PROMPT
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    x1 = torch.randn((B, 1, cfg.d_model), generator=gen, device="cuda")
    chunk = math.gcd(S, min(512, max(64, S // 16)))    # the model's rule
    with torch.inference_mode():
        t0 = time.perf_counter()
        out, st = mamba.mamba_mixer(cfg32, p, x, None, chunk=chunk)
        torch.cuda.synchronize()
        t_mixer = time.perf_counter() - t0
        step, st1 = mamba.mamba_mixer(cfg32, p, x1, st, chunk=1)
        with sequential_scan():
            ref, rst = mamba.mamba_mixer(cfg32, p, x, None, chunk=chunk)
            ref1, rst1 = mamba.mamba_mixer(cfg32, p, x1, rst, chunk=1)
    rels = {label: float((got - want).abs().max() / want.abs().max())
            for label, got, want in (
                ("prefill out", out, ref), ("prefill h", st["h"], rst["h"]),
                ("decode out", step, ref1), ("decode h", st1["h"],
                                             rst1["h"]))}
    tails = bitwise(st["conv"], rst["conv"]) and bitwise(st1["conv"],
                                                         rst1["conv"])
    print(f"  (c) one mamba_mixer, f32, {B} x {S} tokens, chunk {chunk} "
          f"({t_mixer!r} s), against the sequential recurrence: "
          f"max|diff|/max|ref| {rels} (gate 1e-5); conv tails bit for bit: "
          f"{tails}")
    del p, out, st, ref, rst
    torch.cuda.empty_cache()
    if not (tails and all(r <= 1e-5 for r in rels.values())):
        raise AssertionError(f"{cfg.name}: mamba_mixer departs from the "
                             f"recurrence ({rels}, tails {tails})")
    return rels


def jamba_f32_agreement(cfg):
    """(d) in f32 at JAMBA_F32_LAYERS layers of full width (Mamba, MoE and
    the attention layer), drop-free, with the routing pinned: the last
    decode step against the forward within the JAX test's 2e-4
    (``tests/test_models.py::_decode_consistency``).  The prefill's Mamba
    chunk is 64, the 1,039-token forward's 1: the scan's two forms meet."""
    from repro_torch.models import init_params
    cfg32 = drop_free(cfg).replace(n_layers=JAMBA_F32_LAYERS,
                                   dtype="float32", param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg32, gen, device="cuda")
    prompt = torch.randint(0, cfg32.vocab, (SERVE_B, SERVE_PROMPT),
                           generator=gen, device="cuda")
    rel, flips, _, _, _ = pinned_agreement(
        cfg32, params, prompt, SERVE_NEW,
        what=f"(d) {cfg.name} in f32 at {JAMBA_F32_LAYERS} layers "
             f"({[k for k in cfg32.layer_kinds()]}), drop-free: ")
    del params
    torch.cuda.empty_cache()
    if not rel <= 2e-4:
        raise AssertionError(f"{cfg.name} f32: decode disagrees with the "
                             f"forward pass ({rel})")
    return rel


def image_positions(B, n_text, grid, n_after):
    """Qwen2-VL's (3, B, S) position streams for text, a grid x grid image,
    then text: text t = h = w = index; image t = start, h = start + row,
    w = start + col; the text after it resumes at the largest position + 1.
    """
    text = torch.arange(n_text, device="cuda")
    cell = torch.arange(grid * grid, device="cuda")
    img = torch.stack([torch.full_like(cell, n_text), n_text + cell // grid,
                       n_text + cell % grid])
    after = n_text + grid + torch.arange(n_after, device="cuda")
    pos = torch.cat([text.expand(3, -1), img, after.expand(3, -1)], dim=1)
    return pos[:, None].expand(3, B, -1)


def mrope_f64(x, pos3, theta, sections):
    """``layers.apply_mrope``'s formula evaluated in f64."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=F64, device=x.device) / half)
    streams = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))
    ang = (pos3.to(F64).movedim(0, -1)[..., streams] * freqs)[..., None, :]
    x1, x2 = x.to(F64).chunk(2, dim=-1)
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x1 * ang.sin() + x2 * ang.cos()], dim=-1)


def vlm_checks(cfg, params, prompt):
    """Qwen2-VL's M-RoPE on the card.  (c) ``apply_mrope`` with three equal
    position streams is ``apply_rope`` bit for bit (bf16, the prefill's q
    shape), and a prefill from ``embeds = embed[tokens]`` with equal streams
    is the tokens prefill bit for bit, logits and caches.  (d) an image
    prefill: VL_TEXT text tokens, a VL_GRID x VL_GRID grid of patch
    embeddings (seeded normal x 0.02), text to the prompt length, on
    Qwen2-VL's position streams: one flash launch a layer, finite logits,
    then VL_STEPS decode steps from its cache with finite logits.  And
    ``apply_mrope`` in f32 at those positions within 5e-5 of max |x| of an
    f64 evaluation: angles up to 267 rad carry at most half an f32 ulp
    (1.5e-5) plus the frequencies' own rounding, and each output sums two
    such rotated terms."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.models import decode_step, layers, prefill
    from repro_torch.serving import pad_attn_cache
    B, S = prompt.shape
    theta, sections = cfg.rope_theta, cfg.mrope_sections
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    pos = torch.arange(S, device="cuda")
    x = torch.randn((B, S, cfg.n_heads, cfg.hd), generator=gen,
                    device="cuda").to(cfg.adtype)
    rope_same = bitwise(layers.apply_mrope(x, pos.expand(3, B, S), theta,
                                           sections),
                        layers.apply_rope(x, pos[None], theta))
    with torch.inference_mode():
        lt, ct = prefill(cfg, params, {"tokens": prompt})
        le, ce = prefill(cfg, params, {"embeds": params["embed"][prompt],
                                       "mrope_positions":
                                           pos.expand(3, B, S)})
    prefill_same = bitwise(lt, le) and all(
        bitwise(a, b) for a, b in zip(_leaves(ct), _leaves(ce)))
    print(f"  (c) apply_mrope with equal streams bit for bit apply_rope: "
          f"{rope_same}; an embeds prefill with equal streams bit for bit "
          f"the tokens prefill: {prefill_same}")
    if not (rope_same and prefill_same):
        raise AssertionError(f"{cfg.name}: equal M-RoPE streams are not "
                             "1-D RoPE")
    del lt, ct, le, ce

    n_img = VL_GRID * VL_GRID
    pos3 = image_positions(B, VL_TEXT, VL_GRID, S - VL_TEXT - n_img)
    embeds = params["embed"][prompt].clone()
    embeds[:, VL_TEXT:VL_TEXT + n_img] = (torch.randn(
        (B, n_img, cfg.d_model), generator=gen, device="cuda")
        * 0.02).to(embeds.dtype)
    before = flash_attention.launches
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(cfg, params, {"embeds": embeds,
                                              "mrope_positions": pos3})
        torch.cuda.synchronize()
        t_img = time.perf_counter() - t0
        n_flash = flash_attention.launches - before
        finite = bool(torch.isfinite(logits).all())
        cache = pad_attn_cache(cache, VL_STEPS)
        tok = logits[:, -1].argmax(-1)
        for i in range(VL_STEPS):
            step, cache = decode_step(cfg, params, cache, tok, S + i)
            finite = finite and bool(torch.isfinite(step).all())
            tok = step[:, -1].argmax(-1)
    x32 = torch.randn((B, S, cfg.n_heads, cfg.hd), generator=gen,
                      device="cuda")
    rel = float((layers.apply_mrope(x32, pos3, theta, sections).double()
                 - mrope_f64(x32, pos3, theta, sections)).abs().max()
                / x32.abs().max())
    print(f"  (d) image prefill ({VL_TEXT} text + {VL_GRID}x{VL_GRID} "
          f"patches + {S - VL_TEXT - n_img} text, positions up to "
          f"{int(pos3.max())}) in {t_img!r} s: {n_flash} flash launches, "
          f"then {VL_STEPS} decode steps; logits finite: {finite}; "
          f"apply_mrope f32 vs f64 at these positions: max|diff|/max|x| = "
          f"{rel!r} (gate 5e-5)")
    if n_flash != cfg.n_layers or not finite or not rel <= 5e-5:
        raise AssertionError(f"{cfg.name}: image prefill ({n_flash} "
                             f"launches, finite {finite}, mrope {rel})")
    return dict(mrope_rel=rel, image_prefill_s=t_img)


def encdec_checks(cfg, params, prompt, enc):
    """Whisper's encoder-decoder on the card.  (a) the flash launches of a
    generate, in order: the encoder's, non-causal over WHISPER_FRAMES
    frames, then the decoder's, causal over the prompt.  (b) the prefill's
    cross K/V are not padded by ``pad_attn_cache`` (the same tensors,
    WHISPER_FRAMES long) and decode steps leave them unchanged."""
    from repro_torch.models import attention, decode_step, prefill
    from repro_torch.serving import generate, pad_attn_cache
    B, S = prompt.shape
    calls, kernel = [], attention._flash

    def spy(q, k, v, *, causal=True):
        calls.append((q.shape[1], k.shape[1], causal))
        return kernel.flash_attention(q, k, v, causal=causal)

    # the attention module's handle on the kernel module, not the kernel
    # module's own name, which the wrapper's launch counter goes through
    attention._flash = types.SimpleNamespace(flash_attention=spy)
    try:
        generate(cfg, params, prompt, max_new_tokens=2, enc_embeds=enc)
    finally:
        attention._flash = kernel
    F = WHISPER_FRAMES
    want = ([(F, F, False)] * cfg.encoder_layers
            + [(S, S, True)] * cfg.n_layers)
    print(f"  (a) flash launches of a generate (Sq, Skv, causal): "
          f"{calls.count((F, F, False))} x {(F, F, False)}, "
          f"{calls.count((S, S, True))} x {(S, S, True)}")
    if calls != want:
        raise AssertionError(f"{cfg.name}: flash launches {calls}")

    with torch.inference_mode():
        _, cache = prefill(cfg, params, {"tokens": prompt, "enc_embeds": enc})
        padded = pad_attn_cache(cache, SERVE_NEW)
        shared = all(p["cross"] is c["cross"]
                     and p["cross"]["ck"].shape == (B, F, cfg.n_kv, cfg.hd)
                     and p["attn"]["k"].shape[1] == S + SERVE_NEW
                     for p, c in zip(padded["layers"], cache["layers"]))
        kept = [{k: v.clone() for k, v in c["cross"].items()}
                for c in padded["layers"]]
        tok = prompt[:, -1]
        for i in range(SERVE_NEW - 1):
            step, padded = decode_step(cfg, params, padded, tok, S + i)
            tok = step[:, -1].argmax(-1)
        unchanged = all(bitwise(c["cross"][k], old[k])
                        for c, old in zip(padded["layers"], kept)
                        for k in ("ck", "cv"))
    print(f"  (b) cross K/V unpadded and shared by pad_attn_cache: {shared}; "
          f"unchanged over {SERVE_NEW - 1} decode steps: {unchanged}")
    if not (shared and unchanged):
        raise AssertionError(f"{cfg.name}: the cross cache was padded or "
                             "changed")
    return {}


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
    last chunk of ``chunk`` as the loop sees them (``loop_kernel_checks``):
    inert-lane padded to the chunk width.  Returns the max abs error."""
    from repro_torch import core
    from repro_torch.core import sharding
    start = (len(grid) - 1) // chunk * chunk
    n_max = max(c.scenario.n for c in grid)
    batch = core.stack_scenarios([c.scenario for c in grid[start:]],
                                 n_max=n_max)
    batch = sharding.pad_batch_lanes(batch, chunk)
    label = (f"the plan's last chunk ({len(grid) - start} candidates and "
             f"{chunk - len(grid) + start} inert lanes, {n_max} classes")
    return loop_kernel_checks(batch, name, label)


def loop_kernel_checks(batch, name, label):
    """The kernel against its plain version on ``batch`` as the loop sees
    it: widened by ``game._aligned_classes`` (masked tail classes bidding
    rho_bar), at bids three cold Alg. 4.1 steps in and at bids drawn
    uniformly in [rho_bar, rho_up] per class (every price distinct).  The
    fused middle bit for bit; the sweep within (2N + 8) ULPs on every lane
    and bit for bit to ``emulated_sweep`` on the first and last lanes (real
    lanes with the masked tail, inert lanes where the batch is padded).
    ``label`` names the batch (its text runs on with the widened width).
    Returns the max abs error."""
    from repro_torch.core import game
    from repro_torch.core.game import _rm_candidates
    from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep
    from repro_torch.kernels.gnep_iter.ref import fused_middle_reference
    from repro_torch.kernels.gnep_sweep.kernel import rm_sweep_batched
    from repro_torch.kernels.gnep_sweep.ref import reference_batched
    wide, _ = game._aligned_classes(batch, None)
    scns, mask = wide.scenarios, wide.mask
    prep, stepped = trajectory_bids(wide)
    gen = torch.Generator().manual_seed(SEED + 2)
    u = torch.rand(mask.shape, generator=gen, dtype=F64).to(mask.device)
    rb = scns.rho_bar[:, None]
    label = f"{label} widened to {wide.n_max})"
    half = ORDER_LANES // 2
    B = wide.batch_size
    lanes = torch.cat([torch.arange(half), torch.arange(B - half, B)]
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


# --------------------------------------------------------------------------
# phase 10: the fleet simulator
# --------------------------------------------------------------------------


def fleet_draw(rng, n, prefix):
    """(total_chips, tenant fields, profiles) of one fleet of ``n`` tenants
    in ``examples/multi_tenant_cluster.py``'s ranges, with total_chips =
    round(0.95 * sum r_up) (r_up from ``derive``'s formula, c^M = c^R = 1,
    profiled at 256 chips)."""
    comp = rng.uniform(0.2, 1.8, n)
    coll = rng.uniform(0.1, 0.9, n)
    deadline = rng.uniform(15.0, 120.0, n)
    h_up = rng.integers(8, 21, n)
    h_low = rng.integers(2, 9, n)
    penalty = rng.uniform(15000.0, 30000.0, n)
    tp = rng.choice(FLEET_TP, n)
    arch = rng.integers(0, len(FLEET_ARCHS), n)
    K = (np.sqrt(comp * 256.0) + np.sqrt(coll * 256.0)) ** 2 / (deadline
                                                                - 1.0)
    R = int(round(FLEET_CF * float(np.sum(K * h_up))))
    specs = [dict(name=f"{prefix}t{i}", arch_id=FLEET_ARCHS[arch[i]][0],
                  shape=FLEET_ARCHS[arch[i]][1],
                  deadline_s=float(deadline[i]), H_up=int(h_up[i]),
                  H_low=int(h_low[i]), penalty_per_job=float(penalty[i]),
                  max_bid=20.0, tp_required=int(tp[i])) for i in range(n)]
    profiles = {s["name"]: (float(comp[i]), float(coll[i]), 1.0)
                for i, s in enumerate(specs)}
    return R, specs, profiles


def fleet_of(drawn):
    """A FleetSimulator on the card from drawn numbers, its profiles
    registered as ``epoch(profiles=...)`` registers them."""
    from repro_torch.cluster import FleetSimulator, TenantSpec
    R, specs, profiles = drawn
    f = FleetSimulator(R, [TenantSpec(**s) for s in specs], device="cuda")
    f._profiles = dict(profiles)
    return f


def alloc_diff(got, want, rel):
    """What differs between two allocation lists: chips, h, meshes and
    iterations exactly, totals within ``rel`` of the larger."""
    bad = set()
    if len(got) != len(want):
        return {"length"}
    for a, b in zip(got, want):
        for name in ("chips", "h", "meshes", "iters", "feasible"):
            if getattr(a, name) != getattr(b, name):
                bad.add(name)
        scale = max(abs(a.total_cost), abs(b.total_cost), 1.0)
        if not abs(a.total_cost - b.total_cost) <= rel * scale:
            bad.add("total_cost")
    return sorted(bad)


def fleet_stream_epochs(rng, drawn, newcomer):
    """FLEET_EPOCHS epochs of the reference's event mix: in each epoch after
    the first, about a tenth of the fleets see an arrival (with its
    profile), a departure, an SLA edit or a capacity change; a fleet
    arrives at FLEET_ARRIVE_AT and one leaves at FLEET_DEPART_AT.  Events
    name fleets by their current index; ``fleet_events`` turns each epoch
    into the package's events when it is handed out."""
    names = [[s["name"] for s in d[1]] for d in drawn]
    epochs, fresh = [[]], 0
    for e in range(1, FLEET_EPOCHS):
        events = []
        for b in rng.choice(len(names), size=len(names) // 10,
                            replace=False):
            b = int(b)
            kind = int(rng.integers(4))
            if kind == 0:
                comp, coll = rng.uniform(0.2, 1.8), rng.uniform(0.1, 0.9)
                spec = dict(name=f"arr{fresh}", arch_id="qwen3-8b",
                            shape="train_4k",
                            deadline_s=float(rng.uniform(15.0, 120.0)),
                            H_up=int(rng.integers(8, 21)),
                            H_low=int(rng.integers(2, 9)),
                            penalty_per_job=float(rng.uniform(15000.0,
                                                              30000.0)),
                            tp_required=int(rng.choice(FLEET_TP)))
                fresh += 1
                names[b].append(spec["name"])
                events.append(("arrive", b, spec,
                               (float(comp), float(coll), 1.0)))
            elif kind == 1 and len(names[b]) > 2:
                events.append(("depart", b, names[b].pop(
                    int(rng.integers(len(names[b]))))))
            elif kind == 2:
                events.append(("edit", b, names[b][int(rng.integers(
                    len(names[b])))], {"deadline_s": float(rng.uniform(
                        20.0, 120.0))}))
            else:
                events.append(("capacity", b, float(rng.uniform(0.9, 1.2))))
        if e == FLEET_ARRIVE_AT:
            events.append(("fleet-arrive", newcomer))
            names.append([s["name"] for s in newcomer[1]])
        if e == FLEET_DEPART_AT:              # one of the first fleets
            b = int(rng.integers(len(names) - 1))
            events.append(("fleet-depart", b))
            del names[b]
        epochs.append(events)
    return epochs


def fleet_events(epochs, fleets):
    """The package's epochs of events, tracking the current fleet order in
    ``fleets``: tenants and fleets are built when their epoch is handed
    out, and a capacity change scales its fleet's current R."""
    from repro_torch.cluster import TenantSpec
    for events in epochs:
        out = []
        for ev in events:
            if ev[0] == "capacity":
                out.append(("capacity", ev[1],
                            int(round(fleets[ev[1]].R * ev[2]))))
            elif ev[0] == "fleet-arrive":
                f = fleet_of(ev[1])
                fleets.append(f)
                out.append(("fleet-arrive", f))
            elif ev[0] == "fleet-depart":
                del fleets[ev[1]]
                out.append(ev)
            elif ev[0] == "arrive":
                out.append(("arrive", ev[1], TenantSpec(**ev[2]), ev[3]))
            else:
                out.append(ev)
        yield out


def fleet_stream(counters, kernel, tally, drawn, epochs, sweep_fn):
    """One ``epoch_stream`` over the phase's epochs under one
    configuration: every epoch timed, compactions recorded from the
    session's reports, one launch a loop step (the slowest resolved
    lane's iterations a flush).  Returns the allocations, walls, the
    post-event fleets and the flushes' numbers."""
    from repro_torch.cluster import epoch_stream
    from repro_torch.core import engine as eng
    fleets = [fleet_of(d) for d in drawn]
    current = list(fleets)
    flushes = []
    flush = eng.WindowSession.flush

    def spy(self):
        rep = flush(self)
        res = torch.as_tensor(rep.resolved, device=rep.iters.device)
        flushes.append((rep.slot_map is not None,
                        int(rep.iters[res].max()) if rep.resolved.any()
                        else 0, int(res.sum()), rep.batch_size))
        return rep

    eng.WindowSession.flush = spy
    allocs, walls = [], []
    try:
        stream = epoch_stream(fleets, fleet_events(epochs, current),
                              n_max=FLEET_STREAM_N_MAX, sweep_fn=sweep_fn,
                              compact_below=FLEET_COMPACT)
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = {fn.__name__: fn.launches for fn in counters}
            out = next(stream, None)
            torch.cuda.synchronize()
            if out is None:
                break
            walls.append(time.perf_counter() - t0)
            moved = {k: fn.launches - before[k] for fn in counters
                     for k in [fn.__name__] if fn.launches != before[k]}
            n = moved.pop(kernel.__name__, 0) if kernel is not None else 0
            if kernel is not None:
                tally[kernel.__name__] = tally.get(kernel.__name__, 0) + n
            if moved or (kernel is not None and n != flushes[-1][1]):
                raise AssertionError(
                    f"phase 10 stream epoch {len(allocs)}: {n} launches "
                    f"for {flushes[-1][1]} loop steps; others {moved}")
            allocs.append(out)
    finally:
        eng.WindowSession.flush = flush
    return allocs, walls, current, flushes


def phase_fleet(counters):
    """Phase 10: the fleet simulator (``repro_torch.cluster``) at the
    paper's Sec. 5.3 scale: FLEET_B fleets of FLEET_N_LO-FLEET_N_HI tenants
    each, drawn from a numpy seed.  Gates (a)-(e) of the module docstring;
    prints (f).  Every count is set to 0 when the phase starts; the kernel
    checks' launches are not counted."""
    from repro_torch.cluster import TenantSpec, epoch_batch, epoch_stream
    from repro_torch.core import InfeasibleError, lane_mesh, sharding
    from repro_torch.core import stack_scenarios
    from repro_torch.kernels.gnep_sweep.kernel import rm_sweep_batched
    from repro_torch.kernels.gnep_sweep.ops import make_batched_sweep_fn
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    ns = rng.integers(FLEET_N_LO, FLEET_N_HI + 1, FLEET_B)
    drawn = [fleet_draw(rng, int(n), f"f{b}") for b, n in enumerate(ns)]
    profiles = [d[2] for d in drawn]
    n_tenants = int(ns.sum())
    print(f"phase 10: the fleet simulator, {FLEET_B} fleets of "
          f"{int(ns.min())}-{int(ns.max())} tenants ({n_tenants} in all), "
          f"total_chips = round({FLEET_CF} * sum r_up), f64")
    for fn in counters:
        fn.launches = 0
    tally = {}
    sweep = make_batched_sweep_fn()
    configs = {"default": (None, None),
               "sweep": (sweep, rm_sweep_batched)}

    def batch_epoch(sweep_fn, kernel, fleets=None, **kw):
        """epoch_batch of the drawn fleets (built afresh, their profiles
        passed) or of ``fleets``, counting the kernel's launches."""
        if fleets is None:
            fleets = [fleet_of(d) for d in drawn]
            kw["profiles"] = profiles
        if kernel is None:
            before = {fn.__name__: fn.launches for fn in counters}
            out = epoch_batch(fleets, **kw)
            if any(fn.launches != before[fn.__name__] for fn in counters):
                raise AssertionError("phase 10: the default configuration "
                                     "launched a kernel")
            return out, 0
        return counted(tally, kernel, epoch_batch, fleets, sweep_fn=sweep_fn,
                       **kw)

    # (a) both configurations, one launch a loop step
    allocs, walls = {}, {}
    for name, (fn, kernel) in configs.items():
        allocs[name], n = batch_epoch(fn, kernel)
        iters = [a.iters for a in allocs[name]]
        if kernel is not None and n != max(iters):
            raise AssertionError(f"phase 10 (a) {name}: {n} launches for "
                                 f"{max(iters)} loop steps")
        walls[name] = wall_s(lambda: batch_epoch(fn, kernel))
        print(f"  (a) epoch_batch {name}: iterations {min(iters)}-"
              f"{max(iters)}, {n} launches, wall (median of 3) "
              f"{walls[name]!r} s")
    bad = alloc_diff(allocs["sweep"], allocs["default"], 1e-9)
    print(f"  (a) sweep against default: differs in {bad or 'nothing'} "
          "(chips, h, meshes, iterations exact; totals within 1e-9)")
    if bad:
        raise AssertionError(f"phase 10 (a): the sweep epoch differs in "
                             f"{bad}")
    if not all(a.feasible for a in allocs["default"]):
        raise AssertionError("phase 10 (a): an infeasible fleet")
    scns = [fleet_of(d).scenario() for d in drawn]
    batch = stack_scenarios(scns, device=scns[0].A.device)
    err = loop_kernel_checks(
        sharding.pad_batch_lanes(batch, sharding.padded_lane_count(
            FLEET_B, FLEET_SHARDS)), "sweep",
        f"(a) one fleet epoch's batch ({FLEET_B} fleets and "
        f"{sharding.padded_lane_count(FLEET_B, FLEET_SHARDS) - FLEET_B} "
        f"inert lanes, {batch.n_max} tenants")

    # (b) sampled fleets against their own epoch()
    sample = [int(b) for b in rng.choice(FLEET_B, FLEET_SAMPLED,
                                         replace=False)]
    base = allocs["default"]
    for b in sample:
        single = fleet_of(drawn[b]).epoch()
        single.method = base[b].method
        bad = alloc_diff([single], [base[b]], 1e-9)
        if bad and set(bad) != {"iters"}:
            raise AssertionError(f"phase 10 (b) fleet {b}: epoch() differs "
                                 f"from epoch_batch in {bad}")
    print(f"  (b) fleets {sample}: each one's epoch() equals its lane of "
          "epoch_batch (chips, h, meshes; total within 1e-9)")

    # (c) a 3-shard lane mesh, bit for bit
    mesh = lane_mesh(devices=["cuda:0"] * FLEET_SHARDS)
    for name, (fn, kernel) in configs.items():
        got, n = batch_epoch(fn, kernel, mesh=mesh)
        steps = shard_steps(torch.tensor([a.iters for a in got]),
                            FLEET_SHARDS, inert=1)
        bad = alloc_diff(got, allocs[name], 0.0)
        print(f"  (c) epoch_batch {name} on {FLEET_SHARDS} shards: "
              f"{n} launches (the shards' loop steps: "
              f"{steps if kernel else 0}); differs from the unsharded "
              f"epoch in {bad or 'nothing'}")
        if bad or (kernel is not None and n != steps):
            raise AssertionError(f"phase 10 (c) {name}: {bad}, {n} "
                                 f"launches for {steps} steps")

    # (d) failure, restore and straggler on one sampled fleet
    f = fleet_of(drawn[sample[0]])
    a0 = f.epoch()
    k = int(FLEET_FAIL * f.R)
    a1 = f.fail_nodes(k)
    if not (sum(a1.chips.values()) <= f.R
            and a1.total_cost >= a0.total_cost - 1e-6):
        raise AssertionError(f"phase 10 (d): after fail_nodes({k}) chips "
                             f"{sum(a1.chips.values())} of R={f.R}, cost "
                             f"{a1.total_cost} from {a0.total_cost}")
    a2 = f.restore_nodes(k)
    if a2 != a0:
        raise AssertionError("phase 10 (d): restore_nodes did not return "
                             "the first allocation")
    name = f.tenants[0].name
    a3 = f.mark_straggler(name, 1.3)
    twin = fleet_of(drawn[sample[0]])
    twin.tenants[0].straggler_factor = 1.3
    (a4,), _ = batch_epoch(None, None, fleets=[twin])
    a3.method = a4.method
    bad = alloc_diff([a3], [a4], 1e-9)
    if bad and set(bad) != {"iters"}:
        raise AssertionError(f"phase 10 (d): mark_straggler differs from "
                             f"epoch_batch in {bad}")
    for call in (lambda g: g.epoch(), lambda g: epoch_batch([g, f])):
        try:
            call(fleet_of((1, drawn[0][1], drawn[0][2])))
        except InfeasibleError:
            continue
        raise AssertionError("phase 10 (d): a fleet of 1 chip was solved")
    print(f"  (d) fleet {sample[0]} (R={f.R}): fail_nodes({k}) chips "
          f"{sum(a1.chips.values())}, cost {a0.total_cost!r} -> "
          f"{a1.total_cost!r}; restore_nodes returns the first allocation; "
          f"mark_straggler({name!r}, 1.3) chips {a0.chips[name]} -> "
          f"{a3.chips[name]}, equal to epoch_batch; {len(f.history)} epochs "
          "in its history; a fleet of 1 chip raises InfeasibleError in "
          "epoch and epoch_batch")

    # (e) the stream, under both configurations
    newcomer = fleet_draw(rng, int(rng.integers(FLEET_N_LO, FLEET_N_HI + 1)),
                          "new")
    epochs = fleet_stream_epochs(rng, drawn, newcomer)
    kinds = sorted({ev[0] for evs in epochs for ev in evs})
    stream = {}
    for name, (fn, kernel) in configs.items():
        got, ws, current, flushes = fleet_stream(counters, kernel, tally,
                                                 drawn, epochs, fn)
        fresh, _ = batch_epoch(fn, kernel, [fleet_copy(f) for f in current])
        compactions = sum(c for c, *_ in flushes)
        hist = [len(f.history) for f in current]
        want_hist = [FLEET_EPOCHS] * len(current)
        want_hist[-1] = FLEET_EPOCHS - FLEET_ARRIVE_AT
        bad = alloc_diff(got[-1], fresh, 1e-6)
        bad = [b for b in bad if b != "iters"]
        steps = [s for _, s, _, _ in flushes]
        print(f"  (e) epoch_stream {name}: {len(got)} epochs of {kinds}, "
              f"{compactions} compactions, lanes {flushes[0][3]} -> "
              f"{flushes[-1][3]}, resolved lanes a flush "
              f"{min(r for *_, r, _ in flushes)}-"
              f"{max(r for *_, r, _ in flushes)}, loop steps {min(steps)}-"
              f"{max(steps)}; median epoch {statistics.median(ws)!r} s, "
              f"{len(ws) / sum(ws)!r} epochs/s; the last epoch differs from "
              f"a fresh epoch_batch in {bad or 'nothing'} (chips, h exact; "
              "totals within 1e-6)")
        if (bad or compactions < 1 or hist != want_hist
                or len(got) != FLEET_EPOCHS):
            raise AssertionError(f"phase 10 (e) {name}: {bad}, "
                                 f"{compactions} compactions, histories "
                                 f"{sorted(set(hist))}")
        stream[name] = dict(epochs_per_s=len(ws) / sum(ws),
                            median_epoch_s=statistics.median(ws))
    fleets = [fleet_of(d) for d in drawn[:2]]
    dup = TenantSpec(**drawn[0][1][0])
    try:
        list(epoch_stream(fleets, [[("arrive", 0, dup)]]))
    except ValueError as e:
        if "already has a tenant" not in str(e):
            raise
        print(f"  (e) a duplicate tenant name is refused: {e}")
    else:
        raise AssertionError("phase 10 (e): a duplicate tenant was admitted")
    launches = tally.get("rm_sweep_batched", 0)
    others = {fn.__name__: fn.launches for fn in counters
              if fn.__name__ != "rm_sweep_batched" and fn.launches}
    if others:
        raise AssertionError(f"phase 10: another kernel launched: {others}")

    # (f) one epoch_batch's idle share
    fleets = [fleet_of(d) for d in drawn]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counted(tally, rm_sweep_batched, epoch_batch, fleets,
                profiles=profiles, sweep_fn=sweep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle, busy = report_idle(prof, wall, "one sweep epoch_batch")
    launches = tally["rm_sweep_batched"]
    took = time.perf_counter() - t_phase
    print(f"  phase 10: {launches} rm_sweep_batched launches; {took!r} s")
    return dict(launches=launches, walls=walls, stream=stream, idle=idle,
                busy=busy, err=err, tenants=n_tenants,
                iters=sorted({a.iters for a in allocs["default"]}))


def fleet_copy(f):
    """A fleet with the same tenants, capacity and profiles, no history."""
    return fleet_of((f.R, [dataclasses.asdict(t) for t in f.tenants],
                     f._profiles))


# --------------------------------------------------------------------------
# phase 11: the training path
# --------------------------------------------------------------------------


def _pairs(a, b):
    """Leaves of two trees of one structure, side by side."""
    return zip(_leaves(a), _leaves(b))


def _moments(mu):
    """The first moments ``m`` of an AdamW state tree, in leaf order."""
    if isinstance(mu, dict) and "m" in mu:
        return [mu["m"]]
    kids = mu.values() if isinstance(mu, dict) else mu
    return [m for kid in kids for m in _moments(kid)]


def _ulps_of_scale(got, want):
    """max |got - want| in ULPs of want's dtype at the largest |want|."""
    eps = torch.finfo(want.dtype).eps
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    return err / (max(scale, torch.finfo(want.dtype).tiny) * eps)


def lm_batch(cfg, gen, B, T, device="cuda"):
    """Random tokens with their next tokens as targets."""
    toks = torch.randint(0, cfg.vocab, (B, T + 1), generator=gen,
                         device=device)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def train_loss_check(flash, device="cuda"):
    """(a) ``loss_fn`` at Qwen3-0.6B's full size under no_grad, 8 chunks,
    with and without a mask zeroing a quarter of the positions, against
    the unchunked f32 cross entropy over ``forward``'s logits; one flash
    launch a layer in each pass."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, loss_fn
    cfg = get_config(LOSS_ARCH)
    B, S = LOSS_B, LOSS_S
    chunks = math.gcd(S, cfg.loss_chunks)
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    params = init_params(cfg, gen, device=device)
    batch = lm_batch(cfg, gen, B, S, device)
    keep = torch.rand((B, S), generator=gen, device=device).argsort(-1)
    mask = keep >= S // 4                    # a quarter of each row zeroed
    n_attn = sum(1 for mixer, _ in cfg.layer_kinds() if mixer == "attn")
    print(f"phase 11 (a): loss_fn {LOSS_ARCH} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}), B {B}, S {S}, "
          f"{chunks} chunks, against an unchunked f32 cross entropy")
    launches = {}
    routes0 = dict(flash.route_launches)
    with torch.no_grad():
        got = {}
        for name, b in (("unmasked", batch),
                        ("masked", {**batch, "loss_mask": mask})):
            n0 = flash.launches
            loss, metrics = loss_fn(cfg, params, b)
            launches[name] = flash.launches - n0
            got[name] = (loss, metrics)
        n0 = flash.launches
        logits, _, _ = forward(cfg, params, batch)
        launches["forward"] = flash.launches - n0
        tgt = batch["targets"][..., None]
        nll = (torch.logsumexp(logits.float(), -1)
               - logits.float().gather(-1, tgt)[..., 0])
        del logits
        want = {"unmasked": nll.mean(),
                "masked": (nll * mask).sum() / mask.sum()}
    for name, (loss, metrics) in got.items():
        rel = float((loss - want[name]).abs() / want[name].abs())
        print(f"  {name}: loss {float(loss)!r} (nll {float(metrics['nll'])!r},"
              f" aux {float(metrics['aux'])!r}), unchunked "
              f"{float(want[name])!r}, rel {rel!r}")
        if not (torch.isfinite(loss) and rel <= 1e-5):
            raise AssertionError(f"phase 11 (a) {name}: the chunked loss "
                                 f"departs from the unchunked one by {rel}")
    print(f"  flash launches: {launches} (one a layer, {n_attn})")
    if any(n != n_attn for n in launches.values()):
        raise AssertionError(f"phase 11 (a): flash launches {launches}, "
                             f"expected {n_attn} a pass")
    fwd_routes_moved(flash, routes0, "tensor_cores" if cfg.dtype
                     == "bfloat16" else "split_tf32", f"phase 11 (a) "
                     f"{LOSS_ARCH} {cfg.dtype}")
    return cfg, params, batch, sum(launches.values())


@contextlib.contextmanager
def recurrent_wkv():
    """``time_mix``'s WKV at 2 <= T <= chunk (the wrapper at chunk 1) on
    the plain recurrence ``wkv_recurrent`` instead, as before the kernels
    took it: a step on the card with no WKV kernel at that length."""
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.models import rwkv

    def wkv(r, k, v, w, u, *, chunk=64, S0=None):
        if chunk == 1:
            return rwkv.wkv_recurrent(r, k, v, w, u, S0)
        return saved(r, k, v, w, u, chunk=chunk, S0=S0)
    saved = wk.wkv6
    wk.wkv6 = wkv
    try:
        yield
    finally:
        wk.wkv6 = saved


@contextlib.contextmanager
def forced_bwd_route(how):
    """Every ``wkv6_bwd`` call on route ``how`` (the per-head route takes
    any chunk)."""
    from repro_torch.kernels.rwkv6 import kernel as wk
    saved = wk.bwd_route
    wk.bwd_route = lambda *a: how
    try:
        yield
    finally:
        wk.bwd_route = saved


def _step_agreement(label, a, b, loss_rel, leaf_rel):
    """A grad step's loss and gradients against another's: the loss within
    ``loss_rel`` relative, every leaf within ``leaf_rel`` of its largest
    |g|; returns (loss rel, worst leaf rel)."""
    (ga, la), (gb, lb) = a, b
    rel = float((la.float() - lb.float()).abs() / lb.float().abs())
    worst, at = max((float((x.float() - y.float()).abs().max()
                           / y.float().abs().max().clamp_min(1e-30)), i)
                    for i, (x, y) in enumerate(_pairs(ga, gb)))
    same = sum(bitwise(x, y) for x, y in _pairs(ga, gb))
    print(f"  {label}: loss {float(la)!r} / {float(lb)!r} (rel {rel!r}), "
          f"{same} of {len(list(_leaves(ga)))} gradient leaves bit for bit, "
          f"worst leaf {at} at {worst!r} of its largest |g|")
    if not (rel <= loss_rel and worst <= leaf_rel):
        raise AssertionError(f"{label}: loss rel {rel}, worst leaf {worst}")
    return rel, worst


def train_step_check(counters, device="cuda"):
    """(c) the full-width RWKV6-7B train step at T 256, whose WKV runs the
    kernels at chunk 1 (T <= chunk), held to the same step with the WKV on
    the plain recurrence, and (d) AdamW against the CPU."""
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (_stack_micro, make_grad_step,
                                          make_train_step)
    from repro_torch.models import LOCAL
    from repro_torch.models import init_params
    from repro_torch.optim import OptConfig, adamw_init, adamw_update
    from repro_torch.utils import tree_map
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS,
                                         grad_accum=TRAIN_ACCUM)
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    params = init_params(cfg, gen, device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    B, T = TRAIN_B, TRAIN_T
    chunk = math.gcd(T, max(256, T // 128))
    print(f"phase 11 (c): {TRAIN_ARCH} at full width ({TRAIN_LAYERS} of "
          f"{get_config(TRAIN_ARCH).n_layers} layers: depth cut; d "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}), "
          f"{n_params} parameters; B {B}, T {T} (WKV chunk {chunk}: T <= "
          f"chunk, the kernels at chunk 1), grad_accum {cfg.grad_accum}, "
          f"remat {cfg.remat}")
    if T > chunk:
        raise AssertionError("phase 11 (c): the train step would take the "
                             f"wrapper at chunk {chunk}")
    batch = lm_batch(cfg, gen, B, T, device)
    micro = _stack_micro(batch, cfg.grad_accum)
    mbs = [{k: v[i] for k, v in micro.items()}
           for i in range(cfg.grad_accum)]
    counts0 = {fn.__name__: fn.launches for fn in counters}
    routes0 = (dict(wk.wkv6.route_launches),
               dict(wk.wkv6_bwd.route_launches))

    # remat: the loss bit for bit, the gradients within one bf16 ULP of
    # each leaf's largest |g| (each gradient is rounded to the parameters'
    # bf16 once; recomputation reruns the same kernels on the same inputs)
    grads = {}
    for remat in ("none", "dots", "full"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g, loss, _ = make_grad_step(cfg.replace(remat=remat),
                                    LOCAL)(params, mbs[0])
        torch.cuda.synchronize()
        grads[remat] = (g, loss)
        print(f"  grad step remat={remat}: loss {float(loss)!r}, "
              f"{time.perf_counter() - t0!r} s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9!r} GB")
    for remat in ("dots", "full"):
        g, loss = grads[remat]
        if not bitwise(loss, grads["none"][1]):
            raise AssertionError(f"phase 11 (c): remat={remat} changes the "
                                 "loss")
        worst = max(_ulps_of_scale(a, b) for a, b in
                    _pairs(g, grads["none"][0]))
        same = sum(bitwise(a, b) for a, b in _pairs(g, grads["none"][0]))
        print(f"  remat={remat} vs none: loss bit for bit, {same} of "
              f"{len(list(_leaves(g)))} gradient leaves bit for bit, worst "
              f"{worst!r} bf16 ULPs of a leaf's largest |g|")
        if not worst <= 1.0:
            raise AssertionError(f"phase 11 (c): remat={remat} gradients "
                                 f"depart by {worst} bf16 ULPs")
    # the same grad step with the WKV on the plain recurrence, as before
    # the kernels took T <= chunk.  In f32 (the weights cast, the same
    # batch) only the WKV's f32 sums differ: within 1e-3 of each leaf's
    # largest |g| (u's and w0's gradients sum 256 tokens' terms that cancel
    # to a few 1e-3 of them).  In the phase's bf16 the activations after
    # the WKV round either way and the layers after them see other inputs
    # (u's gradient moved 1.8 % there, its sum cancelling): within 5e-2,
    # the loss within 1e-3
    t0 = time.perf_counter()
    with recurrent_wkv():
        g, loss, _ = make_grad_step(cfg.replace(remat="none"),
                                    LOCAL)(params, mbs[0])
        torch.cuda.synchronize()
    print(f"  grad step remat=none on wkv_recurrent: "
          f"{time.perf_counter() - t0!r} s")
    recurrence = {"bf16": _step_agreement(
        "bf16: kernels at chunk 1 vs wkv_recurrent", grads["none"],
        (g, loss), 1e-3, 5e-2)}
    del grads, g
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32",
                        remat="none")
    p32 = tree_map(lambda t: t.float(), params)
    step32 = make_grad_step(cfg32, LOCAL)
    g32, loss32, _ = step32(p32, mbs[0])
    with recurrent_wkv():
        g, loss, _ = step32(p32, mbs[0])
    recurrence["f32"] = _step_agreement(
        "f32: kernels at chunk 1 vs wkv_recurrent", (g32, loss32),
        (g, loss), 1e-5, 1e-3)
    del g32, g, p32
    torch.cuda.empty_cache()

    # the accumulated gradient: one f32-tier train step against AdamW on
    # the mean of the two microbatches' grad steps
    oc = OptConfig(schedule="const", warmup_steps=1, state_dtype="f32")
    gstep = make_grad_step(cfg, LOCAL)
    outs = [gstep(params, mb) for mb in mbs]
    two = torch.full((), 2.0, device=device)
    it = iter([(torch.zeros(a.shape, device=device) + a.float() + b.float())
               / two for a, b in _pairs(outs[0][0], outs[1][0])])
    mean = tree_map(lambda _: next(it), params)
    mean_loss = (outs[0][1] + outs[1][1]) / two
    del outs
    state0 = adamw_init(params, oc)
    _, s_a, m_a = make_train_step(cfg, LOCAL, oc)(params, state0, batch)
    m_step = _moments(s_a["mu"])
    del s_a
    _, s_b, m_b = adamw_update(params, mean, state0, oc)
    m_mean = _moments(s_b["mu"])
    del s_b, state0
    worst = max(_ulps_of_scale(a, b) for a, b in zip(m_step, m_mean))
    same = sum(bitwise(a, b) for a, b in zip(m_step, m_mean))
    print(f"  accumulated gradient (first moment after one step) against "
          f"the microbatches' mean: {same} of {len(m_step)} leaves bit for "
          f"bit, worst {worst!r} f32 ULPs of a leaf's largest; loss "
          f"{float(m_a['loss'])!r} / {float(mean_loss)!r}, grad norm "
          f"{float(m_a['grad_norm'])!r} / {float(m_b['grad_norm'])!r}")
    if not (worst <= 4.0 and _ulps_of_scale(m_a["loss"], mean_loss) <= 4.0):
        raise AssertionError("phase 11 (c): the accumulated gradient is not "
                             "the microbatches' mean")
    del m_step, m_mean

    # 8 steps of each state tier on the one batch
    steps = {}
    for tier in ("f32", "bf16", "int8"):
        oc = OptConfig(schedule="const", warmup_steps=1, state_dtype=tier)
        step = make_train_step(cfg, LOCAL, oc)
        torch.cuda.reset_peak_memory_stats()
        p, s = params, adamw_init(params, oc)
        losses, walls = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, s, m = step(p, s, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated() / 1e9
        step_ms = statistics.median(walls[1:]) * 1e3
        steps[tier] = dict(losses=losses, step_ms=step_ms, peak_gb=peak,
                           tok_s=B * T / step_ms * 1e3)
        print(f"  tier {tier}: losses {losses}; step_ms={step_ms!r} "
              f"(median of steps 2-{TRAIN_STEPS}; first "
              f"{walls[0] * 1e3!r}) tokens_s={steps[tier]['tok_s']!r} "
              f"peak_gb={peak!r}")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"phase 11 (c) {tier}: losses {losses}")
        del p, s
    # where a step's time goes: one f32-tier step under the profiler
    from torch.profiler import ProfilerActivity, profile
    oc = OptConfig(schedule="const", warmup_steps=1, state_dtype="f32")
    state, step = adamw_init(params, oc), make_train_step(cfg, LOCAL, oc)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del state
    idle, busy = report_idle(prof, wall, "one f32-tier train step", rows=8)
    idle_warm = None
    if busy is not None:
        idle_warm = 1.0 - busy / (steps["f32"]["step_ms"] / 1e3)
        print(f"  device busy over the unprofiled f32 step "
              f"({steps['f32']['step_ms']!r} ms): idle_share={idle_warm!r}")
    moved = {fn.__name__: fn.launches - counts0[fn.__name__]
             for fn in counters}
    by_route = ({h: wk.wkv6.route_launches[h] - routes0[0][h]
                 for h in routes0[0]},
                {h: wk.wkv6_bwd.route_launches[h] - routes0[1][h]
                 for h in routes0[1]})
    print(f"  launches in (c): {moved}; wkv6 by route {by_route[0]}, "
          f"wkv6_bwd by route {by_route[1]}")
    if not (moved["wkv6"] > 0 and moved["wkv6_bwd"] > 0
            and by_route[0]["tile-parallel"] == moved["wkv6"]
            and by_route[1]["tile-parallel"] == moved["wkv6_bwd"]
            and moved["flash_attention"] == moved["flash_attention_bwd"] == 0):
        raise AssertionError("phase 11 (c): the T 256 step did not run the "
                             "tile-parallel wkv6 kernels both ways alone")
    adamw_against_cpu(cfg, params, mean)
    return dict(params=n_params, steps=steps, idle=idle, idle_warm=idle_warm,
                recurrence=recurrence, launches=moved)


def adamw_against_cpu(cfg, params, grads):
    """(d) one ``adamw_update`` of each tier on the card and on the CPU
    from (c)'s first parameters and accumulated gradient, copied to numpy
    in JAX's layout (``convert.lm_params_to_numpy``) and back onto the
    CPU, restricted to layer 0 (a quarter of the parameters: the CPU
    update of all of them would take minutes).  Its leaves include ``u``
    (64 wide) and the token-shift LoRA (160 wide), whose last axes are not
    multiples of the int8 block of 256."""
    from repro_torch import convert
    from repro_torch.optim import OptConfig, adamw_init, adamw_update
    sub_p = {"layers": [params["layers"][0]]}
    sub_g = {"layers": [grads["layers"][0]]}
    cpu_p, cpu_g = (
        {"layers": [convert.lm_params_from_numpy(
            cfg, convert.lm_params_to_numpy(cfg, t),
            device="cpu")["layers"][0]]} for t in (params, grads))
    ragged = sorted({t.shape[-1] for t in _leaves(sub_p)
                     if t.shape[-1] % 256})
    print(f"phase 11 (d): adamw_update on the card and on the CPU, "
          f"{sum(t.numel() for t in _leaves(sub_p))} parameters (layer 0; "
          f"last axes {ragged} not multiples of 256)")
    if not all(bitwise(a.cpu(), b) for a, b in _pairs((sub_p, sub_g),
                                                      (cpu_p, cpu_g))):
        raise AssertionError("phase 11 (d): the numpy copies changed a bit")
    for tier in ("f32", "bf16", "int8"):
        oc = OptConfig(schedule="const", warmup_steps=1, state_dtype=tier)
        p1, s1, m1 = adamw_update(sub_p, sub_g, adamw_init(sub_p, oc), oc)
        p2, s2, m2 = adamw_update(cpu_p, cpu_g, adamw_init(cpu_p, oc), oc)
        worst, q_diff, q_ties = 0.0, 0, 0
        for a, b in _pairs((p1, s1["mu"]), (p2, s2["mu"])):
            a = a.cpu()
            if a.dtype == torch.int8:
                d = (a.int() - b.int()).abs()
                q_diff = max(q_diff, int(d.max()))
                q_ties += int((d > 0).sum())
            else:
                worst = max(worst, _ulps_of_scale(a, b))
        print(f"  tier {tier}: worst {worst!r} ULPs (of each leaf's dtype) "
              f"of a leaf's largest |value|; grad norm card "
              f"{float(m1['grad_norm'])!r} cpu {float(m2['grad_norm'])!r}; "
              f"lr {float(m1['lr'])!r} / {float(m2['lr'])!r}"
              + (f"; int8 q: {q_ties} values differ, by at most {q_diff}"
                 if tier == "int8" else ""))
        # the norm's sum order differs, so the clip factor can differ by
        # an ULP or two, and every update with it
        if not (worst <= 8.0 and q_diff <= 1):
            raise AssertionError(f"phase 11 (d) {tier}: the card's AdamW "
                                 "departs from the CPU's")
        del p1, s1, p2, s2


def grad_ms(out, inputs, cot, reps):
    """Mean ms of one backward through a recorded graph (kept)."""
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, cot,
                                               retain_graph=True), reps)


def sdpa_bwd_graph_ms(q, k, v, cot, causal, reps):
    """Device ms of SDPA's backward (a yardstick the port never calls):
    forward and backward in a CUDA graph, less the forward alone in one,
    so the host's time between kernels counts in neither."""
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    both = graph_ms(lambda: torch.autograd.grad(sdpa(*leaves, causal),
                                                leaves, cot), reps)
    return both - graph_ms(lambda: sdpa(*leaves, causal), reps)


def report_kernels(prof, words):
    """Print the profiled kernels whose names hold one of ``words``."""
    for e in prof.key_averages():
        if e.self_device_time_total > 0 and any(w in e.key for w in words):
            print(f"  kernel {e.key[:100]}: calls={e.count} "
                  f"device_ms={e.self_device_time_total / 1e3!r}")


def ptxas_usage(log, word):
    """{entry function: its ptxas line of registers and spills} for the
    entries in a build log whose mangled names hold ``word``."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            entry = name if word in name else None
        elif entry and ("spill" in ln or "registers" in ln):
            out[entry] = (out.get(entry, "") + " " + ln.split(":", 1)[-1]
                          .strip()).strip()
    return out


def fwd_routes_moved(flash, n0, route, label):
    """The forward's launches by route since ``n0`` (its ``route_launches``
    then); raise unless all ran ``route``, at least one."""
    moved = {r: n - n0[r] for r, n in flash.route_launches.items()}
    print(f"  {label}: flash forward launches by route {moved}")
    if moved[route] < 1 or any(n for r, n in moved.items() if r != route):
        raise AssertionError(f"{label}: the forward did not run only the "
                             f"{route} route")
    return moved


def flash_bwd_check(gen):
    """(b) flash: the backward kernels' dq, dk, dv against autograd of
    ``ref.reference`` and against ``ref.backward`` fed the kernel's own
    output and logsumexp; the logsumexp against ``ref.forward_lse``; two
    calls bit for bit; one backward launch a call, on the route
    ``kernel.route`` names (``route_launches``: bf16 the wgmma
    kernels, f32 the split-TF32 ones); at each shape the kernels' ms, the
    plain version's (autograd) and SDPA's backward by CUDA events around
    the calls (host time between kernels included), the kernels' and
    SDPA's backward in CUDA graphs (``graph_ms``, ``library_graph_ms``:
    device time alone); the row's own numbers are the Qwen3-0.6B shape's,
    in bf16."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr
    print("phase 11 (b): flash_attention's backward kernels against the "
          "plain versions")
    cases = [(shape, causal, torch.bfloat16) for _, shape, causal
             in FLASH_MODELS] + [(FLASH_MAIN, True, torch.float32)] + [
        (FLASH_BWD_RAGGED, c, dt) for c in (True, False)
        for dt in (torch.float32, torch.bfloat16)] + [
        (shape, c, torch.bfloat16) for shape in FLASH_BWD_TC_RAGGED
        for c in (True, False)] + [
        (FLASH_HD32_FULL, True, dt) for dt in (torch.float32, torch.bfloat16)]
    errs, timed = [], {}
    for shape, causal, dtype in cases:
        B, S, Hq, Hkv, hd = shape
        q, k, v = flash_inputs(gen, *shape, dtype)
        do = torch.randn((B, S, Hq, hd), generator=gen,
                         device="cuda").to(dtype)
        route = fk.route(q)
        label = (f"flash bwd {shape} {str(dtype)[6:]} causal={causal} "
                 f"route={route}")
        if route != ("tensor_cores" if dtype == torch.bfloat16
                     else "split_tf32"):
            raise AssertionError(f"{label}: not the dtype's backward route")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n_fwd, n_bwd = fk.flash_attention.launches, \
            fk.flash_attention_bwd.launches
        by_route = dict(fk.flash_attention_bwd.route_launches)
        o = fk.flash_attention(*leaves, causal=causal)
        got = torch.autograd.grad(o, leaves, do)
        moved = {r: n - by_route[r]
                 for r, n in fk.flash_attention_bwd.route_launches.items()}
        print(f"  {label}: backward launches by route {moved}")
        if (fk.flash_attention.launches - n_fwd,
                fk.flash_attention_bwd.launches - n_bwd) != (1, 1) or \
                moved != {r: int(r == route) for r in moved}:
            raise AssertionError(f"{label}: forward / backward launches "
                                 "did not move by one each, on the route")
        again = torch.autograd.grad(fk.flash_attention(*leaves,
                                                       causal=causal),
                                    leaves, do)
        if not all(bitwise(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: two backward calls differ")
        lse = torch.empty((B, Hq, S), device="cuda")
        o_k = fk._forward(q, k, v, causal, lse)
        o_p, lse_p = fr.forward_lse(q, k, v, causal=causal)
        check_close(lse, lse_p, 1e-5 * float(lse_p.abs().max()), 0.0,
                    label + " lse")
        # the same formula in the same dtype, D from the same rounded o:
        # f32 sums in another order, then one rounding to the dtype
        own = fr.backward(q, k, v, o_k, lse, do.contiguous(), causal=causal)
        rt = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
        for name, a, b in zip(("dq", "dk", "dv"), got, own):
            check_close(a, b, 1e-5 * float(b.float().abs().max()), rt,
                        f"{label} {name} vs ref.backward")
        # autograd of the dense oracle: in bf16 it forms D from the f32
        # output, where the kernel takes the bf16 one (about 2^-8 of dq's
        # and dk's scale), and rounds each gradient to bf16 once
        plain_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out_p = fr.reference(*plain_leaves, causal=causal)
        want = torch.autograd.grad(out_p, plain_leaves, do,
                                   retain_graph=True)
        at = 2.0 ** -5 if dtype == torch.bfloat16 else 1e-4
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            errs.append(check_close(a, b, at * float(b.float().abs().max()),
                                    0.0, f"{label} {name} vs autograd"))
        # the backward kernels, autograd of the plain version and of SDPA
        # (a yardstick, never on the path)
        t_k = cuda_ms(lambda: fk.flash_attention_bwd(
            q, k, v, o_k, lse, do.contiguous(), causal=causal), 10)
        t_p = grad_ms(out_p, plain_leaves, do, 3)
        lib_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out_l = sdpa(*lib_leaves, causal)
        t_l = grad_ms(out_l, lib_leaves, do, 10)
        t_kg = graph_ms(lambda: fk.flash_attention_bwd(
            q, k, v, o_k, lse, do.contiguous(), causal=causal), 10)
        t_lg = sdpa_bwd_graph_ms(q, k, v, do, causal, 10)
        ops = peaks().flash_bwd_ops(B, S, S, Hq, hd, causal)
        moved = nbytes(q, k, v, o_k, do, lse) + nbytes(*got)
        # bf16: the bf16 tensor-core rate; f32: each product as three TF32
        # products, as the f32 bounds of phase 1c count them
        rate = (peaks().BF16_FLOPS if dtype == torch.bfloat16
                else peaks().TF32_FLOPS / 3)
        b_ms, b_by = bound(moved, ops, rate)
        f32_ms = ops / peaks().FP32_FLOPS * 1e3
        # the wgmma route multiplies P and dS as two bf16 halves and forms
        # S and dP in both kernels: ten bf16 products; the split-TF32 route
        # forms S and dP in both too: seven products of three TF32 each
        split_ms = (2 * ops / peaks().BF16_FLOPS if dtype == torch.bfloat16
                    else 7 / 5 * 3 * ops / peaks().TF32_FLOPS) * 1e3
        print(f"  flash_attention_bwd {shape} {str(dtype)[6:]} causal="
              f"{causal} route={route}: ms={t_k!r} plain_ms={t_p!r} "
              f"(autograd) library_ms={t_l!r} (autograd of SDPA) "
              f"graph_ms={t_kg!r} library_graph_ms={t_lg!r} (in CUDA "
              f"graphs) "
              f"bound_ms={b_ms!r} ({b_by}, 5 products) "
              f"f32_cuda_core_floor_ms={f32_ms!r} "
              f"route_products_ms={split_ms!r}")
        timed[f"{shape} {str(dtype)[6:]} causal={causal}"] = dict(
            kernels=route, ms=t_k, plain_ms=t_p, library_ms=t_l,
            graph_ms=t_kg, library_graph_ms=t_lg, bound_ms=b_ms,
            bound_by=b_by)
    misaligned_f32_views(gen, fk)
    # the row's own numbers are the first serving shape's, the Qwen3 prefill
    main = timed[f"{FLASH_MODELS[0][1]} bfloat16 causal=True"]
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:71",
                backward_of="flash_attention", max_abs_err=max(errs),
                **main, cases=timed)


def misaligned_f32_views(gen, fk):
    """(b) f32 q, k, v as views one element into wider tensors, so no base
    is 16-byte aligned: the split-TF32 route copies them 4 bytes at a time
    and must give the contiguous copies' gradients bit for bit, on one
    launch of that route a call."""
    for shape in ((1, 1000, 4, 2, 32), (1, 1000, 4, 2, 128)):
        B, S, Hq, Hkv, hd = shape
        q, k, v = flash_inputs(gen, *shape, torch.float32)
        do = torch.randn((B, S, Hq, hd), generator=gen, device="cuda")

        def off(t):
            wide = torch.empty(t.shape[:-1] + (hd + 1,), device="cuda")
            wide[..., 1:] = t
            return wide[..., 1:]
        views = [off(t) for t in (q, k, v)]
        lse = torch.empty((B, Hq, S), device="cuda")
        o = fk._forward(q, k, v, True, lse)
        n0 = dict(fk.flash_attention_bwd.route_launches)
        got = fk.flash_attention_bwd(*views, o, lse, do, causal=True)
        moved = {r: n - n0[r]
                 for r, n in fk.flash_attention_bwd.route_launches.items()}
        want = fk.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        same = all(bitwise(a, b) for a, b in zip(got, want))
        print(f"  flash bwd {shape} float32 causal=True, q / k / v off "
              f"16-byte alignment: launches by route {moved}, gradients "
              f"{'bit for bit' if same else 'DIFFER from'} the contiguous "
              "copies'")
        if views[0].data_ptr() % 16 == 0 or not same or \
                moved != {r: int(r == "split_tf32") for r in moved}:
            raise AssertionError(f"flash bwd {shape}: misaligned f32 views "
                                 "did not run the split-TF32 route to the "
                                 "contiguous copies' bits")


def wkv_bwd_check(gen):
    """(b) wkv6: the six gradients against autograd of ``wkv_chunked``;
    two calls bit for bit; one backward launch a call, on the forward's
    route (``kernel.bwd_route``: chunks of 64 or more chunk-parallel, the
    rest tile-parallel) by ``wkv6_bwd.route_launches`` (the forward's by
    ``wkv6.route_launches``); at each shape the kernels' ms by CUDA events
    and in a CUDA graph, and autograd's of the plain version; from the
    forward's saved scratch (as a train step runs it) and each pass alone
    at the train shape and every case whose chunk is no multiple of 64 or
    runs tile-parallel; at those the per-head backward on the same inputs
    (``bwd_route_launcher``), held to the plain version and to the
    kernels' route, timed the same way, and each one's peak memory.  Then
    the ``WKV_BWD_LONG_CASES`` the same way, and a misaligned dy, which
    keeps the per-head route.  The row's own numbers are the train
    shape's."""
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.kernels.rwkv6.ref import chunked_reference
    print("phase 11 (b): wkv6's backward kernels against autograd of the "
          "chunked form")
    names = ("dr", "dk", "dv", "dw", "du", "dS0")
    errs, timed = [], {}
    for B, T, H, K, L, shift, with_state, final in (WKV_BWD_CASES
                                                    + WKV_BWD_LONG_CASES):
        r, k, v, w, u, S0 = wkv_inputs(gen, B, T, H, K, shift, True)
        if not with_state:
            S0 = torch.zeros_like(S0)
        dy = torch.randn_like(v)
        dS = torch.randn_like(S0) if final else None
        how = wk.bwd_route(r, k, v, w, dy, dS, L)
        fwd = wk.route(r, k, v, w, L)
        label = (f"wkv6 bwd B={B} T={T} H={H} K={K} chunk={L} shift={shift}"
                 f"{' S0' if with_state else ''}"
                 f"{' dS' if final else ''} route={how}")
        if how != wkv_route_of(L) or fwd != how:
            raise AssertionError(f"{label}: chunk {L} took the {fwd} "
                                 f"forward and the {how} backward route")
        # the plain version walks T / L chunks in Python: at (1, 50,000)
        # and chunk 10, 5,000 of them, some 8 s a forward
        long = T // L > 128

        def run():
            leaves = [t.clone().requires_grad_(True)
                      for t in (r, k, v, w, u, S0)]
            y, S = wk.wkv6(*leaves[:5], chunk=L, S0=leaves[5])
            outs, cots = ((y, S), (dy, dS)) if final else ((y,), (dy,))
            return torch.autograd.grad(outs, leaves, cots)
        n = (wk.wkv6.route_launches[fwd], wk.wkv6.launches,
             wk.wkv6_bwd.launches, dict(wk.wkv6_bwd.route_launches))
        got = run()
        by_route = {h: c - n[3][h]
                    for h, c in wk.wkv6_bwd.route_launches.items()}
        if (wk.wkv6.route_launches[fwd] - n[0], wk.wkv6.launches - n[1],
                wk.wkv6_bwd.launches - n[2]) != (1, 1, 1) or \
                by_route != {h: int(h == how) for h in by_route}:
            raise AssertionError(f"{label}: forward / backward launches "
                                 "did not move by one each on the route "
                                 f"(backward by route {by_route})")
        if not all(bitwise(a, b) for a, b in zip(got, run())):
            raise AssertionError(f"{label}: two backward calls differ")
        leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, S0)]
        y_p, S_p = chunked_reference(*leaves, chunk=L)
        outs, cots = ((y_p, S_p), (dy, dS)) if final else ((y_p,), (dy,))
        # autograd of the plain version: about 3 s a call at chunk 1 and
        # T 1,023; at the long cases its one held call is the one timed
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = torch.autograd.grad(outs, leaves, cots, retain_graph=not long)
        end.record()
        end.synchronize()
        # the same f32 formulas summed in another order: within 1e-4 of
        # each gradient's largest magnitude, as phase 1c holds y and S
        for name, a, b in zip(names, got, want):
            errs.append(check_close(a, b, 1e-4 * float(b.abs().max()), 0.0,
                                    f"{label} {name}"))
        call = lambda: wk.wkv6_bwd(r, k, v, w, u, S0, dy, dS, chunk=L)
        t_k = cuda_ms(call, 10)
        t_kg = graph_ms(call, 10)
        t_p = (start.elapsed_time(end) if long else
               grad_ms(outs, leaves, cots, 3 if T // L <= 128 else 1))
        del outs, leaves, y_p, S_p
        # read r, k, v, w, dy (and u, S0, dS) once, write dr, dk, dv, dw
        # (and du, dS0): no state kept a chunk, which no route needs
        moved = (nbytes(*(t for t in (r, k, v, w, u, S0, dy, dS)
                          if t is not None)) + nbytes(*got))
        ops = peaks().wkv_bwd_ops(B, T, H, K, L)
        elem = 30 * B * T * H * K
        t_ops = (3 * (ops - elem) / peaks().TF32_FLOPS
                 + elem / peaks().FP32_FLOPS) * 1e3
        b_ms, b_by = max((moved / peaks().HBM_BW * 1e3, "bytes"),
                         (t_ops, "operations"))
        f32_ms, _ = bound(moved, ops, peaks().FP32_FLOPS)
        case = dict(kernels=how, ms=t_k, graph_ms=t_kg, plain_ms=t_p,
                    bound_ms=b_ms, bound_by=b_by)
        print(f"  wkv6_bwd {(B, T, H, K)} chunk {L} route={how}: ms={t_k!r} "
              f"graph_ms={t_kg!r} plain_ms={t_p!r} (autograd) "
              f"bound_ms={b_ms!r} ({b_by}; products as split TF32) "
              f"f32_rate_bound_ms={f32_ms!r}")
        # the chunks whose backward the per-head kernels took before the
        # tile- and chunk-parallel routes did: below 64, and no multiple of
        # 64 above it
        then_per_head = how == "tile-parallel" or L % 64 != 0
        if (B, T, H, K, L) == WKV_BWD_MAIN or then_per_head:
            # the backward as a train step runs it, from the forward's
            # saved scratch; and each pass alone
            _, _, saved = wk._forward(r, k, v, w, u, S0, L)
            case["saved_ms"] = cuda_ms(lambda: wk.wkv6_bwd(
                r, k, v, w, u, S0, dy, dS, chunk=L, saved=saved), 10)
            case["saved_graph_ms"] = graph_ms(lambda: wk.wkv6_bwd(
                r, k, v, w, u, S0, dy, dS, chunk=L, saved=saved), 10)
            fwd = wk.pass_launchers(r, k, v, w, u, chunk=L, S0=S0)
            passes = {f"forward {name}": cuda_ms(fwd[name], 10)
                      for name in ("state", "prefix")}
            passes.update({name: cuda_ms(fn, 10) for name, fn in
                           wk.bwd_pass_launchers(r, k, v, w, u, dy, dS,
                                                 chunk=L, S0=S0).items()})
            case["passes_ms"] = passes
            del saved, fwd
            print(f"  wkv6_bwd {(B, T, H, K)} chunk {L} from the forward's "
                  f"saved scratch: ms={case['saved_ms']!r} graph_ms="
                  f"{case['saved_graph_ms']!r}; each pass alone (ms): "
                  f"{passes!r}")
        if then_per_head:
            # the per-head backward, which took these chunks before, on the
            # same inputs: held to the plain version and to the kernels'
            # route
            per_head = wk.bwd_route_launcher(r, k, v, w, u, dy, dS, chunk=L,
                                             how="per-head", S0=S0)
            ph = per_head()
            for name, a, b, c in zip(names, ph, want, got):
                scale = 1e-4 * float(b.abs().max())
                errs.append(check_close(a, b, scale, 0.0,
                                        f"{label} per-head {name}"))
                check_close(c, a, scale, 0.0,
                            f"{label} {how} vs per-head {name}")
            case["per_head_ms"] = cuda_ms(per_head, 3)
            case["per_head_graph_ms"] = graph_ms(per_head, 3)
            case["per_head_over_graph"] = (case["per_head_graph_ms"]
                                           / case["graph_ms"])
            del per_head, ph
            torch.cuda.empty_cache()
            # each route's peak over a call that allocates all it needs:
            # the per-head's chunk-start scratch (B, H, T / L, K, K) against
            # the tile route's tile states and cotangents (B, H, ceil(T /
            # m), K, K) or the chunk route's chunk states (B, H, T / L, K, K)
            fresh = lambda: wk.bwd_route_launcher(
                r, k, v, w, u, dy, dS, chunk=L, how="per-head", S0=S0)()
            for key, fn in (("peak_gb", call), ("per_head_peak_gb", fresh)):
                torch.cuda.synchronize()
                base_b = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                case[key] = (torch.cuda.max_memory_allocated() - base_b) / 1e9
            torch.cuda.empty_cache()
            print(f"  wkv6_bwd {(B, T, H, K)} chunk {L} per-head route: "
                  f"ms={case['per_head_ms']!r} graph_ms="
                  f"{case['per_head_graph_ms']!r} (per-head over {how} "
                  f"graph_ms: {case['per_head_over_graph']!r}); peak over a "
                  f"call (GB): {how} {case['peak_gb']!r}, per-head "
                  f"{case['per_head_peak_gb']!r}")
        timed[label] = case
        if (B, T, H, K, L) == WKV_BWD_MAIN:
            main = case
        del got, want, r, k, v, w, u, S0, dy, dS
        torch.cuda.empty_cache()
    misaligned_wkv_bwd(gen, errs)
    return dict(name="wkv6_bwd", route="cuda",
                source="src/repro_torch/csrc/wkv6_bwd.cu",
                replaces="src/repro/kernels/rwkv6/kernel.py:73",
                backward_of="wkv6", max_abs_err=max(errs), library_ms=None,
                kernels_by_route=WKV_BWD_KERNELS, **main, cases=timed)


def misaligned_wkv_bwd(gen, errs):
    """(b) a dy off a 16-byte boundary at chunk 10: the backward on the
    per-head route (one launch there, none elsewhere), held to autograd of
    the plain version and to the tile route on an aligned copy."""
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.kernels.rwkv6.ref import chunked_reference
    B, T, H, K, L = 2, 500, 4, 64, 10
    r, k, v, w, u, S0 = wkv_inputs(gen, B, T, H, K, -0.6, True)
    dy = torch.randn_like(v)
    off = offset_copy(dy)
    n0 = dict(wk.wkv6_bwd.route_launches)
    got = wk.wkv6_bwd(r, k, v, w, u, S0, off, None, chunk=L)
    moved = {h: c - n0[h] for h, c in wk.wkv6_bwd.route_launches.items()}
    label = f"wkv6 bwd {(B, T, H, K)} chunk {L}, dy off 16 bytes"
    print(f"  {label}: backward launches by route {moved}")
    if moved != {h: int(h == "per-head") for h in moved}:
        raise AssertionError(f"{label}: not one launch on the per-head route")
    aligned = wk.wkv6_bwd(r, k, v, w, u, S0, dy, None, chunk=L)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, S0)]
    y_p, _ = chunked_reference(*leaves, chunk=L)
    want = torch.autograd.grad((y_p,), leaves, (dy,))
    for name, a, b, c in zip(("dr", "dk", "dv", "dw", "du", "dS0"), got,
                             want, aligned):
        scale = 1e-4 * float(b.abs().max())
        errs.append(check_close(a, b, scale, 0.0, f"{label} {name}"))
        check_close(c, a, scale, 0.0, f"{label} tile-parallel {name}")


def _grads_bitwise(label, a, b):
    """Loss and every gradient leaf bit for bit."""
    (ga, la), (gb, lb) = a, b
    same = sum(bitwise(x, y) for x, y in _pairs(ga, gb))
    total = len(list(_leaves(ga)))
    print(f"  {label}: loss {'bit for bit' if bitwise(la, lb) else 'DIFFERS'}"
          f", {same} of {total} gradient leaves bit for bit")
    if not (bitwise(la, lb) and same == total):
        raise AssertionError(f"phase 11 (e) {label}: not bit for bit")


def kernel_train(arch, layers, B, T, kernels):
    """(e) one model's train steps through both directions of the
    kernels: exact forward and backward launch counts, a falling loss over
    KERNEL_TRAIN_STEPS steps on one batch, remat none against full bit for
    bit on one microbatch; step ms, tokens/s, peak GB, one step's idle
    share."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (_stack_micro, make_grad_step,
                                          make_train_step)
    from repro_torch.models import LOCAL
    from repro_torch.models import init_params
    from repro_torch.optim import OptConfig, adamw_init
    fwd, bwd = kernels
    full = get_config(arch)
    cfg = full.replace(grad_accum=TRAIN_ACCUM, remat="full",
                       **({} if layers is None else {"n_layers": layers}))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    params = init_params(cfg, gen, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    batch = lm_batch(cfg, gen, B, T)
    M = cfg.grad_accum
    if cfg.rwkv:
        chunk = math.gcd(T, max(256, T // 128))
        per = cfg.n_layers
        how = (f"{per} wkv6 layers, chunk {chunk} < T: per microbatch "
               f"{per} forwards + {per} recomputed (remat full) and {per} "
               "backwards")
    else:
        per = sum(1 for mixer, _ in cfg.layer_kinds() if mixer == "attn")
        how = (f"{per} attention layers: per microbatch {per} forwards + "
               f"{per} recomputed (remat full) and {per} backwards")
    want = (KERNEL_TRAIN_STEPS * M * 2 * per, KERNEL_TRAIN_STEPS * M * per)
    depth = "" if layers is None else f" of {full.n_layers}: depth cut"
    print(f"phase 11 (e): {arch} ({cfg.n_layers} layers{depth}, d "
          f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}), {n_params} "
          f"parameters; B {B} x T {T} in {M} microbatches, remat full, f32 "
          f"state tier; expected launches {KERNEL_TRAIN_STEPS} steps x {M} "
          f"microbatches x ({how}) = {want[0]} forward, {want[1]} backward")
    oc = OptConfig(schedule="const", warmup_steps=1, state_dtype="f32")
    step = make_train_step(cfg, LOCAL, oc)
    p, st = params, adamw_init(params, oc)
    n0 = (fwd.launches, bwd.launches)
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(KERNEL_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, st, m = step(p, st, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = (fwd.launches - n0[0], bwd.launches - n0[1])
    step_ms = statistics.median(walls[1:]) * 1e3
    tok_s = B * T / step_ms * 1e3
    print(f"  losses {losses}; launches {got[0]} forward, {got[1]} backward"
          f"; step_ms={step_ms!r} (median of steps 2-{KERNEL_TRAIN_STEPS}; "
          f"first {walls[0] * 1e3!r}) tokens_s={tok_s!r} peak_gb={peak!r}")
    if got != want:
        raise AssertionError(f"phase 11 (e) {arch}: launches {got}, "
                             f"expected {want}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"phase 11 (e) {arch}: losses {losses}")
    # one step under the profiler: where its time goes
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(p, st, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del p, st
    idle, busy = report_idle(prof, wall, f"one {arch} train step", rows=8)
    report_kernels(prof, ("flash_", "wkv6"))
    idle_warm = None if busy is None else 1.0 - busy / (step_ms / 1e3)
    print(f"  device busy over the unprofiled step: idle_share={idle_warm!r}")
    # remat none against full on one microbatch
    mb = {k: v[0] for k, v in _stack_micro(batch, M).items()}
    outs = {}
    for remat in ("none", "full"):
        g, loss, _ = make_grad_step(cfg.replace(remat=remat),
                                    LOCAL)(params, mb)
        outs[remat] = (g, loss)
    _grads_bitwise(f"{arch} remat none vs full", outs["none"], outs["full"])
    del outs, params
    torch.cuda.empty_cache()
    return dict(arch=arch, layers=cfg.n_layers, params=n_params, B=B, T=T,
                losses=losses, step_ms=step_ms, tok_s=tok_s, peak_gb=peak,
                idle=idle, idle_warm=idle_warm, launches=got)


def step_vs_per_head(B, T, want):
    """(e) RWKV6-7B's grad step (one microbatch) at B x T, whose chunk takes
    the ``want`` route both ways (T 1,023: chunk 1, tile-parallel; 50,000:
    chunk 10, tile-parallel; 48,000: chunk 375, chunk-parallel), against
    the same step with the backward forced onto the per-head route: the
    loss bit for bit (the same forward), the gradients within the bf16
    rounding that f32 sums in another order can flip; each step's backward
    launches on its route, its wall and its peak.  The steps run in turns,
    ``want``, per-head, ``want``: the first warms the card (its wall is
    printed, not compared), and the third must repeat it bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.launch.steps import _stack_micro, make_grad_step
    from repro_torch.models import LOCAL
    from repro_torch.models import init_params
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS,
                                         grad_accum=TRAIN_ACCUM,
                                         remat="full")
    chunk = math.gcd(T, max(256, T // 128))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    params = init_params(cfg, gen, device="cuda")
    batch = lm_batch(cfg, gen, B, T)
    M = cfg.grad_accum if B % cfg.grad_accum == 0 else 1
    mb = {k: v[0] for k, v in _stack_micro(batch, M).items()}
    step = make_grad_step(cfg, LOCAL)
    outs, walls, peak, first = {}, {}, {}, None
    for how in (want, "per-head", want):
        n0 = dict(wk.wkv6_bwd.route_launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if how == "per-head":
            with forced_bwd_route(how):
                g, loss, _ = step(params, mb)
        else:
            g, loss, _ = step(params, mb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = {h: wk.wkv6_bwd.route_launches[h] - n0[h] for h in n0}
        if moved[how] != cfg.n_layers or sum(moved.values()) != moved[how]:
            raise AssertionError(f"phase 11 (e) T {T}: backward launches by "
                                 f"route {moved}, expected {cfg.n_layers} "
                                 f"on {how}")
        if first is None:
            first = wall
        else:
            # the step's own peak: less the earlier steps' gradients held
            held = sum(nbytes(*_leaves(g_)) for g_, _ in outs.values())
            walls[how] = wall
            peak[how] = (torch.cuda.max_memory_allocated() - held) / 1e9
        if how in outs:
            _grads_bitwise(f"T {T} {how} twice", outs[how], (g, loss))
        outs[how] = (g, loss)
        del g
    print(f"  {TRAIN_ARCH} ({cfg.n_layers} layers) grad step B {B} x T {T} "
          f"(chunk {chunk}), one microbatch of {B // M}: walls (s) {walls} "
          f"(the first, warming, step {first!r}), peak GB {peak}")
    if not bitwise(outs[want][1], outs["per-head"][1]):
        raise AssertionError("phase 11 (e): the loss moved with the "
                             "backward's route")
    # the same forward; the backwards' f32 sums differ in their last bits,
    # which flip bf16 roundings in the chains after the WKV (the token
    # shift's mixes round their gradients at each bf16 product): 2 to 3
    # ULPs of a leaf's largest |g| at worst on the card (2^-6.9 at T 1,023,
    # 2^-6.4 at T 50,000), within 2^-5
    rel, worst = _step_agreement(
        f"T {T} {want} backward vs per-head", outs[want], outs["per-head"],
        0.0, 2.0 ** -5)
    del outs, params
    torch.cuda.empty_cache()
    return dict(B=B, T=T, chunk=chunk, route=want, walls=walls,
                first_wall=first, peak_gb=peak, worst_leaf_rel=worst)


@contextlib.contextmanager
def plain_kernels():
    """The model kernels' wrappers swapped for their plain versions, so
    that a step on the card runs with no kernel."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.kernels.rwkv6 import ref as wr

    def wkv(r, k, v, w, u, *, chunk=64, S0=None):
        return wr.chunked_reference(r, k, v, w, u, S0, chunk=chunk)
    saved = fk.flash_attention, wk.wkv6
    fk.flash_attention, wk.wkv6 = fr.reference, wkv
    try:
        yield
    finally:
        fk.flash_attention, wk.wkv6 = saved


def _worst_leaf(a, b):
    """(max over leaves of max |a - b| / max |b|, that leaf's index)."""
    errs = [(float((x.cpu() - y.cpu()).abs().max()
                   / y.abs().max().clamp_min(1e-30)), i)
            for i, (x, y) in enumerate(_pairs(a, b))]
    return max(errs)


def reduced_against_cpu(arch):
    """(e) the reduced f32 configuration: one grad step on the card
    (through the kernels) against the same step on the CPU (the plain
    versions) and on the card with the kernels swapped for their plain
    versions, on the same weights and batch; a model with attention runs
    its forward and backward on the split-TF32 route (``route_launches``)."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import LOCAL
    from repro_torch.models import init_params
    from repro_torch.utils import tree_map
    cfg = reduced_config(arch)
    params = init_params(cfg, SEED + 14, device="cpu")
    gen = torch.Generator().manual_seed(SEED + 14)
    batch = lm_batch(cfg, gen, REDUCED_B, REDUCED_T, device="cpu")
    step = make_grad_step(cfg, LOCAL)
    g_cpu, l_cpu, _ = step(params, batch)
    on_card = lambda tree: tree_map(lambda t: t.to("cuda"), tree)
    n0 = dict(fk.flash_attention_bwd.route_launches)
    f0 = dict(fk.flash_attention.route_launches)
    g_card, l_card, _ = step(on_card(params), on_card(batch))
    moved = {r: n - n0[r]
             for r, n in fk.flash_attention_bwd.route_launches.items()}
    attn = sum(1 for mixer, _ in cfg.layer_kinds() if mixer == "attn")
    if attn:
        fwd_routes_moved(fk.flash_attention, f0, "split_tf32",
                         f"phase 11 (e) {arch} reduced")
    print(f"  {arch} reduced: flash backward launches by route {moved} "
          f"({attn} attention layers, {cfg.dtype})")
    if moved != {r: attn * (r == "split_tf32") for r in moved}:
        raise AssertionError(f"phase 11 (e) {arch} reduced: the backward "
                             "did not run the split-TF32 route once a "
                             "layer")
    with plain_kernels():
        g_plain, _, _ = step(on_card(params), on_card(batch))
    rel = float((l_card.cpu() - l_cpu).abs() / l_cpu.abs())
    cpu_err, cpu_leaf = _worst_leaf(g_card, g_cpu)
    floor, floor_leaf = _worst_leaf(g_plain, g_cpu)
    own, own_leaf = _worst_leaf(g_card, g_plain)
    print(f"  {arch} reduced ({cfg.n_layers} layers, d {cfg.d_model}, head "
          f"width {cfg.rwkv_head_dim if cfg.rwkv else cfg.hd}, {cfg.dtype}),"
          f" B {REDUCED_B} x T {REDUCED_T}: card loss {float(l_card)!r} cpu "
          f"{float(l_cpu)!r} rel {rel!r}; worst gradient leaf, of its "
          f"largest |g|: card against the CPU {cpu_err!r} (leaf "
          f"{cpu_leaf}), the card's plain versions against the CPU "
          f"{floor!r} (leaf {floor_leaf}), card against its plain versions "
          f"{own!r} (leaf {own_leaf})")
    # f32 throughout.  Against the card's own plain step only the kernels'
    # sums and exponentials differ: within 1e-4 of each leaf's largest |g|,
    # as the CPU parity tests hold the port to JAX.  Against the CPU, torch's
    # CUDA and CPU sums differ too, and the RWKV blocks (a group norm over
    # 16 channels, u's gradient a sum over every token) amplify them: the
    # plain versions on the card depart from the CPU by up to 1.6e-4 there,
    # so the card is held within 1e-3 of the CPU
    if not (rel <= 1e-5 and own <= 1e-4 and cpu_err <= 1e-3):
        raise AssertionError(f"phase 11 (e) {arch} reduced: the card's grad "
                             "step departs from the CPU's or from its own "
                             "plain versions'")


def phase_train(counters):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rwkv6 import kernel as wk
    for fn in counters:
        fn.launches = 0
    walls = {}
    t0 = time.perf_counter()
    cfg, params, batch, flash_n = train_loss_check(fk.flash_attention)
    del cfg, params, batch
    torch.cuda.empty_cache()
    walls["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    bwd_rows = {"flash_attention_bwd": flash_bwd_check(gen),
                "wkv6_bwd": wkv_bwd_check(gen)}
    torch.cuda.empty_cache()
    walls["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = train_step_check(counters)
    torch.cuda.empty_cache()
    walls["c, d"] = time.perf_counter() - t0
    # (e): the main path of this phase, every count set to 0 just before
    t0 = time.perf_counter()
    for fn in counters:
        fn.launches = 0
    for fn in (wk.wkv6, wk.wkv6_bwd, fk.flash_attention,
               fk.flash_attention_bwd):
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
    kernels = {"qwen3-0.6b": (fk.flash_attention, fk.flash_attention_bwd),
               "rwkv6-7b": (wk.wkv6, wk.wkv6_bwd)}
    out["kernel_train"] = [kernel_train(arch, layers, B, T, kernels[arch])
                           for arch, layers, B, T in KERNEL_TRAIN]
    e_counts = {fn.__name__: fn.launches for fn in counters}
    e_routes = (dict(wk.wkv6.route_launches),
                dict(wk.wkv6_bwd.route_launches))
    print(f"  phase 11 (e) wkv6 launches by route {e_routes[0]}, wkv6_bwd "
          f"{e_routes[1]}")
    if not (e_routes[0]["tile-parallel"] and e_routes[1]["tile-parallel"]):
        raise AssertionError("phase 11 (e): the T 1,023 step did not run "
                             "the tile-parallel kernels both ways")
    out["vs_per_head"] = [step_vs_per_head(*case)
                          for case in STEP_VS_PER_HEAD]
    for arch in ("qwen3-0.6b", "rwkv6-7b"):
        reduced_against_cpu(arch)
    walls["e"] = time.perf_counter() - t0
    print(f"  phase 11 walls (s): {walls}")
    e_counts["flash_fwd_tf32"] = fk.flash_attention.route_launches[
        "split_tf32"]
    out.update(flash_launches=flash_n, bwd_rows=bwd_rows, e_counts=e_counts)
    return out


# --------------------------------------------------------------------------
# phase 12: the training launcher, run, checkpointed and resumed
# --------------------------------------------------------------------------


@contextlib.contextmanager
def timed_calls(log, targets):
    """Wrap each ``(module, attribute)`` of ``targets`` so that every call
    appends ``(attribute, in the main thread, seconds)`` to ``log``; a
    wrapped ``make_train_step`` or ``jit_train_step`` times each step it
    builds between two synchronizes.  The attributes are restored on
    exit."""
    import threading

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            log.append((name, threading.current_thread()
                        is threading.main_thread(),
                        time.perf_counter() - t0))
            return out
        return timed

    def wrap_steps(fn):
        def make(*args, **kw):
            return wrap("step", _synchronized(fn(*args, **kw)))
        return make

    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, wrap_steps(fn) if name in STEP_BUILDERS
                    else wrap(name, fn))
        yield log
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _synchronized(step):
    def run(*args):
        torch.cuda.synchronize()
        out = step(*args)
        torch.cuda.synchronize()
        return out
    return run


def step_digests(step_dir):
    """sha1 of every file of a checkpoint step (manifest included), read
    in parallel threads; and the step's bytes."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    def one(path):
        h = hashlib.sha1()
        with open(path, "rb") as f:
            while chunk := f.read(1 << 24):
                h.update(chunk)
        return path.name, h.hexdigest()
    files = sorted(Path(step_dir).iterdir())
    with ThreadPoolExecutor(8) as pool:
        digests = dict(pool.map(one, files))
    return digests, sum(p.stat().st_size for p in files)


def launch_run(label, ckpt_dir, log, flash_fns, extra=()):
    """One ``launch.train.main`` run (``extra`` flags added): its losses,
    peak GB and the calls ``timed_calls`` logged in it."""
    from repro_torch import checkpoint, convert
    from repro_torch.checkpoint import store
    from repro_torch.launch import train
    start = len(log)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_calls(log, [(train, "host_state"), (train, "make_train_step"),
                           (train, "jit_train_step"),
                           (checkpoint, "save_async"), (checkpoint, "save"),
                           (store, "save"), (checkpoint, "wait_pending"),
                           (checkpoint, "restore"),
                           (convert, "lm_params_from_host"),
                           (convert, "opt_state_from_host")]):
        losses = train.main(LAUNCH_ARGS + list(extra)
                            + ["--ckpt-dir", str(ckpt_dir)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    calls = log[start:]
    print(f"  run {label}: wall_s={wall!r} losses {losses} peak_gb={peak!r}"
          f"; flash launches so far {[f.launches for f in flash_fns]}")
    for name, main_thread, sec in calls:
        where = "" if main_thread else " (writer thread)"
        print(f"    {name}{where}: {sec!r} s")
    return dict(losses=losses, peak_gb=peak, wall=wall, calls=calls)


def phase_launch(counters):
    """``repro_torch.launch.train.main`` at Qwen3-0.6B's full size: run A
    (4 steps, checkpoints at 2 and 4), then run B from a directory that
    holds only A's step 2.  Gates: B prints its resume, its losses are A's
    last two bit for bit, its step 4 files A's by sha1, and the flash
    forward and backward launches are exact for the six steps."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    card = card_line()
    cfg = get_config(LAUNCH_ARCH)
    per = sum(1 for mixer, _ in cfg.layer_kinds() if mixer == "attn")
    M, n_steps = 2, LAUNCH_STEPS + (LAUNCH_STEPS - LAUNCH_RESUME)
    want = (n_steps * M * 2 * per, n_steps * M * per)
    root = Path(__file__).resolve().parent / "build" / "launch_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free_gb = shutil.disk_usage(root).free / 1e9
    print(f"phase 12: launch.train.main, {LAUNCH_ARCH} ({cfg.n_layers} "
          f"layers, d {cfg.d_model}) {' '.join(LAUNCH_ARGS)}; run A "
          f"uninterrupted, run B resumed from A's step {LAUNCH_RESUME}; "
          f"expected flash launches {n_steps} steps x {M} microbatches x "
          f"({per} forwards + {per} recomputed, {per} backwards) = "
          f"{want[0]} forward, {want[1]} backward; free disk at {root}: "
          f"{free_gb!r} GB [{card}]")
    if free_gb < LAUNCH_FREE_GB:
        raise AssertionError(f"phase 12: {free_gb} GB free at {root}, "
                             f"{LAUNCH_FREE_GB} needed")
    for fn in counters:
        fn.launches = 0
    flash_fns = (fk.flash_attention, fk.flash_attention_bwd)
    routes0 = dict(fk.flash_attention.route_launches)
    log, runs = [], {}
    try:
        runs["A"] = launch_run("A", root / "A", log, flash_fns)
        t0 = time.perf_counter()
        want_files, ckpt_bytes = step_digests(root / "A" / "step_4")
        hash_s = time.perf_counter() - t0
        shutil.rmtree(root / "A" / "step_4")
        (root / "B").mkdir()
        (root / "A" / f"step_{LAUNCH_RESUME}").rename(
            root / "B" / f"step_{LAUNCH_RESUME}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            runs["B"] = launch_run("B", root / "B", log, flash_fns)
        print(out.getvalue(), end="")
        got_files, _ = step_digests(root / "B" / "step_4")
    finally:
        # phase 14 resumes from B's step 2 and removes it; B's step 4 is
        # hashed: at most two checkpoints on disk
        for d in (root / "A", root / "B" / "step_4"):
            shutil.rmtree(d, ignore_errors=True)
    got = (fk.flash_attention.launches, fk.flash_attention_bwd.launches)
    fwd_routes_moved(fk.flash_attention, routes0, "tensor_cores" if cfg.dtype
                     == "bfloat16" else "split_tf32", f"phase 12 {cfg.dtype}")
    a, b = runs["A"]["losses"], runs["B"]["losses"]
    resumed = f"[train] resumed from step {LAUNCH_RESUME}" in out.getvalue()
    same_files = sum(got_files.get(k) == v for k, v in want_files.items())
    print(f"  checkpoint: {len(want_files)} files, ckpt_bytes={ckpt_bytes!r}"
          f", hashed in {hash_s!r} s; run B resumed: {resumed}; losses B "
          f"{b} against A's last {a[LAUNCH_RESUME:]}; step 4 files equal: "
          f"{same_files} of {len(want_files)}; flash launches {got}, "
          f"expected {want} [{card}]")
    if not resumed:
        raise AssertionError("phase 12: run B did not resume")
    if not all(math.isfinite(x) for x in a + b):
        raise AssertionError(f"phase 12: losses {a}, {b}")
    if b != a[LAUNCH_RESUME:]:
        raise AssertionError("phase 12: the resumed losses are not the "
                             "uninterrupted run's bit for bit")
    if not (same_files == len(want_files) == len(got_files)):
        raise AssertionError("phase 12: the resumed run's step 4 is not the "
                             "uninterrupted run's byte for byte")
    if got != want:
        raise AssertionError(f"phase 12: flash launches {got}, expected "
                             f"{want}")
    steps = [sec for name, _, sec in log if name == "step"]
    step_ms = statistics.median(steps) * 1e3
    return dict(launches=dict(zip(("flash_attention", "flash_attention_bwd"),
                                  got)),
                step_ms=step_ms, steps_ms=[x * 1e3 for x in steps],
                tok_s=4 * 1024 / step_ms * 1e3, ckpt_bytes=ckpt_bytes,
                free_gb=free_gb, runs=runs, root=root, b_files=got_files)


# --------------------------------------------------------------------------
# phase 14: distribution on the one card
# --------------------------------------------------------------------------


@contextlib.contextmanager
def flash_heads():
    """Record the kv-head count of every flash-attention call that the
    models make (``models.attention`` reaches the kernel through its
    ``_flash`` module, swapped here for a stand-in that records and calls
    the kernel's own wrapper, launch count and all)."""
    from repro_torch.models import attention
    orig, heads = attention._flash, []

    def spy(q, k, v, **kw):
        heads.append(k.shape[2])
        return orig.flash_attention(q, k, v, **kw)
    attention._flash = types.SimpleNamespace(flash_attention=spy)
    try:
        yield heads
    finally:
        attention._flash = orig


def card_mesh(shape):
    """A ``Distribution`` over ``shape`` positions, each the one card."""
    from repro_torch.launch.mesh import dist_for, make_mesh
    mesh = make_mesh(shape, AXES, devices=["cuda:0"] * math.prod(shape))
    return dist_for(mesh, fsdp=False)


def same_trees(a, b) -> bool:
    """Two trees of one structure bit for bit, leaf by leaf."""
    return (len(list(_leaves(a))) == len(list(_leaves(b)))
            and all(bitwise(x, y) for x, y in _pairs(a, b)))


def dist_launch(launch):
    """(a) ``launch.train.main --mesh 1,1 --device cuda`` resumed from
    phase 12's step 2, restored onto the 1 x 1 mesh's shardings: its losses
    and step 4 files bit for bit phase 12's run B, exact flash launches."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    root = launch["root"]
    cfg = get_config(LAUNCH_ARCH)
    per = sum(1 for mixer, _ in cfg.layer_kinds() if mixer == "attn")
    M, n_steps = 2, LAUNCH_STEPS - LAUNCH_RESUME
    want = (n_steps * M * 2 * per, n_steps * M * per)
    flash_fns = (fk.flash_attention, fk.flash_attention_bwd)
    n0 = tuple(f.launches for f in flash_fns)
    routes0 = dict(fk.flash_attention.route_launches)
    log = []
    try:
        (root / "C").mkdir()
        (root / "B" / f"step_{LAUNCH_RESUME}").rename(
            root / "C" / f"step_{LAUNCH_RESUME}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run = launch_run("C (--mesh 1,1)", root / "C", log, flash_fns,
                             extra=["--mesh", "1,1"])
        print(out.getvalue(), end="")
        got_files, _ = step_digests(root / "C" / "step_4")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    got = tuple(f.launches - n for f, n in zip(flash_fns, n0))
    fwd_routes_moved(fk.flash_attention, routes0, "tensor_cores" if cfg.dtype
                     == "bfloat16" else "split_tf32",
                     f"phase 14 (a) {cfg.dtype}")
    resumed = f"[train] resumed from step {LAUNCH_RESUME}" in out.getvalue()
    b = launch["runs"]["B"]["losses"]
    same_files = got_files == launch["b_files"]
    steps = [sec for name, _, sec in log if name == "step"]
    step_ms = statistics.median(steps) * 1e3
    print(f"  (a) --mesh 1,1: resumed {resumed}; losses {run['losses']} "
          f"against phase 12's run B {b}; step 4 files equal: {same_files} "
          f"({len(got_files)} files); flash launches {got}, expected {want}"
          f"; step_ms={step_ms!r} (median of {[x * 1e3 for x in steps]}) "
          f"beside phase 12's run B {launch['steps_ms'][-n_steps:]} (all six"
          f" {launch['step_ms']!r}); peak_gb={run['peak_gb']!r}, phase 12's "
          f"run B {launch['runs']['B']['peak_gb']!r} [{card_line()}]")
    if not resumed or run["losses"] != b or not same_files:
        raise AssertionError("phase 14 (a): the --mesh 1,1 run is not "
                             "phase 12's run B bit for bit")
    if got != want:
        raise AssertionError(f"phase 14 (a): flash launches {got}, "
                             f"expected {want}")
    return dict(step_ms=step_ms, steps_ms=[x * 1e3 for x in steps],
                peak_gb=run["peak_gb"], launches=got)


def generate_agreement(toks, logits, want_toks, want_logits, bound):
    """A generate against another of the same prompt: the logits of every
    step up to the first where a token differs (whose inputs are still the
    same) within ``bound`` of the largest, and each differing token at that
    step a near tie (its top-2 gap within twice the step's largest
    |difference|): greedy tokens equal wherever the margin is clear."""
    N = toks.shape[1]
    diff = toks != want_toks
    bad = diff.any(0).nonzero()
    first = int(bad[0]) if bad.numel() else N
    upto = min(first + 1, N)
    d = (logits[:, :upto] - want_logits[:, :upto]).abs()
    rel = float(d.max() / want_logits[:, :upto].abs().max())
    unclear = True
    if first < N:
        top2 = want_logits[:, first].topk(2, -1).values
        gap = top2[:, 0] - top2[:, 1]
        rows = diff[:, first]
        unclear = bool((gap[rows] <= 2 * d[:, first].amax(-1)[rows]).all())
    ok = rel <= bound and unclear
    return ok, dict(rel=rel, first_diff=first, same_tokens=first == N,
                    bitwise=bitwise(toks, want_toks)
                    and bitwise(logits, want_logits))


def dist_dense(served):
    """(b) Qwen3-0.6B on a (1, 16) mesh of the card: ``forward`` with one
    flash launch a layer at Hkv 16 against ``LOCAL``'s, ``generate(dist=
    ...)`` against phase 5's generate (tokens) and, step by step, against
    ``LOCAL``'s ``decode_step`` teacher-forced on its tokens (logits), and
    one ``jit_train_step`` on a (2, 2) mesh bit for bit a ``LOCAL``
    step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.steps import jit_train_step, make_train_step
    from repro_torch.models import (LOCAL, decode_step, forward, init_params,
                                    prefill)
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.serving import generate
    from repro_torch.serving.engine import pad_attn_cache
    cfg = get_config(DIST_DENSE_ARCH)
    B, S0, N = SERVE_B, SERVE_PROMPT, SERVE_NEW
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, device="cuda")        # phase 5's draws
    prompt = torch.randint(0, cfg.vocab, (B, S0), generator=gen,
                           device="cuda")
    dist = card_mesh(DIST_DENSE_MESH)
    per = sum(1 for mixer, _ in cfg.layer_kinds() if mixer == "attn")
    tp = dist.tp_size()
    flash = fk.flash_attention
    print(f"phase 14 (b): {DIST_DENSE_ARCH} on a {DIST_DENSE_MESH} mesh of "
          f"the card: tp {tp} over {cfg.n_kv} kv heads (GQA repeat x "
          f"{tp // cfg.n_kv} before flash, sequence-sharded decode)")
    out = {}
    torch.cuda.reset_peak_memory_stats()
    with flash_heads() as heads, torch.inference_mode():
        n0 = flash.launches
        got = forward(cfg, params, {"tokens": prompt}, dist)[0]
        n_fwd, fwd_heads = flash.launches - n0, list(heads)
    with torch.inference_mode():
        ref = forward(cfg, params, {"tokens": prompt})[0]
    rel = float((got - ref).abs().max() / ref.abs().max())
    same = bitwise(got, ref)
    del got, ref
    print(f"  forward: {n_fwd} flash launches at kv heads "
          f"{sorted(set(fwd_heads))}; logits against LOCAL's: bit for bit "
          f"{same}, max|diff|/max|logit| = {rel!r} (gate 5e-2, phase 5's)")
    if n_fwd != per or set(fwd_heads) != {tp}:
        raise AssertionError(f"phase 14 (b): forward flash launches {n_fwd}"
                             f" at kv heads {fwd_heads}, expected {per} at "
                             f"{tp}")
    if not (same or rel <= 5e-2):
        raise AssertionError(f"phase 14 (b): forward departs by {rel}")
    with flash_heads() as heads:
        n0 = flash.launches
        toks, logits = generate(cfg, params, prompt, max_new_tokens=N,
                                dist=dist, return_logits=True)
        n_gen, gen_heads = flash.launches - n0, list(heads)
    ok, agree = generate_agreement(toks, logits, *served["generated"], 5e-2)
    print(f"  generate(dist=...) {N} tokens against phase 5's generate: "
          f"{agree}; prefill flash launches {n_gen} at kv heads "
          f"{sorted(set(gen_heads))}")
    if not ok or n_gen != per or set(gen_heads) != {tp}:
        raise AssertionError(f"phase 14 (b): generate under the mesh: "
                             f"{agree}, {n_gen} launches at {gen_heads}")
    # every decode step of that generate against LOCAL's decode_step,
    # teacher-forced on the mesh run's own tokens from the mesh's prefill
    # cache: the sequence-sharded form held at each of the N - 1 steps
    with torch.inference_mode():
        lg, cache = prefill(cfg, params, {"tokens": prompt}, dist)
        cache = pad_attn_cache(cache, N)
        want = [lg[:, -1].float()]
        for i in range(N - 1):
            lg, cache = decode_step(cfg, params, cache, toks[:, i], S0 + i)
            want.append(lg[:, -1].float())
        want = torch.stack(want, 1)
    step_rel = ((logits - want).abs().amax((0, 2))
                / want.abs().amax((0, 2))).tolist()
    del cache, lg, want
    print(f"  the same {N - 1} decode steps against LOCAL's decode_step "
          f"teacher-forced on its tokens (max|diff|/max|logit| a step, "
          f"gate 5e-2, phase 5's): {step_rel!r}")
    if not all(r <= 5e-2 for r in step_rel[1:]) or step_rel[0] != 0:
        raise AssertionError(f"phase 14 (b): the sequence-sharded decode "
                             f"departs from LOCAL's: {step_rel}")
    agree["teacher_forced_rel"] = step_rel
    out["forward"] = dict(bitwise=same, rel=rel, launches=n_fwd)
    out["generate"] = agree
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del toks, logits

    # one train step on a (2, 2) mesh of the card against LOCAL's
    tcfg = cfg.replace(grad_accum=2, remat="full")
    oc = OptConfig(schedule="const", warmup_steps=1, state_dtype="f32")
    batch = lm_batch(tcfg, gen, 4, 1024)
    opt = adamw_init(params, oc)
    d22 = card_mesh(DIST_TRAIN_MESH)
    torch.cuda.reset_peak_memory_stats()
    n0 = (fk.flash_attention.launches, fk.flash_attention_bwd.launches)
    p_m, o_m, m_m = jit_train_step(tcfg, d22, oc, params, opt, batch)(
        params, opt, batch)
    torch.cuda.synchronize()
    step_launches = (fk.flash_attention.launches - n0[0],
                     fk.flash_attention_bwd.launches - n0[1])
    p_l, o_l, m_l = make_train_step(tcfg, LOCAL, oc)(params, opt, batch)
    same = (bitwise(m_m["loss"], m_l["loss"]) and same_trees(p_m, p_l)
            and same_trees(o_m, o_l))
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  jit_train_step on a {DIST_TRAIN_MESH} mesh (B 4 x T 1024, 2 "
          f"microbatches, f32 tier): loss {float(m_m['loss'])!r}, LOCAL "
          f"{float(m_l['loss'])!r}; loss, parameters and state bit for bit "
          f"LOCAL's: {same}; flash launches {step_launches}; peak_gb="
          f"{peak!r} [{card_line()}]")
    if not same:
        raise AssertionError("phase 14 (b): the (2, 2) train step is not "
                             "LOCAL's bit for bit")
    out["train"] = dict(loss=float(m_m["loss"]), peak_gb=peak,
                        launches=step_launches)
    del params, opt, p_m, o_m, p_l, o_l
    torch.cuda.empty_cache()
    return out


def dist_moe_layer(cfg):
    """(c) one full-width MoE layer in f32 at MOE_LAYER_SHAPE tokens (phase
    5's skewed activations) under the (2, 4) mesh: drop-free against
    ``moe_dense_ref``; at the configuration's capacity factor bit for bit
    the ``LOCAL`` body of each data-parallel slice, and against the oracle
    with the pairs that overflow a rank's queue zeroed."""
    from repro_torch.models import layers, moe
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    p = moe.moe_init(cfg32, gen)
    x = torch.randn((*MOE_LAYER_SHAPE, cfg.d_model), generator=gen,
                    device="cuda")
    common = torch.randn((cfg.d_model,), generator=gen, device="cuda")
    x = (x + common) * 0.5 ** 0.5
    gates, idx, _ = moe.route(cfg32, p, x)
    dist = card_mesh(DIST_MOE_MESH)
    dp = DIST_MOE_MESH[0]
    T, Bs = x.shape[0] * x.shape[1], x.shape[0] // dp
    free = drop_free(cfg32)
    got = moe.moe_apply(free, p, x, gates, idx, dist)
    want = moe.moe_dense_ref(free, p, x, gates, idx)
    rel_free = float((got - want).abs().max() / want.abs().max())
    got = moe.moe_apply(cfg32, p, x, gates, idx, dist)
    # each rank's LOCAL body on its slice, then the shared experts as
    # moe_apply adds them, over all the tokens at once
    d, n = cfg.d_model, T // dp
    xf, gf, idf = x.reshape(T, d), gates.reshape(T, -1), idx.reshape(T, -1)
    slices = torch.cat([moe._moe_body(cfg32, p["experts"],
                                      xf[r * n:(r + 1) * n],
                                      gf[r * n:(r + 1) * n],
                                      idf[r * n:(r + 1) * n])
                        for r in range(dp)]).reshape(x.shape)
    slices = slices + layers.mlp_apply(cfg32, p["shared"], x)
    cap_rank, cap_all = moe.capacity(cfg32, T // dp), moe.capacity(cfg32, T)
    per_rank = torch.cat([dropped_pairs(idx[r * Bs:(r + 1) * Bs], cap_rank)
                          for r in range(dp)])
    local = dropped_pairs(idx, cap_all)
    kept = torch.where(per_rank, torch.zeros_like(gates), gates)
    ref = moe.moe_dense_ref(cfg32, p, x, kept, idx)
    rel_drop = float((got - ref).abs().max() / ref.abs().max())
    same = bitwise(got, slices)
    print(f"  (c) one MoE layer, f32, {T} tokens on a {DIST_MOE_MESH} mesh: "
          f"drop-free against moe_dense_ref {rel_free!r} (gate 1e-4); at "
          f"capacity factor {cfg.moe.capacity_factor!r} each rank's "
          f"{T // dp} tokens get cap {cap_rank} (LOCAL's {T}: {cap_all}): "
          f"{int(per_rank.sum())} pairs dropped over the ranks, LOCAL "
          f"{int(local.sum())}, {int((per_rank & ~local).sum())} of the "
          f"ranks' kept by LOCAL; bit for bit the ranks' LOCAL bodies: "
          f"{same}; against the oracle with the ranks' drops zeroed "
          f"{rel_drop!r} (gate 1e-4)")
    if not (rel_free <= 1e-4 and rel_drop <= 1e-4 and same):
        raise AssertionError("phase 14 (c): the expert-parallel layer "
                             f"departs ({rel_free}, {rel_drop}, {same})")
    del p
    torch.cuda.empty_cache()
    return dict(rel_free=rel_free, rel_drop=rel_drop,
                dropped=int(per_rank.sum()), local_dropped=int(local.sum()),
                only_ranks=int((per_rank & ~local).sum()))


def dist_moe():
    """(c) DeepSeekMoE-16B at full width and DIST_MOE_LAYERS layers: the
    layer checks, then a bf16 forward, one train step and a generate on the
    (2, 4) mesh, each bit for bit the same on (2, 1): tp changes no bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import jit_train_step
    from repro_torch.models import forward, init_params
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.serving import generate
    cfg = get_config(DIST_MOE_ARCH).replace(n_layers=DIST_MOE_LAYERS)
    print(f"phase 14 (c): {DIST_MOE_ARCH} ({cfg.n_layers} layers of "
          f"{get_config(DIST_MOE_ARCH).n_layers}: depth cut, d "
          f"{cfg.d_model}, {cfg.moe.n_experts} experts) on a {DIST_MOE_MESH}"
          f" mesh of the card against {DIST_MOE_TP1}")
    out = dist_moe_layer(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT),
                           generator=gen, device="cuda")
    d_tp, d_1 = card_mesh(DIST_MOE_MESH), card_mesh(DIST_MOE_TP1)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        a = forward(cfg, params, {"tokens": prompt}, d_tp)[0]
        b = forward(cfg, params, {"tokens": prompt}, d_1)[0]
    fwd_same = bitwise(a, b) and bool(torch.isfinite(a).all())
    del a, b
    ta, la = generate(cfg, params, prompt, max_new_tokens=SERVE_NEW,
                      dist=d_tp, return_logits=True)
    tb, lb = generate(cfg, params, prompt, max_new_tokens=SERVE_NEW,
                      dist=d_1, return_logits=True)
    gen_same = bitwise(ta, tb) and bitwise(la, lb)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    tcfg = cfg.replace(grad_accum=1, remat="full")
    oc = OptConfig(schedule="const", warmup_steps=1, state_dtype="bf16")
    batch = lm_batch(tcfg, gen, *DIST_MOE_TRAIN)
    opt = adamw_init(params, oc)
    torch.cuda.reset_peak_memory_stats()
    p_a, o_a, m_a = jit_train_step(tcfg, d_tp, oc, params, opt, batch)(
        params, opt, batch)
    p_b, o_b, m_b = jit_train_step(tcfg, d_1, oc, params, opt, batch)(
        params, opt, batch)
    step_same = (bitwise(m_a["loss"], m_b["loss"]) and same_trees(p_a, p_b)
                 and same_trees(o_a, o_b))
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  bf16 forward at {SERVE_B} x {SERVE_PROMPT}: bit for bit "
          f"{fwd_same}; generate {SERVE_NEW} tokens: tokens and logits bit "
          f"for bit {gen_same}; peak_gb={serve_peak!r}; one train step (B "
          f"{DIST_MOE_TRAIN[0]} x T {DIST_MOE_TRAIN[1]}, bf16 tier): loss "
          f"{float(m_a['loss'])!r}, loss, parameters and state bit for bit "
          f"{step_same}; peak_gb={train_peak!r} [{card_line()}]")
    del params, opt, p_a, o_a, p_b, o_b
    torch.cuda.empty_cache()
    if not (fwd_same and gen_same and step_same):
        raise AssertionError(f"phase 14 (c): tp changed bits (forward "
                             f"{fwd_same}, generate {gen_same}, train step "
                             f"{step_same})")
    return dict(out, serve_peak_gb=serve_peak, train_peak_gb=train_peak,
                loss=float(m_a["loss"]))


def held_step(label, make, step, counters, per_run):
    """Phase 15 (b): ``step`` costed on meta tensors (``make("meta")``),
    then run on the card (``make("cuda")``) under the same counting mode:
    FLOPs and bytes equal, the card's memory growth over the step within
    ``HELD_PEAK_RTOL`` of the tracker's, the median of ``HELD_RUNS`` timed
    runs against the roofline's bound.  Returns its launches by kernel
    (``per_run`` a run: a warm-up, the counted run, the memory run and the
    timed ones)."""
    from repro_torch.launch import analysis as an
    before = {c.__name__: c.launches for c in counters}
    meta = an.StepCounter()
    t0 = time.perf_counter()
    meta.run(step, *make("meta"))
    meta_s = time.perf_counter() - t0
    if {c.__name__: c.launches for c in counters} != before:
        raise AssertionError(f"phase 15 (b) {label}: a meta cost launched")
    args = make("cuda")
    step(*args)
    torch.cuda.synchronize()
    card = an.StepCounter()
    card.run(step, *args)
    torch.cuda.synchronize()
    if (card.flops, card.bytes) != (meta.flops, meta.bytes):
        ops = sorted(set(meta.by_op) | set(card.by_op))
        diff = {k: (meta.by_op.get(k), card.by_op.get(k)) for k in ops
                if meta.by_op.get(k) != card.by_op.get(k)}
        raise AssertionError(
            f"phase 15 (b) {label}: meta counts {meta.flops} FLOPs, "
            f"{meta.bytes} bytes; the card {card.flops}, {card.bytes}; "
            f"operators (calls, bytes) that differ: {diff}; FLOPs "
            f"{meta.flops_by_op} / {card.flops_by_op}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(*args)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    del out
    tracked = meta.peak_bytes - meta.argument_bytes
    wall = wall_s(lambda: step(*args), HELD_RUNS)
    rf = an.roofline(meta.cost())
    share = rf.t_bound / wall
    runs = HELD_RUNS + 3
    launches = {c.__name__: c.launches - before[c.__name__]
                for c in counters if c.launches != before[c.__name__]}
    print(f"phase 15 (b) {label}: meta {meta.flops} FLOPs, {meta.bytes} "
          f"bytes (costed in {meta_s:.2f} s), the card's the same; memory "
          f"growth over the step {grown} bytes on the card, {tracked} "
          f"tracked (arguments {meta.argument_bytes}); step "
          f"{wall * 1e3!r} ms (median of {HELD_RUNS}); t_compute "
          f"{rf.t_compute!r} s, t_memory {rf.t_memory!r} s, bound by "
          f"{rf.bottleneck}: roofline share {share!r} on {card_line()}; "
          f"launches {launches} over {runs} runs")
    if abs(grown - tracked) > HELD_PEAK_RTOL * tracked:
        raise AssertionError(f"phase 15 (b) {label}: the card grew {grown} "
                             f"bytes, the tracker {tracked}")
    if share > HELD_SHARE_MAX:
        raise AssertionError(f"phase 15 (b) {label}: roofline share {share} "
                             f"> {HELD_SHARE_MAX}: a count is short")
    want = {name: n * runs for name, n in per_run.items()}
    if launches != want:
        raise AssertionError(f"phase 15 (b) {label}: launches {launches}, "
                             f"expected {want}")
    del args
    torch.cuda.empty_cache()
    return dict(flops=meta.flops, bytes=meta.bytes, grown=grown,
                tracked=tracked, step_ms=wall * 1e3, share=share,
                bottleneck=rf.bottleneck, launches=launches)


def held_steps(counters):
    """Phase 15 (b): the two held steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import LOCAL, init_params
    from repro_torch.optim import OptConfig, adamw_init

    def tokens(cfg, B, T, dev):
        if dev == "meta":
            return torch.empty((B, T), dtype=torch.int32, device="meta")
        gen = torch.Generator(device=dev).manual_seed(SEED + 15)
        return torch.randint(0, cfg.vocab, (B, T), generator=gen,
                             device=dev, dtype=torch.int32)

    def params(cfg, dev):
        return init_params(cfg, None if dev == "meta" else SEED + 15,
                           device=dev)

    arch, B, T, M = HELD_TRAIN
    cfg = get_config(arch).replace(grad_accum=M, remat="full")
    oc = OptConfig(schedule="const", warmup_steps=1, state_dtype="f32")

    def train_inputs(dev):
        p = params(cfg, dev)
        toks = tokens(cfg, B, T + 1, dev)
        return p, adamw_init(p, oc), {"tokens": toks[:, :-1].contiguous(),
                                      "targets": toks[:, 1:].contiguous()}

    n_attn = sum(1 for mixer, _ in cfg.layer_kinds() if mixer == "attn")
    out = {"train": held_step(
        f"{arch} train step (B {B} x T {T}, {M} microbatches, remat full)",
        train_inputs, make_train_step(cfg, LOCAL, oc), counters,
        {"flash_attention": 2 * M * n_attn,
         "flash_attention_bwd": M * n_attn})}
    arch, B, T = HELD_PREFILL
    rcfg = get_config(arch)
    out["prefill"] = held_step(
        f"{arch} prefill (B {B} x T {T})",
        lambda dev: (params(rcfg, dev), {"tokens": tokens(rcfg, B, T, dev)}),
        make_prefill_step(rcfg, LOCAL), counters,
        {"wkv6": rcfg.n_layers})
    return out


def phase_dryrun(counters):
    """Phase 15: (a) ``dryrun.main(["--all"])`` into ``chiprun_out/dryrun``,
    a worker a CPU core: 32 cells costed, 8 skipped, none failed, and each
    cell's bottleneck, terms, useful ratio and global peak; (b) the held
    steps."""
    import os
    import shutil
    from repro_torch.launch import dryrun
    out = Path(__file__).resolve().parent / "chiprun_out" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    jobs = os.cpu_count() or 1
    t0 = time.perf_counter()
    failures = dryrun.main(["--all", "--jobs", str(jobs), "--out-dir",
                            str(out)])
    sweep_s = time.perf_counter() - t0
    recs = [json.loads(f.read_text())
            for f in sorted(out.glob("*__single.json"))]
    by_status = {k: [r for r in recs if r["status"] == k]
                 for k in ("ok", "skipped")}
    print(f"phase 15 (a): the dry run, {len(recs)} cells on the 16 x 16 "
          f"meta mesh in {sweep_s!r} s ({jobs} worker processes); per cell "
          "(global counts over 256 chips, H100 peaks, collective term null)"
          ": bottleneck, t_compute s, t_memory s, useful_ratio, peak GB")
    for r in by_status["ok"]:
        rf = r["roofline"]
        print(f"  {r['arch']} {r['shape']}: {rf['bottleneck']} "
              f"{rf['t_compute']!r} {rf['t_memory']!r} "
              f"{r['useful_ratio']!r} {r['memory']['peak_gb']!r}")
    counts = {k: len(v) for k, v in by_status.items()}
    if failures or counts != DRYRUN_CELLS:
        raise AssertionError(f"phase 15 (a): {failures} failures, {counts} "
                             f"cells, expected {DRYRUN_CELLS}")
    return dict(sweep_s=sweep_s, cells=counts, held=held_steps(counters))


def phase_distribution(counters, launch, served):
    """Phase 14: (a) the launcher under ``--mesh 1,1``, (b) the GQA repeat
    and the sequence-sharded decode at tp 16, a (2, 2) train step, (c)
    DeepSeekMoE's expert parallelism.  Returns the flash launches of the
    phase's model runs."""
    from repro_torch.kernels.flash_attention import kernel as fk
    print(f"phase 14: distribution on the card's mesh layout [{card_line()}]")
    for fn in counters:
        fn.launches = 0
    res = {"a": dist_launch(launch), "b": dist_dense(served),
           "c": dist_moe()}
    res["launches"] = {"flash_attention": fk.flash_attention.launches,
                       "flash_attention_bwd":
                       fk.flash_attention_bwd.launches}
    print(f"  phase 14 launches: {res['launches']}")
    return res


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
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    from repro_torch.kernels.rwkv6.kernel import wkv6, wkv6_bwd
    t_start = t0 = time.perf_counter()
    logs = _build.build(["gnep_sweep", "gnep_iter", "flash_attention",
                         "flash_attention_bwd", "wkv6", "wkv6_bwd"])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "entry function" in ln:
                print(f"  {name}: {ln.strip()}")
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")
    # the tensor-core kernels' entries, both ways: registers and spills
    for name in ("flash_attention", "flash_attention_bwd"):
        for word in ("wgmma", "tf32"):
            for entry, usage in ptxas_usage(logs.get(name, ""),
                                            word).items():
                print(f"  {name} {word} entry {entry}: {usage}")
    for entry, usage in ptxas_usage(logs.get("wkv6_bwd", ""),
                                    "wkv6_bwd").items():
        print(f"  wkv6_bwd entry {entry}: {usage}")
    counters = (fused_iter_sweep, rm_sweep_batched, rm_sweep,
                flash_attention, wkv6, flash_attention_bwd, wkv6_bwd)

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
    rows["flash_attention"], rows["flash_fwd_tf32"] = timed(
        "phase 1b", phase_flash, cuda_gen)
    rows["wkv6"] = timed("phase 1c", phase_wkv, cuda_gen)
    timed("phase 1d", phase_dot, cuda_gen)
    configs, counts, reports = timed("phase 2", phase_main, main_batch, gen,
                                     counters)
    timed("phase 2 reference", phase_reference, gen)
    timed("phase 3", phase_pinned, gen)
    timed("phase 4", phase_timing, main_batch, configs)
    serving = {arch: timed(f"phase 5 {arch}", phase_serving, arch, counters)
               for arch in SERVE_ARCHS}
    flash = {f"phase 5 {arch}": res["counts"]["flash_attention"]
             for arch, res in serving.items()
             if res["counts"]["flash_attention"]}
    counts["flash_attention"] = sum(flash.values())
    counts["wkv6"] = serving["rwkv6-7b"]["counts"]["wkv6"]
    ragged = serving["rwkv6-7b"]["ragged_launches"]
    window = timed("phase 6", phase_window, counters)
    by_path = {name: {"phase 2": n} for name, n in counts.items()
               if name in ALLOCATOR_KERNELS}
    shards = timed("phase 7", phase_shards, main_batch, configs, reports,
                   window, counters)
    plan = timed("phase 8", phase_plan, counters)
    daemon = timed("phase 9", phase_daemon, counters)
    fleet = timed("phase 10", phase_fleet, counters)
    train = timed("phase 11", phase_train, counters)
    launch = timed("phase 12", phase_launch, counters)
    dist = timed("phase 14", phase_distribution, counters, launch,
                 serving[DIST_DENSE_ARCH])
    dry = timed("phase 15", phase_dryrun, counters)
    flash["phase 11 (a)"] = train["flash_launches"]
    counts["flash_attention"] += train["flash_launches"]
    # phase 11 (e), the training path's main run, for all four model kernels
    e_counts = train["e_counts"]
    flash["phase 11 (e)"] = e_counts["flash_attention"]
    counts["flash_attention"] += e_counts["flash_attention"]
    by_path["flash_attention"] = flash
    # the f32 route's launches on the main path: phase 11 (e)'s reduced
    # steps (every other path runs bf16)
    counts["flash_fwd_tf32"] = e_counts["flash_fwd_tf32"]
    by_path["flash_fwd_tf32"] = {"phase 11 (e)": e_counts["flash_fwd_tf32"]}
    by_path["wkv6"] = {"phase 5 rwkv6-7b": counts["wkv6"],
                       "phase 5 rwkv6-7b prompts "
                       + ", ".join(str(P) for _, P in RWKV_RAGGED_PROMPTS):
                       ragged,
                       "phase 11 (e)": e_counts["wkv6"]}
    counts["wkv6"] += ragged + e_counts["wkv6"]
    for name, row in train["bwd_rows"].items():
        rows[name] = row
        counts[name] = e_counts[name]
        by_path[name] = {"phase 11 (e)": e_counts[name]}
    # phase 12, the training launcher's run and resumed run; phase 14
    for name, n in launch["launches"].items():
        by_path[name]["phase 12"] = n
        counts[name] += n
    for name, n in dist["launches"].items():
        by_path[name]["phase 14"] = n
        counts[name] += n
    for held in dry["held"].values():
        for name, n in held["launches"].items():
            by_path[name]["phase 15"] = by_path[name].get("phase 15", 0) + n
            counts[name] += n
    for name in ("flash_attention", "flash_fwd_tf32", "wkv6",
                 "flash_attention_bwd", "wkv6_bwd"):
        if e_counts[name] == 0:
            raise AssertionError(f"phase 11 (e): {name} was not launched on "
                                 "the training path")
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
    by_path["rm_sweep_batched"]["phase 10"] = fleet["launches"]
    counts["rm_sweep_batched"] += fleet["launches"]
    for arch, res in serving.items():
        print(f"  serving {arch} ({res['layers']} layers): f32 "
              f"decode-vs-forward {res.get('f32_rel')!r} "
              f"prefill_s={res['prefill_s']!r} "
              + (f"prefill_s by (batch, prompt) {res['prefill_by_prompt']!r}"
                 f" (per-head kernel {res['prefill_per_head']!r}; peak GB "
                 f"{res['ragged_peak_gb']!r}) "
                 if "prefill_by_prompt" in res else "") +
              f"decode_tok_s={res['decode_tok_s']!r} "
              f"peak_gb={res['peak_gb']!r} "
              f"idle_share={res['idle']!r} (profiled), "
              f"{res['idle_warm']!r} (against the unprofiled run)")
        if "moe" in res:
            print(f"  serving {arch}: {res['moe']}")
    print(f"  fleet: {fleet['tenants']} tenants, iterations "
          f"{fleet['iters']}, epoch_batch walls {fleet['walls']}, stream "
          f"{fleet['stream']}, sweep epoch_batch idle_share="
          f"{fleet['idle']!r} busy_s={fleet['busy']!r}")
    for tier, res in train["steps"].items():
        print(f"  train {TRAIN_ARCH} ({TRAIN_LAYERS} layers, "
              f"{train['params']} parameters), tier {tier}: "
              f"step_ms={res['step_ms']!r} tokens_s={res['tok_s']!r} "
              f"peak_gb={res['peak_gb']!r} loss {res['losses'][0]!r} -> "
              f"{res['losses'][-1]!r}")
    print(f"  train f32 step idle_share={train['idle']!r} (profiled), "
          f"{train['idle_warm']!r} (against the unprofiled steps); the T "
          f"{TRAIN_T} step's WKV on the kernels at chunk 1 against "
          f"wkv_recurrent (loss rel, worst leaf rel): "
          f"{train['recurrence']!r}, launches {train['launches']}")
    for res in train["vs_per_head"]:
        print(f"  train B {res['B']} x T {res['T']} grad step, {res['route']}"
              f" backward against per-head: {res!r}")
    for res in train["kernel_train"]:
        print(f"  train through the kernels {res['arch']} ({res['layers']} "
              f"layers, {res['params']} parameters), B {res['B']} x T "
              f"{res['T']}, f32 tier: step_ms={res['step_ms']!r} "
              f"tokens_s={res['tok_s']!r} peak_gb={res['peak_gb']!r} "
              f"idle_share={res['idle']!r} (profiled), {res['idle_warm']!r} "
              f"(against the unprofiled steps) loss {res['losses'][0]!r} -> "
              f"{res['losses'][-1]!r}, launches {res['launches']}")
    print(f"  phase 11 (e) launches: {e_counts}")
    print(f"  launch.train {LAUNCH_ARCH}: step_ms={launch['step_ms']!r} "
          f"(median of {launch['steps_ms']}) tokens_s={launch['tok_s']!r} "
          f"peak_gb={[r['peak_gb'] for r in launch['runs'].values()]} "
          f"ckpt_bytes={launch['ckpt_bytes']!r} free_gb="
          f"{launch['free_gb']!r}, launches {launch['launches']}")
    print(f"  distribution: (a) --mesh 1,1 step_ms={dist['a']['step_ms']!r}"
          f" beside phase 12's {launch['step_ms']!r}, peak_gb="
          f"{dist['a']['peak_gb']!r}; (b) {dist['b']}; (c) {dist['c']}")
    print(f"  dry run: {dry['cells']} cells in {dry['sweep_s']!r} s; held "
          "steps " + ", ".join(
              f"{k}: share {h['share']!r} ({h['bottleneck']}), step_ms "
              f"{h['step_ms']!r}, peak {h['grown']} / {h['tracked']} bytes"
              for k, h in dry["held"].items()) + f" on {card}")
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
