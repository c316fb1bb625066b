"""Parity of the port's roofline analysis (``repro_torch.launch.analysis``)
with ``repro.launch.analysis``, and the counts of its dispatch-level
counter.

* The pure-Python pieces, exactly: ``CostSummary``'s algebra, ``roofline``
  given JAX's TPU constants as its hardware record, and the ring model on
  ``tests/test_analysis.py``'s HLO written as ``(op, dtype, shape, group
  size)`` records.
* The kernels' dispatcher operators: each FLOP formula equals the count
  ``chip_smoke.py`` used for the kernel table's bounds (kept here as it
  was written there), ``StepCounter`` counts it on meta tensors, and a
  meta cost moves no ``launches`` counter.
* ``StepCounter`` by hand: FLOPs, bytes and the peak of live storages of
  a chain of products are the exact sums; views and allocations count no
  bytes, a broadcast axis counts once; on a grad step its FLOPs are
  ``FlopCounterMode``'s.
"""
import pytest
import torch

from repro.launch import analysis as jan
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.rwkv6 import kernel as wk
from repro_torch.launch import analysis as an

from test_analysis import HLO

# tests/test_analysis.py's HLO as records (an all-reduce-done line is no
# collective; a dot is not one)
RECORDS = [("all-gather", torch.float32, (16, 1024), 16),
           ("all-reduce", torch.bfloat16, (256, 512), 256),
           ("reduce-scatter", torch.float32, (8, 128), 8),
           ("collective-permute", torch.float32, (4, 4), 1),
           ("all-to-all", torch.float32, (2, 8), 4)]
V5E = an.Hardware(name="TPU v5e (JAX's constants)", peak_flops=197e12,
                  hbm_bw=819e9, link_bw=50e9)


def test_cost_summary_algebra_matches_jax():
    def both(mod):
        a = mod.CostSummary(1.0, 2.0, 3.0, {"all-reduce": 3.0})
        b = mod.CostSummary(10.0, 20.0, 30.0, {"all-gather": 30.0})
        s = a + b.scaled(0.5)
        return (s.flops, s.bytes_accessed, s.coll_bytes, s.coll_by_op)
    assert both(an) == both(jan)


@pytest.mark.parametrize("cost", [(197e12, 819e9 * 2, 50e9 * 0.5),
                                  (3e12, 1e9, 7e11), (1.0, 0.0, 0.0)])
def test_roofline_matches_jax_on_its_constants(cost):
    got = an.roofline(an.CostSummary(*cost), V5E)
    want = jan.roofline(jan.CostSummary(*cost))
    assert (got.t_compute, got.t_memory, got.t_collective) == (
        want.t_compute, want.t_memory, want.t_collective)
    assert got.bottleneck == want.bottleneck
    assert got.t_bound == want.t_bound
    assert got.compute_fraction == want.compute_fraction


def test_null_collective_term_is_left_out():
    r = an.Roofline(t_compute=2.0, t_memory=1.0, t_collective=None)
    assert (r.bottleneck, r.t_bound, r.compute_fraction) == ("compute", 2.0,
                                                             1.0)


def test_ring_model_matches_jax_on_its_hlo():
    total, by_op = an.collective_wire_bytes(RECORDS)
    want_total, want_by = jan.collective_wire_bytes(HLO)
    assert by_op == want_by
    assert total == want_total
    one = [("all-reduce", torch.float32, (8,), 1)]
    assert an.collective_wire_bytes(one) == jan.collective_wire_bytes(
        "%ar = f32[8]{0} all-reduce(%x), replica_groups=[512,1]<=[512]")


# --------------------------------------------------------------------------
# the kernels' operators
# --------------------------------------------------------------------------

# chip_smoke.py's counts as it wrote them before they moved into the
# package (causal pairs at Sq == Skv)
def _smoke_flash(B, S, Hq, hd, causal, backward):
    pairs = S * (S + 1) // 2 if causal else S * S
    return (5 * 2 if backward else 4) * hd * B * Hq * pairs


def _smoke_wkv(B, T, H, K, L, backward):
    pairs = L * (L - 1) // 2
    if backward:
        per_chunk = 2 * (5 * pairs * K + 5 * L * K * K) + 30 * L * K
    else:
        per_chunk = 2 * (pairs * K + pairs * K + 2 * L * K * K + K * K) \
            + 12 * L * K
    return B * H * (T // L) * per_chunk


def _meta(*shape, dtype=torch.float32, grad=True):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


def _launches():
    return (fk.flash_attention.launches, fk.flash_attention_bwd.launches,
            wk.wkv6.launches, wk.wkv6_bwd.launches)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_operators_count_chip_smokes_operations(causal):
    B, S, Hq, Hkv, hd = 4, 1024, 16, 8, 128
    assert fk.fwd_ops(B, S, S, Hq, hd, causal) == _smoke_flash(
        B, S, Hq, hd, causal, False)
    assert fk.bwd_ops(B, S, S, Hq, hd, causal) == _smoke_flash(
        B, S, Hq, hd, causal, True)
    q = _meta(B, S, Hq, hd, dtype=torch.bfloat16)
    k, v = (_meta(B, S, Hkv, hd, dtype=torch.bfloat16) for _ in range(2))

    def step(q, k, v):
        o = fk.flash_attention(q, k, v, causal=causal)
        return torch.autograd.grad(o, (q, k, v), torch.empty_like(o))

    before = _launches()
    counter = an.StepCounter()
    dq, dk, dv = counter.run(step, q, k, v)
    assert _launches() == before
    assert counter.flops == (_smoke_flash(B, S, Hq, hd, causal, False)
                             + _smoke_flash(B, S, Hq, hd, causal, True))
    assert counter.flops_by_op == {
        "repro_torch.flash_attention": _smoke_flash(B, S, Hq, hd, causal,
                                                    False),
        "repro_torch.flash_attention_bwd": _smoke_flash(B, S, Hq, hd, causal,
                                                        True)}
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    # the forward reads q, k, v and writes o and the logsumexp
    qkv = 2 * B * S * (Hq + 2 * Hkv) * hd
    assert counter.by_op["repro_torch.flash_attention"] == [
        1, qkv + 2 * B * S * Hq * hd + 4 * B * Hq * S]


def test_flash_causal_pairs_past_the_square():
    # every query row keeps min(row + 1, Skv) keys
    for Sq, Skv in ((5, 3), (3, 5), (4, 4)):
        want = sum(min(i + 1, Skv) for i in range(Sq))
        assert fk.pairs(Sq, Skv, True) == want
        assert fk.pairs(Sq, Skv, False) == Sq * Skv


@pytest.mark.parametrize("chunk,scratch", [(256, True), (16, False)])
def test_wkv6_operators_count_chip_smokes_operations(chunk, scratch):
    B, T, H, K = 2, 1024, 64, 64
    assert wk.wkv_ops(B, T, H, K, chunk) == _smoke_wkv(B, T, H, K, chunk,
                                                        False)
    assert wk.wkv_bwd_ops(B, T, H, K, chunk) == _smoke_wkv(B, T, H, K, chunk,
                                                            True)
    r, k, v, w = (_meta(B, T, H, K) for _ in range(4))
    u, S0 = _meta(H, K), _meta(B, H, K, K)

    def step(*args):
        y, S = wk.wkv6(*args[:5], chunk=chunk, S0=args[5])
        return torch.autograd.grad((y, S), args,
                                   (torch.empty_like(y), torch.empty_like(S)))

    before = _launches()
    counter = an.StepCounter()
    grads = counter.run(step, r, k, v, w, u, S0)
    assert _launches() == before
    assert counter.flops == (_smoke_wkv(B, T, H, K, chunk, False)
                             + _smoke_wkv(B, T, H, K, chunk, True))
    assert [g.shape for g in grads] == [t.shape for t in (r, k, v, w, u, S0)]
    # the chunk-parallel route's forward also returns its chunk-start
    # states (and the backward reads them); the tile-parallel route (chunk
    # 16) its tile-start states and decays
    n, nt = T // chunk, -(-T // 64)
    saved = (B * H * n * (K * K + (chunk // 64) * K + 2 * K) * 4 if scratch
             else B * H * nt * (K * K + K) * 4)
    fwd = (5 * B * T * H * K + H * K + 2 * B * H * K * K) * 4 + saved
    assert counter.by_op["repro_torch.wkv6"] == [1, fwd]


@pytest.mark.parametrize("T,chunk,how", [(1000, 8, "tile-parallel"),
                                         (1023, 1, "tile-parallel"),
                                         (500, 10, "tile-parallel")])
def test_wkv6_meta_route_returns_no_scratch(T, chunk, how):
    """A chunk below 64 takes the tile-parallel forward on meta as on the
    card (tiles of whole chunks: 64 rows at chunks 8 and 1, 60 at chunk 10,
    a ragged last tile each), and the backward ``how``: the forward's route
    at every chunk, 10 too.  The tile-parallel forward operator returns y,
    S and its tile scratch, each tile's start state and decay, which its
    backward reads and which under grad it keeps; the per-head forward (a
    width no multiple of 4) returns no scratch.  A step counts the chunked
    form's FLOPs at chunk L and the operands and results."""
    B, H, K = 2, 64, 64
    r, k, v, w = (_meta(B, T, H, K) for _ in range(4))
    u, S0 = _meta(H, K), _meta(B, H, K, K)
    assert wk.route(r, k, v, w, chunk) == "tile-parallel"
    assert wk.bwd_route(r, k, v, w, v, S0, chunk) == how
    with torch.no_grad():
        y, S, scratch = torch.ops.repro_torch.wkv6(r, k, v, w, u, S0, chunk)
    nt = -(-T // wk.tile_rows(chunk))
    assert [tuple(t.shape) for t in scratch] == [(B, H, nt, K, K),
                                                 (B, H, nt, K)]
    assert y.shape == v.shape and S.shape == S0.shape
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w)]
    y, _ = wk.wkv6(*leaves, u, chunk=chunk, S0=S0)
    kept = [t for t in y.grad_fn.saved_tensors if t is not None]
    assert len(kept) == 6 + 2
    r62, k62, v62, w62 = (_meta(B, T, H, 62) for _ in range(4))
    with torch.no_grad():
        out = torch.ops.repro_torch.wkv6(r62, k62, v62, w62, _meta(H, 62),
                                         None, chunk)
    assert wk.route(r62, k62, v62, w62, chunk) == "per-head"
    assert wk.bwd_route(r62, k62, v62, w62, v62, None, chunk) == "per-head"
    assert out[2] == []
    leaves = [t.clone().requires_grad_(True) for t in (r62, k62, v62, w62)]
    y62, _ = wk.wkv6(*leaves, _meta(H, 62), chunk=chunk)
    assert [t for t in y62.grad_fn.saved_tensors if t is not None
            and t.dim() == 5] == []

    def step(*args):
        y, S = wk.wkv6(*args[:5], chunk=chunk, S0=args[5])
        return torch.autograd.grad((y, S), args,
                                   (torch.empty_like(y), torch.empty_like(S)))

    before = _launches()
    counter = an.StepCounter()
    grads = counter.run(step, r, k, v, w, u, S0)
    assert _launches() == before
    assert counter.flops == (_smoke_wkv(B, T, H, K, chunk, False)
                             + _smoke_wkv(B, T, H, K, chunk, True))
    assert [g.shape for g in grads] == [t.shape for t in (r, k, v, w, u, S0)]
    saved = B * H * nt * (K * K + K) * 4
    fwd = (5 * B * T * H * K + H * K + 2 * B * H * K * K) * 4 + saved
    assert counter.by_op["repro_torch.wkv6"] == [1, fwd]


# --------------------------------------------------------------------------
# StepCounter by hand
# --------------------------------------------------------------------------

def test_counter_is_exact_on_a_chain_of_products():
    n, k, m, p = 64, 32, 48, 16
    x, w1, w2 = (torch.empty(s, device="meta") for s in ((n, k), (k, m),
                                                          (m, p)))

    def chain(x, w1, w2):
        h = x @ w1
        y = h @ w2
        del h                   # freed before the next product
        return torch.tanh(y @ w2.T)

    counter = an.StepCounter()
    out = counter.run(chain, x, w1, w2)
    f = 4                                           # f32 bytes
    assert counter.flops == 2 * n * k * m + 2 * n * m * p + 2 * n * p * m
    # each product reads its operands and writes its result; tanh reads
    # and writes (n, m); the transpose is a view
    assert counter.bytes == f * ((n * k + k * m + n * m)
                                 + (n * m + m * p + n * p)
                                 + (n * p + m * p + n * m)
                                 + 2 * n * m)
    args = f * (n * k + k * m + m * p)
    assert counter.argument_bytes == args
    # peak: h and y alive at the second product, then y and the last
    # product alive while tanh writes its result (h gone)
    assert counter.peak_bytes == args + f * max(n * m + n * p,
                                                n * p + 2 * n * m)
    assert counter.output_bytes == f * n * m
    mem = an.memory_summary(counter)
    assert mem["alias_gb"] == 0.0
    assert mem["peak_gb"] == pytest.approx(mem["argument_gb"]
                                           + mem["output_gb"]
                                           + mem["temp_gb"])
    assert out.shape == (n, m)


def test_views_and_allocations_move_no_bytes_and_broadcasts_count_once():
    x = torch.empty((8, 1, 16), device="meta")

    def step(x):
        y = x.expand(8, 4, 16)          # a view
        z = torch.empty((8, 4, 16), device="meta")
        return z.copy_(y)               # reads x once, writes z

    counter = an.StepCounter()
    counter.run(step, x)
    assert counter.bytes == 4 * (8 * 16 + 2 * 8 * 4 * 16)
    assert set(counter.by_op) == {"aten.copy_"}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b",
                                  "rwkv6-7b"])
def test_counter_flops_are_flop_counter_modes(arch):
    """``StepCounter`` reads ``FlopCounterMode``'s formulas without the
    mode: a grad step (the MoE's bf16-style ``bmm`` products, RWKV6's
    ``wkv6`` operators at T 512) counts the same FLOPs under both."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import LOCAL, init_params
    cfg = reduced_config(arch)
    params = init_params(cfg, None, device="meta")
    batch = {k: torch.empty((2, 512), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    step = make_grad_step(cfg, LOCAL)
    counter = an.StepCounter()
    counter.run(step, params, batch)

    def bmm(a_shape, b_shape, *args, out_shape=None, **kwargs):
        return 2 * a_shape[0] * a_shape[1] * a_shape[2] * b_shape[2]

    with FlopCounterMode(display=False,
                         custom_mapping={torch.ops.aten.bmm: bmm}) as mode:
        step(params, batch)
    assert counter.flops == mode.get_total_flops() > 0
