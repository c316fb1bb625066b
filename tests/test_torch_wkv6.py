"""Parity of the port's WKV paths (``repro_torch.models.rwkv``) and the plain
version of its WKV6 kernel (``repro_torch.kernels.rwkv6``) with the JAX
package.

The kernel computes the chunked form at the chunk it is given, and the
form's clamps make the result depend on the chunk once cumulative decays
pass 30, so the plain version is held to JAX's ``wkv_chunked`` at the same
chunk and to the Pallas kernel run as the JAX tests run it
(``interpret=True``).  Tolerances: in f32 1e-4 relative to the output's
largest magnitude (the same formula; cumulative sums and products summed in
another order, through exponentials of sums of up to 256 terms); in bf16
inputs 3e-2 as in ``tests/test_kernels.py::test_wkv6_sweep`` (one bf16
rounding of y).  The recurrence and the decode step are held within 1e-5
relative (the same products, summed in another order).

The CUDA kernel's chunk-parallel route is emulated here in plain torch: its
three passes (per-chunk state, prefix over chunks, output by 64-row
sub-tile, with the blocked scan of the decays) are held to JAX's
``wkv_chunked`` within the same 1e-4, and its TF32 products are emulated to
show why each is split in three (a single TF32 product breaks 1e-4 of
max |y|; the split stays within 1e-5 of an f64 evaluation), at chunks
that are multiples of 64 and at chunks that are not (a ragged last 64-row
sub-tile).  So is its tile-parallel route (chunks below 64): the same state
and prefix passes over tiles of whole chunks (64 rows where the chunk
divides 64, else as many whole chunks as fit), whose carries compose the
chunks', then a walk over each tile's chunks from the tile's state, at
decays on the -8 clamp and where the clip binds, with a ragged last tile.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_close
from repro.kernels.rwkv6.kernel import wkv6 as j_wkv6
from repro.models import rwkv as jrwkv
from repro.models.config import ModelConfig as JConfig
from repro_torch.kernels.rwkv6 import kernel as tk
from repro_torch.kernels.rwkv6 import ops as tops
from repro_torch.kernels.rwkv6 import ref as tref
from repro_torch.models import rwkv as trwkv
from repro_torch.models.config import ModelConfig as TConfig

SHAPES = [(2, 128, 3, 16, 32), (1, 256, 2, 64, 64), (2, 64, 4, 8, 16)]


def wkv_inputs(seed, B, T, H, K, *, decay_shift=-0.6, state=False):
    """r, k, v, w_log (B,T,H,K), u (H,K) and S0 (B,H,K,K) as numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)) for _ in range(3))
    w_log = -np.exp(rng.standard_normal((B, T, H, K)) * 0.5 + decay_shift)
    w_log = np.clip(w_log, -8.0, -1e-5)
    u = rng.standard_normal((H, K)) * 0.3
    S0 = (rng.standard_normal((B, H, K, K)) if state
          else np.zeros((B, H, K, K)))
    return [np.asarray(a, np.float32) for a in (r, k, v, w_log, u, S0)]


def both(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.tensor(a) for a in arrs]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("B,T,H,K,chunk", SHAPES)
def test_wkv_chunked_matches_jax(B, T, H, K, chunk, state):
    (jr, jk_, jv, jw, ju, jS), (tr, tk_, tv, tw, tu, tS) = both(
        wkv_inputs(T + K, B, T, H, K, state=state))
    y, S = trwkv.wkv_chunked(tr, tk_, tv, tw, tu, tS, chunk=chunk)
    jy, jS2 = jrwkv.wkv_chunked(jr, jk_, jv, jw, ju, jS, chunk=chunk)
    assert_rel_close(y, jy, 1e-4, "y")
    assert_rel_close(S, jS2, 1e-4, "S")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("B,T,H,K,chunk", SHAPES)
def test_plain_wkv6_matches_jax_kernel(B, T, H, K, chunk, dtype, tol):
    r, k, v, w, u, _ = wkv_inputs(B * T + H, B, T, H, K)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jS = j_wkv6(*(jnp.asarray(a, dtype=jdt) for a in (r, k, v, w)),
                    jnp.asarray(u), chunk=chunk, interpret=True)
    y, S = tk.wkv6(*(torch.tensor(a).to(tdt) for a in (r, k, v, w)),
                   torch.tensor(u), chunk=chunk)
    assert y.dtype == tdt and S.dtype == torch.float32
    assert_rel_close(y, jy, tol, "y")
    assert_rel_close(S, jS, tol, "S")


def test_clamped_decays_match_jax_at_the_same_chunk():
    """w_log near -8 per step: cumulative decays pass the +-30 clamp inside
    every chunk, so the chunked result depends on the chunk.  The port's
    plain wkv6 follows JAX's wkv_chunked at each chunk."""
    arrs = wkv_inputs(11, 2, 64, 2, 16, decay_shift=2.0, state=True)
    assert float(np.cumsum(arrs[3][:, :16], axis=1).min()) < -60
    (jr, jk_, jv, jw, ju, jS), (tr, tk_, tv, tw, tu, tS) = both(arrs)
    for chunk in (4, 16, 32):
        y, S = tk.wkv6(tr, tk_, tv, tw, tu, chunk=chunk, S0=tS)
        jy, jS2 = jrwkv.wkv_chunked(jr, jk_, jv, jw, ju, jS, chunk=chunk)
        assert_rel_close(y, jy, 1e-4, f"y chunk {chunk}")
        assert_rel_close(S, jS2, 1e-4, f"S chunk {chunk}")


def test_model_decays_at_the_prefill_chunk_match_jax():
    """The RWKV6 prefill's chunk (256 at T = 1024) with the model's decays
    (about -0.55 per step): the port's plain wkv6 follows JAX's
    wkv_chunked, and both depart from the exact recurrence, since half a
    chunk of decays passes the +-30 clamp (ROADMAP.md Queue 3)."""
    arrs = wkv_inputs(1024, 1, 1024, 2, 64)
    (jr, jk_, jv, jw, ju, jS), (tr, tk_, tv, tw, tu, _) = both(arrs)
    y, S = tk.wkv6(tr, tk_, tv, tw, tu, chunk=256)
    jy, jS2 = jrwkv.wkv_chunked(jr, jk_, jv, jw, ju, jS, chunk=256)
    assert_rel_close(y, jy, 1e-4, "y")
    assert_rel_close(S, jS2, 1e-4, "S")
    jy_rec, _ = jrwkv.wkv_recurrent(jr, jk_, jv, jw, ju, jS)
    departure = float(np.abs(np.asarray(jy) - np.asarray(jy_rec)).max()
                      / np.abs(np.asarray(jy_rec)).max())
    assert departure > 1.0, departure


def test_recurrence_and_step_match_jax():
    (jr, jk_, jv, jw, ju, jS), (tr, tk_, tv, tw, tu, tS) = both(
        wkv_inputs(3, 2, 24, 3, 8, state=True))
    jy, jS2 = jrwkv.wkv_recurrent(jr, jk_, jv, jw, ju, jS)
    for fn in (trwkv.wkv_recurrent, tref.reference):
        y, S = fn(tr, tk_, tv, tw, tu, tS)
        assert_rel_close(y, jy, 1e-5, "recurrent y")
        assert_rel_close(S, jS2, 1e-5, "recurrent S")
    y, S = trwkv.wkv_step(tr[:, 0], tk_[:, 0], tv[:, 0], tw[:, 0], tu, tS)
    jy, jS2 = jrwkv.wkv_step(jr[:, 0], jk_[:, 0], jv[:, 0], jw[:, 0], ju, jS)
    assert_rel_close(y, jy, 1e-5, "step y")
    assert_rel_close(S, jS2, 1e-5, "step S")


GRAD_INPUTS = ("x", "S", "shift", "u", "w0", "rwkv_wk")


@functools.lru_cache(maxsize=None)
def time_mix_params():
    """A small f32 RWKV6 configuration (both packages') and JAX's time-mix
    parameters, made once for the dispatch cases."""
    jcfg = JConfig(name="t", family="ssm", n_layers=1, d_model=32, n_heads=4,
                   n_kv=4, d_ff=64, vocab=16, rwkv=True, rwkv_head_dim=8,
                   dtype="float32", param_dtype="float32")
    tcfg = TConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    return jcfg, tcfg, jrwkv.time_mix_init(jcfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("T,chunk", [(1, 64), (12, 16), (48, 16), (2, 2),
                                     (16, 16), (128, 128)])
def test_time_mix_dispatch_matches_jax(T, chunk, monkeypatch):
    """T == 1 -> the step; 2 <= T <= chunk -> the wkv6 wrapper at chunk 1
    (JAX: the recurrence, the same function; its plain chunked version
    here); longer -> the wrapper at the chunk; each from a carried state.
    The output and new state within 1e-4 of JAX's; where 2 <= T <= chunk
    (as the model's chunk rule gives for T = 2, 16 and 128) also the
    gradients of x, S, the token shift, u, w0 and the key projection for
    cotangents on the output and the state, against JAX's vjp within 1e-4
    (f32 sums in another order).  The wrapper's chunk is spied on."""
    jcfg, tcfg, p = time_mix_params()
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 32)).astype(np.float32)
    S = rng.standard_normal((2, 4, 8, 8)).astype(np.float32) * 0.3
    shift = rng.standard_normal((2, 32)).astype(np.float32)
    g_out = rng.standard_normal((2, T, 32)).astype(np.float32)
    g_S = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    chunks, wrapper = [], tk.wkv6

    def spy(*args, chunk, **kw):
        chunks.append(chunk)
        return wrapper(*args, chunk=chunk, **kw)
    monkeypatch.setattr(tk, "wkv6", spy)
    graded = 2 <= T <= chunk
    ins = {"x": x, "S": S, "shift": shift, **{n: np.asarray(p[n]) for n in
                                               GRAD_INPUTS[3:]}}
    leaves = {n: torch.tensor(a, requires_grad=graded) for n, a in ins.items()}
    before = wrapper.launches
    out, st = trwkv.time_mix(
        tcfg, {**tp, **{n: leaves[n] for n in GRAD_INPUTS[3:]}}, leaves["x"],
        {"S": leaves["S"], "shift": leaves["shift"]}, chunk=chunk)

    @jax.jit
    def jax_side(ins, cots):
        def fn(x, S, shift, *params):
            out, st = jrwkv.time_mix(
                jcfg, {**p, **dict(zip(GRAD_INPUTS[3:], params))}, x,
                {"S": S, "shift": shift}, chunk=chunk)
            return out, st["S"], st["shift"]
        outs, pull = jax.vjp(fn, *ins)
        return outs, pull((*cots, jnp.zeros_like(outs[2])))
    (jout, jS, jshift), want = jax_side(
        [jnp.asarray(ins[n]) for n in GRAD_INPUTS],
        (jnp.asarray(g_out), jnp.asarray(g_S)))
    assert wrapper.launches == before
    assert chunks == ([] if T == 1 else [1] if T <= chunk else [chunk])
    assert_rel_close(out.detach(), jout, 1e-4, "out")
    assert_rel_close(st["S"].detach(), jS, 1e-4, "S")
    np.testing.assert_array_equal(st["shift"].detach().numpy(),
                                  np.asarray(jshift))
    if not graded:
        return
    got = torch.autograd.grad((out, st["S"]),
                              [leaves[n] for n in GRAD_INPUTS],
                              (torch.tensor(g_out), torch.tensor(g_S)))
    for name, g, w in zip(GRAD_INPUTS, got, want):
        assert_rel_close(g, w, 1e-4, f"d{name}")


def test_wrapper_takes_the_plain_version_only_on_cpu():
    r, k, v, w, u, S0 = (torch.tensor(a) for a in
                         wkv_inputs(5, 1, 32, 2, 8, state=True))
    before = tk.wkv6.launches
    y, S = tops.wkv(r, k, v, w, u, chunk=8)
    y0, S_0 = trwkv.wkv_chunked(r, k, v, w, u, torch.zeros_like(S0), chunk=8)
    assert torch.equal(y, y0) and torch.equal(S, S_0)
    y, S = tk.wkv6(r, k, v, w, u, chunk=8, S0=S0)
    y1, S1 = tref.chunked_reference(r, k, v, w, u, S0, chunk=8)
    assert torch.equal(y, y1) and torch.equal(S, S1)
    assert tk.wkv6.launches == before
    # meta operands (the dry run's stand-in for the card) take the kernel's
    # operator without a launch; operands on two devices are refused
    y, S = tk.wkv6(*(t.to("meta") for t in (r, k, v, w, u)), chunk=8)
    assert y.is_meta and S.is_meta and y.shape == v.shape
    assert tk.wkv6.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tk.wkv6(*(t.to("meta") for t in (r, k, v, w)), u, chunk=8)
    with pytest.raises(ValueError, match="divisible"):
        tk.wkv6(r, k, v, w, u, chunk=5)


# --------------------------------------------------------------------------
# the chunk-parallel route of csrc/wkv6.cu, emulated in plain torch
# --------------------------------------------------------------------------

SUB, SEG = 64, 16      # the kernel's sub-tile and scan-segment rows


def three_pass(r, k, v, w, u, S0, chunk):
    """The kernel's chunk-parallel route in f32: LW by the blocked scan
    (16-row segments summed in order, then the carry and the earlier
    segments' totals), a state pass per chunk (Z = LW[L // 2], D =
    e^{LW_end}, U = K2^T V summed by sub-tile), the prefix over chunks, and
    an output pass by 64-row sub-tile i (bonus, inter term, diagonal product
    masked m < t, full products with every earlier sub-tile).  A chunk that
    is no multiple of 64 ends in a ragged sub-tile, zeros past its rows."""
    B, T, H, K = r.shape
    n, nsub = T // chunk, -(-chunk // SUB)
    P = nsub * SUB                                          # padded rows
    f = lambda x: torch.cat([
        x.reshape(B, n, chunk, H, -1).permute(0, 3, 1, 2, 4),
        x.new_zeros(B, H, n, P - chunk, x.shape[-1])], 3)
    r_, k_, v_, w_ = (f(x) for x in (r, k, v, w))          # (B,H,n,P,K)
    local = w_.reshape(B, H, n, P // SEG, SEG, K).cumsum(4)
    base = torch.zeros(B, H, n, P // SEG, K)
    carry = torch.zeros(B, H, n, K)
    for sg in range(P // SEG):
        base[:, :, :, sg] = carry
        carry = carry + local[:, :, :, sg, -1]
    LW = (base[:, :, :, :, None] + local).reshape(B, H, n, P, K)
    LWp = LW - w_
    Z = LW[:, :, :, chunk // 2][:, :, :, None]

    # pass 1: per chunk
    LWe = LW[:, :, :, -1]
    K2 = k_ * torch.exp(LWe[:, :, :, None] - LW)
    U = sum(K2[:, :, :, s * SUB:(s + 1) * SUB].transpose(-1, -2)
            @ v_[:, :, :, s * SUB:(s + 1) * SUB] for s in range(nsub))
    D = torch.exp(LWe)
    # pass 2: the states at the chunks' starts, in order
    Sc, S = [], S0
    for c in range(n):
        Sc.append(S)
        S = D[:, :, c, :, None] * S + U[:, :, c]
    Sc = torch.stack(Sc, 2)
    # pass 3: by sub-tile
    Q = r_ * torch.exp((LWp - Z).clamp(-30, 30))
    Kf = k_ * torch.exp((Z - LW).clamp(-30, 30))
    R = r_ * torch.exp(LWp)
    bonus = (r_ * u[None, :, None, None] * k_).sum(-1, keepdim=True)
    mask = torch.ones(SUB, SUB, dtype=torch.bool).tril(-1)
    rows = lambda x, i: x[:, :, :, i * SUB:(i + 1) * SUB]
    y = torch.empty_like(v_)
    for i in range(nsub):
        yi = rows(R, i) @ Sc + rows(bonus, i) * rows(v_, i)
        A = (rows(Q, i) @ rows(Kf, i).transpose(-1, -2)).masked_fill(~mask, 0)
        yi = yi + A @ rows(v_, i)
        for j in range(i):
            yi = yi + (rows(Q, i) @ rows(Kf, j).transpose(-1, -2)) @ rows(v_, j)
        y[:, :, :, i * SUB:(i + 1) * SUB] = yi
    return y[:, :, :, :chunk].permute(0, 2, 3, 1, 4).reshape(B, T, H, -1), S


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("B,T,H,K,chunk", [(2, 512, 2, 64, 64),
                                           (2, 512, 2, 64, 128),
                                           (2, 512, 2, 64, 256),
                                           (2, 256, 3, 32, 64),
                                           (2, 384, 2, 64, 96),
                                           (1, 750, 2, 64, 375)])
def test_three_pass_emulation_matches_jax(B, T, H, K, chunk, state):
    """The chunk-parallel route's decomposition computes JAX's chunked form
    at the chunk it is given, within 1e-4 of max |y| and of max |S|: at
    multiples of 64 and at chunks of 96 and 375 (T = 48,000's chunk), whose
    last sub-tile is ragged (32 and 55 rows) and whose Z row (48, 187) is
    no segment's first."""
    arrs = wkv_inputs(T + chunk + K, B, T, H, K, state=state)
    (jr, jk_, jv, jw, ju, jS), targs = both(arrs)
    y, S = three_pass(*targs, chunk)
    jy, jS2 = jrwkv.wkv_chunked(jr, jk_, jv, jw, ju, jS, chunk=chunk)
    assert_rel_close(y, jy, 1e-4, "y")
    assert_rel_close(S, jS2, 1e-4, "S")


def tf32(x, rounding):
    """x (f32) with a 10-bit mantissa: round half away ("rna", as
    cvt.rna.tf32.f32) or truncate ("trunc", the kernel's masks)."""
    bits = x.float().contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & ~0x1fff).view(torch.float32).double()


def tf32_mm(parts, rounding):
    """a @ b on f32 operands as the tensor cores take them, summed in f64:
    one TF32 product, or three (a_hi b_hi + a_hi b_lo + a_lo b_hi, with
    hi = tf32(x) and lo = tf32(x - hi))."""
    def mm(a, b):
        a, b = a.float(), b.float()
        ah, bh = tf32(a, rounding), tf32(b, rounding)
        if parts == 1:
            return ah @ bh
        al = tf32((a.double() - ah).float(), rounding)
        bl = tf32((b.double() - bh).float(), rounding)
        return ah @ bh + ah @ bl + al @ bh
    return mm


def chunked_f64(r, k, v, w, u, S0, chunk, mm):
    """The chunked form in f64 with its four products (Q Kf^T, A V,
    (r e^{LWp}) S and K2^T V) through ``mm``."""
    B, T, H, K = r.shape
    n = T // chunk
    f = lambda x: x.double().reshape(B, n, chunk, H, -1).permute(0, 3, 1, 2, 4)
    r_, k_, v_, w_ = (f(x) for x in (r, k, v, w))
    S = S0.double()
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril(-1)
    ys = []
    for c in range(n):
        rc, kc, vc, wc = (x[:, :, c] for x in (r_, k_, v_, w_))
        LW = wc.cumsum(2)
        LWp = LW - wc
        Z = LW[:, :, chunk // 2][:, :, None]
        Q = rc * torch.exp((LWp - Z).clamp(-30, 30))
        Kf = kc * torch.exp((Z - LW).clamp(-30, 30))
        A = mm(Q, Kf.transpose(-1, -2)).masked_fill(~mask, 0.0)
        bonus = (rc * u.double()[None, :, None] * kc).sum(-1, keepdim=True)
        ys.append(mm(A, vc) + bonus * vc + mm(rc * torch.exp(LWp), S))
        LWe = LW[:, :, -1]
        K2 = kc * torch.exp(LWe[:, :, None] - LW)
        S = torch.exp(LWe)[..., None] * S + mm(K2.transpose(-1, -2), vc)
    return torch.stack(ys, 2), S


@pytest.mark.parametrize("B,T,H,K,chunk,shift,state", [
    (1, 512, 2, 64, 256, -0.6, False), (1, 64, 2, 64, 4, 2.0, True),
    (1, 750, 2, 64, 375, -0.6, False)])
def test_tf32_split_keeps_the_gate_where_one_tf32_product_breaks_it(
        B, T, H, K, chunk, shift, state):
    """Why the tensor-core kernel splits every product in three.  Against an
    f64 evaluation of the chunked form, with the smoke test's decay
    distributions: one TF32 product per product departs by more than 1e-4
    of max |y| (the kernel's gate), while the split stays within 1e-5 of
    max |y| and of max |S|, rounded to nearest (cvt.rna) or truncated (the
    kernel's masks) alike."""
    arrs = [torch.tensor(a) for a in
            wkv_inputs(0, B, T, H, K, decay_shift=shift, state=state)]
    exact = lambda a, b: a @ b
    y0, S0 = chunked_f64(*arrs, chunk, exact)

    def rel(mm):
        y, S = chunked_f64(*arrs, chunk, mm)
        return (float((y - y0).abs().max() / y0.abs().max()),
                float((S - S0).abs().max() / S0.abs().max()))

    assert rel(tf32_mm(1, "rna"))[0] > 1e-4
    for rounding in ("rna", "trunc"):
        ey, eS = rel(tf32_mm(3, rounding))
        assert ey <= 1e-5 and eS <= 1e-5, (rounding, ey, eS)


def test_route_by_chunk_and_alignment():
    """With K == V a multiple of 4 and 16-byte aligned operands, the
    chunk-parallel route takes chunks of 64 or more (multiples of 64, and
    375 as T = 48,000 gives) and the tile-parallel route chunks below 64
    (the 1040- and 300-token prompts' chunks 16 and 4, 32, and 10 as T =
    50,000 gives); the per-head kernel takes other widths and misaligned
    operands.  The backward takes the forward's route at every chunk,
    those that neither divide 64 nor are multiples of it (10, 375) too."""
    r, k, v, w, u, _ = (torch.tensor(a) for a in wkv_inputs(7, 1, 256, 2, 32))
    assert tk.route(r, k, v, w, 256) == "chunk-parallel"
    assert tk.route(r, k, v, w, 64) == "chunk-parallel"
    for chunk in (16, 4, 32, 8, 2, 1):
        assert tk.route(r, k, v, w, chunk) == "tile-parallel"
        assert tk.bwd_route(r, k, v, w, v, None, chunk) == "tile-parallel"
    assert tk.bwd_route(r, k, v, w, v, None, 64) == "chunk-parallel"
    r10 = torch.zeros((1, 250, 2, 32))
    assert tk.route(r10, r10, r10, r10, 10) == "tile-parallel"
    assert tk.bwd_route(r10, r10, r10, r10, r10, None, 10) == "tile-parallel"
    r375 = torch.zeros((1, 750, 2, 32))
    assert tk.route(r375, r375, r375, r375, 375) == "chunk-parallel"
    assert tk.bwd_route(r375, r375, r375, r375, r375, None, 375) == \
        "chunk-parallel"
    for chunk in (64, 16, 10, 375):
        assert tk.route(r, k, v[..., :28].contiguous(), w, chunk) == \
            "per-head"
    flat = torch.zeros(r.numel() + 1)
    shifted = flat[1:].view(r.shape)
    for chunk in (64, 16, 10, 375):
        assert tk.route(shifted, k, v, w, chunk) == "per-head"


@pytest.mark.parametrize("chunk, rows", [(1, 64), (3, 63), (10, 60),
                                         (12, 60), (32, 64), (48, 48),
                                         (63, 63)])
def test_tile_rows(chunk, rows):
    """The tile-parallel route's tile holds the whole chunks that fit in 64
    rows: 64 where the chunk divides 64."""
    assert tk.tile_rows(chunk) == rows


# T -> (chunk, forward route, backward route): the model's chunk rule at
# long prompts; 50,000, 48,000 and 64,000 give chunks that neither divide 64
# nor are multiples of it, whose backward takes the forward's route too
LONG_PROMPTS = {32768: (256, "chunk-parallel", "chunk-parallel"),
                36000: (1, "tile-parallel", "tile-parallel"),
                48000: (375, "chunk-parallel", "chunk-parallel"),
                50000: (10, "tile-parallel", "tile-parallel"),
                64000: (500, "chunk-parallel", "chunk-parallel")}


@pytest.mark.parametrize("T", list(LONG_PROMPTS))
def test_long_prompt_routes_on_meta(T, monkeypatch):
    """RWKV6-7B's layer (full width, one layer, batch 1) on meta tensors,
    the dry run's stand-in for the card, at long prompts: the model's own
    chunk rule picks the chunk, and its wkv6 call takes the route the card
    would (``LONG_PROMPTS``), with that route's scratch (the tile-parallel
    route's over ceil(T / m) tiles of m = chunk (64 // chunk) rows, the
    chunk-parallel route's carries over ceil(chunk / 64) sub-tiles); the
    backward takes the forward's route at every one of them, and under grad
    the forward keeps its scratch for it."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    want_chunk, want_fwd, want_bwd = LONG_PROMPTS[T]
    cfg = get_config("rwkv6-7b").replace(n_layers=1)
    params = init_params(cfg, None, device="meta")
    seen, wrapper = [], tk.wkv6

    def spy(r, k, v, w, u, *, chunk, S0=None):
        seen.append((chunk, tk.route(r, k, v, w, chunk),
                     tk.bwd_route(r, k, v, w, v, S0, chunk),
                     [tuple(t.shape) for t in torch.ops.repro_torch.wkv6(
                         r, k, v, w, u, S0, chunk)[2]]))
        return wrapper(r, k, v, w, u, chunk=chunk, S0=S0)
    monkeypatch.setattr(tk, "wkv6", spy)
    tokens = torch.empty((1, T), dtype=torch.int32, device="meta")
    logits = forward(cfg, params, {"tokens": tokens})[0]
    assert logits.is_meta and logits.shape == (1, T, cfg.vocab)
    H, K = cfg.n_heads, cfg.rwkv_head_dim
    if want_fwd == "tile-parallel":
        n = -(-T // tk.tile_rows(want_chunk))
        scratch = [(1, H, n, K, K), (1, H, n, K)]
    else:
        n = T // want_chunk
        scratch = [(1, H, n, K, K), (1, H, n, -(-want_chunk // 64), K),
                   (1, H, n, K), (1, H, n, K)]
    assert seen == [(want_chunk, want_fwd, want_bwd, scratch)]
    leaves = [torch.empty((1, T, 2, K), device="meta").requires_grad_(True)
              for _ in range(4)] + [torch.empty((2, K), device="meta")]
    y, _ = wrapper(*leaves, chunk=want_chunk)
    saved = [t for t in y.grad_fn.saved_tensors if t is not None]
    kept = {"tile-parallel": 2, "chunk-parallel": 4, "per-head": 0}
    assert len(saved) == 5 + kept[want_bwd]


# --------------------------------------------------------------------------
# the tile-parallel route of csrc/wkv6.cu, emulated in plain torch
# --------------------------------------------------------------------------

def tile_walk(r, k, v, w, u, S0, chunk):
    """The kernel's tile-parallel route in f32, at a chunk L below 64: tiles
    of m = L (64 // L) rows (whole chunks; 64 where L divides 64), the last
    ragged (T % m rows); the state pass over each tile padded to 64 rows,
    LW by the blocked scan from the tile's start, U = K2^T V and D =
    e^{LW_end}; the prefix over tiles (its last state is the output S);
    then per tile, from its state: LW inside each chunk (16-row segments
    summed in order from 0 at each chunk's first row; the rows of a chunk
    that started in an earlier segment add the tails of the segments since,
    in order), the chunks' own products masked to m < t inside a chunk over
    the whole tile, and the walk over the chunks, y += (r e^{LWp}) S_c and
    S <- e^{LW_end} S + K2^T V."""
    B, T, H, K = r.shape
    L = chunk
    m = tk.tile_rows(L)
    assert L < SUB and T % L == 0
    f = lambda x: x.permute(0, 2, 1, 3)                     # (B,H,T,.)
    r_, k_, v_, w_ = (f(x) for x in (r, k, v, w))
    y = torch.empty_like(v_)
    bonus = (r_ * u[None, :, None] * k_).sum(-1, keepdim=True)
    S = S0
    for t0 in range(0, T, m):
        n = min(m, T - t0)
        rt, kt, vt, wt = (x[:, :, t0:t0 + n] for x in (r_, k_, v_, w_))
        pad = lambda x: torch.cat(
            [x, x.new_zeros(B, H, SUB - n, x.shape[-1])], 2)
        wseg = pad(wt).reshape(B, H, SUB // SEG, SEG, K)
        local = wseg.cumsum(3)
        # the state pass: the tile's LW by the blocked scan
        base = torch.cat([torch.zeros(B, H, 1, K),
                          local[:, :, :-1, -1].cumsum(2)], 2)
        LWt = (base[:, :, :, None] + local).reshape(B, H, SUB, K)[:, :, :n]
        LWe = LWt[:, :, -1]
        U = (kt * torch.exp(LWe[:, :, None] - LWt)).transpose(-1, -2) @ vt
        S_tile = S
        S = torch.exp(LWe)[..., None] * S + U                # the prefix
        # the output pass: LW inside each chunk, by 16-row segment
        lw = torch.zeros(B, H, SUB, K)
        for i in range(SUB):
            restart = i % SEG == 0 or i % L == 0
            lw[:, :, i] = (0.0 if restart else lw[:, :, i - 1]) + pad(wt)[:, :, i]
        tails = lw.reshape(B, H, SUB // SEG, SEG, K)[:, :, :, -1].clone()
        if SEG % L:
            for sg in range(1, SUB // SEG):
                first = sg * SEG - sg * SEG % L
                carry = torch.zeros(B, H, K)
                for sg2 in range(first // SEG, sg):
                    carry = carry + tails[:, :, sg2]
                rows = slice(sg * SEG, min(first + L, (sg + 1) * SEG))
                lw[:, :, rows] = carry[:, :, None] + lw[:, :, rows]
        lw = lw[:, :, :n]
        c0 = torch.arange(n) // L * L
        Z, E = lw[:, :, c0 + L // 2], lw[:, :, c0 + L - 1]
        lwp = lw - wt
        Q = rt * torch.exp((lwp - Z).clamp(-30, 30))
        Kf = kt * torch.exp((Z - lw).clamp(-30, 30))
        R, K2 = rt * torch.exp(lwp), kt * torch.exp(E - lw)
        ti = torch.arange(n)
        mask = (ti[None, :] < ti[:, None]) & (c0[None, :] == c0[:, None])
        yt = (Q @ Kf.transpose(-1, -2)).masked_fill(~mask, 0.0) @ vt
        Sc = S_tile
        for c in range(0, n, L):
            rows = slice(c, c + L)
            yt[:, :, rows] += R[:, :, rows] @ Sc
            Sc = (torch.exp(lw[:, :, c + L - 1])[..., None] * Sc
                  + K2[:, :, rows].transpose(-1, -2) @ vt[:, :, rows])
        y[:, :, t0:t0 + n] = yt + bonus[:, :, t0:t0 + n] * vt
    return y.permute(0, 2, 1, 3), S


# chunk -> T: every chunk that divides 64 at T = 224 (three 64-row tiles
# and a ragged one of 32 rows); chunks that do not, each with a ragged last
# tile where one is possible (3: tiles of 63, the last 12 rows; 10 and 12:
# 60, the last 40 and 24; 48 and 63: one chunk a tile)
TILE_CHUNKS = {1: 224, 2: 224, 4: 224, 8: 224, 16: 224, 32: 224,
               3: 201, 10: 220, 12: 204, 48: 240, 63: 189}


@pytest.mark.parametrize("chunk", list(TILE_CHUNKS))
@pytest.mark.parametrize("case", ["clamp", "clip"])
def test_tile_walk_emulation_matches_jax(case, chunk):
    """The tile-parallel route's decomposition computes JAX's chunked form
    at chunks below 64, within 1e-4 of max |y| and of max |S|, from a
    state, with a ragged last tile (``TILE_CHUNKS``).  Decays on the -8
    clamp (64 rows span e^{-512}: every value finite, though a decay
    factored across a tile would overflow f32) and the 2.0-shift decays,
    where the clip binds inside chunks of 8 and more."""
    B, T, H, K = 2, TILE_CHUNKS[chunk], 2, 16
    arrs = wkv_inputs(chunk + T, B, T, H, K, decay_shift=2.0, state=True)
    if case == "clamp":
        arrs[3] = np.full_like(arrs[3], -8.0)
    (jr, jk_, jv, jw, ju, jS), targs = both(arrs)
    y, S = tile_walk(*targs, chunk)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    jy, jS2 = jrwkv.wkv_chunked(jr, jk_, jv, jw, ju, jS, chunk=chunk)
    assert_rel_close(y, jy, 1e-4, "y")
    assert_rel_close(S, jS2, 1e-4, "S")
