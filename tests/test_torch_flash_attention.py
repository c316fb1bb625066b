"""Parity of the port's attention (``repro_torch.models.attention``) and the
plain version of its flash-attention kernel
(``repro_torch.kernels.flash_attention``) with the JAX package.

On the CPU the kernel wrapper runs its plain version, the dense oracle.  It
is held to the JAX Pallas kernel run as the JAX tests run it
(``interpret=True``) and to the JAX oracle, at the shapes and tolerances
of ``tests/test_kernels.py::test_flash_attention_sweep``: 1e-4 in f32 (the
two sum the same products in another order and the Pallas kernel's online
softmax rescales) and 3e-2 in bf16 (one bf16 rounding of the output, at
most 2^-8 relative, on values of order 1).  Inputs are drawn with numpy
and rounded to bf16 identically on both sides.  The port's chunked online
softmax and its dense fallback are held to JAX's ``attention`` in f32
within 1e-5: the same f32 formula, summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import kernel as tk
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import attention as tattn

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def qkv(seed, B, Sq, Skv, Hq, Hkv, hd, dtype="float32"):
    """The same q, k, v for both packages, drawn with numpy."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, dtype=jdt) for a in arrs],
            [torch.tensor(a).to(tdt) for a in arrs])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,bq,bk", [
    (2, 256, 4, 2, 64, True, 64, 64),
    (1, 128, 8, 8, 32, False, 64, 32),
    (2, 192, 6, 3, 64, True, 64, 64),
    (1, 256, 4, 1, 128, True, 128, 64),
])
def test_plain_matches_jax_kernel(dtype, B, S, Hq, Hkv, hd, causal, bq, bk):
    (jq, jk_, jv), (tq, tk_, tv) = qkv(S + hd, B, S, S, Hq, Hkv, hd, dtype)
    tol = DTYPES[dtype][2]
    got = tk.flash_attention(tq, tk_, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = j_flash(jq, jk_, jv, causal=causal, block_q=bq, block_k=bk,
                   interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
    oracle = jattn.reference(jq, jk_, jv, causal=causal)
    np.testing.assert_allclose(f32(got), f32(oracle), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_oracle_at_a_ragged_shape(causal, dtype):
    """S = 200 fits no 64- or 128-row tile: the Pallas kernel refuses it,
    the JAX model takes its dense oracle, and so does the port's plain
    version (the CUDA kernel masks the ragged edges itself)."""
    (jq, jk_, jv), (tq, tk_, tv) = qkv(7, 2, 200, 200, 6, 3, 64, dtype)
    tol = DTYPES[dtype][2]
    got = tops.attention(tq, tk_, tv, causal=causal)
    want = jattn.reference(jq, jk_, jv, causal=causal)
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Skv,qc,kc,causal,triangle,q_offset,kv_len", [
    (64, 64, 16, 16, True, False, 0, None),      # chunked online softmax
    (64, 64, 16, 32, True, True, 0, None),       # triangle skips kv chunks
    (48, 96, 16, 32, False, False, 0, None),     # cross-length, not causal
    (32, 64, 16, 16, True, False, 32, 50),       # q offset and a kv length
    (40, 40, 16, 16, True, False, 0, None),      # not chunk-divisible: dense
    (8, 8, 16, 16, True, False, 0, None),        # small: dense
])
def test_attention_matches_jax(Sq, Skv, qc, kc, causal, triangle, q_offset,
                               kv_len):
    (jq, jk_, jv), (tq, tk_, tv) = qkv(Sq * 3 + Skv, 2, Sq, Skv, 4, 2, 16)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, q_chunk=qc,
              kv_chunk=kc, triangle=triangle)
    got = tattn.attention(tq, tk_, tv, **kw)
    want = jattn.attention(jq, jk_, jv, **kw)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


def test_reference_and_decode_attention_match_jax():
    (jq, jk_, jv), (tq, tk_, tv) = qkv(3, 2, 1, 24, 4, 2, 16)
    for kv_len in (1, 9, 24):
        got = tattn.decode_attention(tq, tk_, tv, kv_len)
        want = jattn.decode_attention(jq, jk_, jv, kv_len)
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    got = tattn.reference(tq, tk_, tv, causal=True, q_offset=20, kv_len=22)
    want = jattn.reference(jq, jk_, jv, causal=True, q_offset=20, kv_len=22)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


def test_wrapper_takes_the_plain_version_only_on_cpu():
    _, (tq, tk_, tv) = qkv(5, 1, 40, 40, 4, 2, 32)
    before = tk.flash_attention.launches
    got = tk.flash_attention(tq, tk_, tv, causal=True)
    want = tref.reference(tq, tk_, tv, causal=True)
    assert torch.equal(got, want)
    assert tk.flash_attention.launches == before
    # meta operands (the dry run's stand-in for the card) take the kernel's
    # operator without a launch; operands on two devices are refused
    out = tk.flash_attention(*(t.to("meta") for t in (tq, tk_, tv)))
    assert out.is_meta and out.shape == tq.shape
    assert tk.flash_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tk.flash_attention(tq.to("meta"), tk_, tv)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_tma_check_takes_contiguous_and_refuses_misaligned_views(hd):
    """What the tensor-core kernels' TMA loads need of a bf16 operand: a
    16-byte aligned base and batch / row / head strides of multiples of 16
    bytes, except on an axis of extent 1, which is never stepped (head width
    32, a 64-byte row: the wgmma backward's)."""
    B, S, H = 2, 40, 4
    assert tk._tma_ok(torch.zeros((B, S, H, hd), dtype=torch.bfloat16))
    wide = torch.zeros((B, S, H, hd + 8), dtype=torch.bfloat16)
    assert tk._tma_ok(wide[..., :hd])
    assert not tk._tma_ok(wide[..., 1:hd + 1])       # base 2 bytes off
    flat = torch.zeros((B, S, H * hd + 1), dtype=torch.bfloat16)
    rows = flat[..., :H * hd].unflatten(-1, (H, hd))
    assert rows.stride(1) * 2 % 16 and not tk._tma_ok(rows)
    buf = torch.zeros(S * H * hd + 8, dtype=torch.bfloat16)
    one = buf.as_strided((1, S, H, hd), (3, H * hd, hd, 1))
    assert tk._tma_ok(one)


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_p_split_keeps_the_bf16_gate_where_bf16_p_breaks_it(causal, hd):
    """Why the tensor-core kernel splits P.  Its plain version weighs v by
    the f32 softmax weights P, and the card holds the kernel to it within
    1e-5 + 2^-7 |plain| elementwise in bf16.  Emulated here in plain torch
    at the kernel's head widths (32: the reduced configs' in bf16, 128: the
    full-size ones'): P rounded to bf16 before P V breaks that gate by more
    than 10x on more than 5 % of the outputs (outputs near 0 move by about
    2^-10 |v|), while P_hi = bf16(P), P_lo = bf16(P - P_hi) and O = P_hi V
    + P_lo V keeps every output inside it."""
    rng = np.random.default_rng(0)
    B, S, H = 1, 256, 4
    q, k, v = (torch.tensor(rng.standard_normal((B, S, H, hd)),
                            dtype=torch.float32).bfloat16().float()
               for _ in range(3))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)

    def out(*parts):
        o = sum(torch.einsum("bhqk,bkhd->bhqd", part, v) for part in parts)
        return (o / l).bfloat16().double()

    want = out(p)
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()

    def ratio(got):
        return (got - want).abs() / (1e-5 + 2 ** -7 * want.abs())

    assert float(ratio(out(p_hi, p_lo)).max()) <= 1.0
    r_bf16 = ratio(out(p_hi))
    assert float(r_bf16.max()) > 10.0
    assert float((r_bf16 > 1.0).double().mean()) > 0.05


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grad_checks_the_backward_operands_before_the_forward(dtype):
    """bf16 runs the wgmma kernels both ways at every head width, so q, k and
    v must pass the TMA check, and a q that fails it (head width 32, rows off
    16 bytes) is refused before anything launches, with or without grad;
    f32 (the split-TF32 kernels both ways) takes it either way.  Meta
    operands stand in for the card: nothing launches."""
    B, S, H, hd = 2, 40, 4, 32
    flat = torch.zeros((B, S, H * hd + 1), dtype=dtype, device="meta")
    q = flat[..., :H * hd].unflatten(-1, (H, hd))   # rows 16-byte misaligned
    k = torch.zeros((B, S, 2, hd), dtype=dtype, device="meta")
    before = (tk.flash_attention.launches, tk.flash_attention_bwd.launches)
    if dtype == torch.bfloat16:
        assert tk.route(q) == "tensor_cores" and not tk._tma_ok(q)
        with pytest.raises(ValueError, match="TMA"):
            tk.flash_attention(q, k, k)
        q.requires_grad_(True)
        with pytest.raises(ValueError, match="TMA"):
            tk.flash_attention(q, k, k)
        with torch.no_grad(), pytest.raises(ValueError, match="TMA"):
            tk.flash_attention(q, k, k)
    else:
        assert tk.route(q) == "split_tf32"
        assert tk.flash_attention(q, k, k).is_meta
        q.requires_grad_(True)
        assert tk.flash_attention(q, k, k).is_meta
    assert (tk.flash_attention.launches,
            tk.flash_attention_bwd.launches) == before
