"""Parity of the plain versions of the flash-attention backward kernels
(``repro_torch.kernels.flash_attention.ref.forward_lse`` and ``backward``)
with JAX's gradients of ``repro.models.attention``.

The same numpy-seeded q, k, v and output cotangent go to ``jax.vjp`` of the
JAX oracle ``reference`` and of ``attention(..., loops="scan")`` (the
chunked online softmax where the shape divides into chunks, the dense
oracle where it does not), and to the port's ``forward_lse`` + ``backward``,
which are written out as the CUDA kernels compute them.  Tolerances, each
relative to the largest magnitude of the leaf: f32 1e-4 (the same f32
formulas, summed in another order; measured about 1e-6); bf16 3e-2, as the
forward's bf16 gate in ``test_torch_flash_attention.py``: the backward
forms D = rowsum(dO o) from the bf16-rounded output, as the kernels do,
where autograd uses the f32 one, so dQ and dK move by about 2^-8 of
their scale (measured 4e-3), and each gradient is rounded to bf16 once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_close
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import kernel as tkern
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import attention as tattn

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# (B, S, Hq, Hkv, hd): GQA groups 1, 2 and 4, head widths 32 / 64 / 128,
# ragged lengths (70, 100, 130: no multiple of 64) and one that divides
# into the JAX scan's 32-row chunks (96)
SHAPES = [(2, 70, 4, 4, 32), (1, 100, 4, 2, 64), (1, 130, 8, 2, 128),
          (2, 96, 8, 2, 32)]
CHUNK = 32


def inputs(seed, B, S, Hq, Hkv, hd, dtype):
    """q, k, v and dO for both packages, drawn with numpy."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for H in (Hq, Hkv, Hkv, Hq)]
    jdt, tdt, tol = DTYPES[dtype]
    return ([jnp.asarray(a, dtype=jdt) for a in arrs],
            [torch.tensor(a).to(tdt) for a in arrs], tol)


def jax_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, q, k, v)
    return out, vjp(do)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", SHAPES)
def test_plain_backward_matches_jax_vjp(B, S, Hq, Hkv, hd, causal, dtype):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), tol = inputs(
        S * Hq + hd, B, S, Hq, Hkv, hd, dtype)
    o, lse = tref.forward_lse(tq, tk, tv, causal=causal)
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    grads = tref.backward(tq, tk, tv, o, lse, tdo, causal=causal)
    assert [g.dtype for g in grads] == [tq.dtype] * 3
    for label, fn in (
            ("reference", lambda q, k, v: jattn.reference(
                q, k, v, causal=causal)),
            ("scan", lambda q, k, v: jattn.attention(
                q, k, v, causal=causal, q_chunk=CHUNK, kv_chunk=CHUNK,
                loops="scan"))):
        jo, jg = jax_grads(fn, jq, jk, jv, jdo)
        assert_rel_close(o, jo, tol, f"{label} o")
        for name, got, want in zip(("dq", "dk", "dv"), grads, jg):
            assert_rel_close(got, want, tol, f"{label} {name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", SHAPES)
def test_forward_lse_matches_jax_logsumexp(B, S, Hq, Hkv, hd, causal):
    """The logsumexp of each row's scaled, masked f32 scores, as JAX's
    oracle forms them, within 1e-5 relative (f32; about |lse| <= 10)."""
    (jq, jk, _, _), (tq, tk, tv, _), _ = inputs(
        S + Hkv, B, S, Hq, Hkv, hd, "float32")
    G = Hq // Hkv
    s = jnp.einsum("bqhgd,bkhd->bhgqk", jq.reshape(B, S, Hkv, G, hd),
                   jk) * hd ** -0.5
    if causal:
        keep = jnp.arange(S)[None, :] <= jnp.arange(S)[:, None]
        s = jnp.where(keep, s, jattn.NEG_INF)
    want = jax.nn.logsumexp(s, axis=-1).reshape(B, Hq, S)
    _, lse = tref.forward_lse(tq, tk, tv, causal=causal)
    assert_rel_close(lse, want, 1e-5, "lse")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", SHAPES[:3])
def test_plain_backward_matches_torch_autograd(B, S, Hq, Hkv, hd, causal,
                                               dtype):
    """Against autograd of the port's own dense ``attention.reference``,
    at the same tolerances (the forward half too: ``forward_lse`` weighs
    v by exp(s - lse), the oracle by softmax)."""
    _, (tq, tk, tv, tdo), tol = inputs(S + hd, B, S, Hq, Hkv, hd, dtype)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = tattn.reference(*leaves, causal=causal)
    want = torch.autograd.grad(out, leaves, tdo)
    o, lse = tref.forward_lse(tq, tk, tv, causal=causal)
    assert_rel_close(o, out.detach().float(), tol, "o")
    grads = tref.backward(tq, tk, tv, o, lse, tdo, causal=causal)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert_rel_close(got, w.float(), tol, name)


LOG2E = 1.4426950408889634


def split_backward(q, k, v, o, lse, do, *, causal, split=True):
    """The tensor-core backward kernels' rounding, emulated in f32 (a test
    helper, not a plain version of the kernels): bf16 q, k, v, o and dO, so
    S, dP and D are exact products with f32 sums; P = exp2(S scale log2 e -
    lse log2 e), 0 where the forward masked; dS = P (dP - D); then every
    product of P or dS takes it as two bf16 halves, hi = bf16(x) and lo =
    bf16(x - hi), each multiplied with f32 sums (``split=False``: hi
    alone)."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    f32 = torch.float32
    grp = lambda x: x.to(f32).reshape(B, Sq, Hkv, Hq // Hkv, hd)
    qf, of, dof = grp(q), grp(o), grp(do)
    kf, vf = k.to(f32), v.to(f32)
    scale = hd ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    lse2 = (lse * torch.tensor(LOG2E)).reshape(B, Hkv, -1, Sq)
    p = torch.exp2(s * torch.tensor(scale * LOG2E) - lse2[..., None])
    if causal:
        keep = torch.arange(Skv)[None, :] <= torch.arange(Sq)[:, None]
        p = torch.where(keep, p, torch.zeros(()))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    D = torch.einsum("bqhgd,bqhgd->bhgq", dof, of)
    ds = p * (dp - D[..., None])

    def halves(x):
        hi = x.to(torch.bfloat16).to(f32)
        return (hi, (x - hi).to(torch.bfloat16).to(f32)) if split else (hi,)

    dv = sum(torch.einsum("bhgqk,bqhgd->bkhd", x, dof) for x in halves(p))
    dk = sum(torch.einsum("bhgqk,bqhgd->bkhd", x, qf) for x in halves(ds))
    dq = sum(torch.einsum("bhgqk,bkhd->bqhgd", x, kf) for x in halves(ds))
    return dq.reshape(B, Sq, Hq, hd) * scale, dk * scale, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd",
                         [s for s in SHAPES if s[-1] in (64, 128)])
def test_split_products_meet_the_bf16_gate(B, S, Hq, Hkv, hd, causal):
    """The tensor-core route's arithmetic (``split_backward``) against
    ``ref.backward`` in f32 on the same bf16 inputs, per element within
    ``chip_smoke.py`` phase 11 (b)'s bf16 gate, 1e-5 max + 2^-7 |ref|,
    before the gradients are rounded to bf16.  Measured here: the split
    form at most 0.13 of the gate; the unsplit form (P and dS rounded to
    bf16 once) 31 to 73 times it, moving gradients near 0 by about 2^-9 of
    their scale, which is why the kernels split."""
    _, (tq, tk, tv, tdo), _ = inputs(S * Hq + hd, B, S, Hq, Hkv, hd,
                                     "bfloat16")
    o, lse = tref.forward_lse(tq, tk, tv, causal=causal)
    want = tref.backward(*(t.float() for t in (tq, tk, tv, o)), lse,
                         tdo.float(), causal=causal)
    got = split_backward(tq, tk, tv, o, lse, tdo, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = w.double()
        err = (g.double() - w).abs()
        tol = 1e-5 * w.abs().max() + 2.0 ** -7 * w.abs()
        assert bool((err <= tol).all()), (
            f"{name}: worst {float((err / tol).max())} of the gate")


def tf32(x):
    """x truncated to TF32 (sign, exponent and 10 mantissa bits) by
    masking its bits, as the kernels' ``split`` (``csrc/tf32.cuh``)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split_tf32_backward(q, k, v, o, lse, do, *, causal, split=True):
    """The f32 route's arithmetic (``flash_bwd_dq_tf32`` /
    ``flash_bwd_dkdv_tf32``), emulated in f32 (a test helper, not a plain
    version of the kernels): every product of S = Q K^T, dP = dO V^T, dV =
    P^T dO, dQ = dS K and dK = dS^T Q takes each operand x as hi =
    tf32(x) and lo = tf32(x - hi) and sums hi hi + hi lo + lo hi in f32
    (``split=False``: hi hi alone, TF32 products); P = exp2(S scale log2 e
    - lse log2 e), 0 where the forward masked; D = rowsum(dO o) in f32."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    grp = lambda x: x.reshape(B, Sq, Hkv, Hq // Hkv, hd)

    def prod(eq, a, b):
        ah, bh = tf32(a), tf32(b)
        out = torch.einsum(eq, ah, bh)
        if split:
            out = (out + torch.einsum(eq, ah, tf32(b - bh))
                   + torch.einsum(eq, tf32(a - ah), bh))
        return out

    qf, of, dof = grp(q), grp(o), grp(do)
    scale = hd ** -0.5
    s = prod("bqhgd,bkhd->bhgqk", qf, k)
    lse2 = (lse * torch.tensor(LOG2E)).reshape(B, Hkv, -1, Sq)
    p = torch.exp2(s * torch.tensor(scale * LOG2E) - lse2[..., None])
    if causal:
        keep = torch.arange(Skv)[None, :] <= torch.arange(Sq)[:, None]
        p = torch.where(keep, p, torch.zeros(()))
    dp = prod("bqhgd,bkhd->bhgqk", dof, v)
    D = torch.einsum("bqhgd,bqhgd->bhgq", dof, of)
    ds = p * (dp - D[..., None])
    dv = prod("bhgqk,bqhgd->bkhd", p, dof)
    dk = prod("bhgqk,bqhgd->bkhd", ds, qf)
    dq = prod("bhgqk,bkhd->bqhgd", ds, k)
    return dq.reshape(B, Sq, Hq, hd) * scale, dk * scale, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", SHAPES)
def test_split_tf32_products_meet_the_f32_gate(B, S, Hq, Hkv, hd, causal):
    """The f32 route's arithmetic (``split_tf32_backward``) against
    ``ref.backward`` in f32 on the same inputs, per element within
    ``chip_smoke.py`` phase 11 (b)'s f32 gate, 1e-5 max + 1e-4 |ref|.
    Measured here: the split form at most 0.16 of the gate; truncated TF32
    products alone (``split=False``) 38 to 276 times it, which is why the
    kernels split."""
    _, (tq, tk, tv, tdo), _ = inputs(S * Hq + hd, B, S, Hq, Hkv, hd,
                                     "float32")
    o, lse = tref.forward_lse(tq, tk, tv, causal=causal)
    want = tref.backward(tq, tk, tv, o, lse, tdo, causal=causal)
    got = split_tf32_backward(tq, tk, tv, o, lse, tdo, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = w.double()
        err = (g.double() - w).abs()
        tol = 1e-5 * w.abs().max() + 1e-4 * w.abs()
        assert bool((err <= tol).all()), (
            f"{name}: worst {float((err / tol).max())} of the gate")


def split_tf32_forward(q, k, v, *, causal, split=True):
    """The f32 forward's arithmetic (``flash_fwd_tf32``), emulated in f32 (a
    test helper, not a plain version of the kernel): over 64-column kv
    tiles, S = Q K^T (split TF32, as ``split_tf32_backward``'s products),
    scaled into the log2 domain and masked (-1e30 above the causal
    diagonal); the online softmax m' = max(m, rowmax S), P = exp2(S - m'),
    l = l exp2(m - m') + rowsum P, O = O exp2(m - m') + P V (split TF32;
    ``split=False``: TF32 products alone); then o = O / max(l, 1e-30) and
    lse = (m + log2 l) ln 2.  Returns (o, lse (B, Hq, Sq))."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv

    def prod(eq, a, b):
        ah, bh = tf32(a), tf32(b)
        out = torch.einsum(eq, ah, bh)
        if split:
            out = (out + torch.einsum(eq, ah, tf32(b - bh))
                   + torch.einsum(eq, tf32(a - ah), bh))
        return out

    qf = q.reshape(B, Sq, Hkv, G, hd)
    scale_log2 = torch.tensor(hd ** -0.5 * LOG2E)
    m = torch.full((B, Hkv, G, Sq), -1e30)
    l = torch.zeros((B, Hkv, G, Sq))
    acc = torch.zeros((B, Hkv, G, Sq, hd))
    for k0 in range(0, Skv, 64):
        s = prod("bqhgd,bkhd->bhgqk", qf, k[:, k0:k0 + 64]) * scale_log2
        if causal:
            keep = (torch.arange(k0, min(k0 + 64, Skv))[None, :]
                    <= torch.arange(Sq)[:, None])
            s = torch.where(keep, s, torch.tensor(-1e30))
        mn = torch.maximum(m, s.amax(-1))
        c = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        l = l * c + p.sum(-1)
        acc = acc * c[..., None] + prod("bhgqk,bkhd->bhgqd", p,
                                        v[:, k0:k0 + 64])
        m = mn
    o = acc / l.clamp_min(1e-30)[..., None]
    lse = (m + torch.log2(l)) * torch.tensor(0.6931471805599453)
    return (o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd),
            lse.reshape(B, Hq, Sq))


def worst_of_f32_gate(got, want):
    """max |got - want| / (1e-5 + 1e-4 |want|): ``chip_smoke.py`` phase
    1b's f32 gate, per element."""
    want = want.double()
    err = (got.double() - want).abs()
    return float((err / (1e-5 + 1e-4 * want.abs())).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", SHAPES)
def test_split_tf32_forward_meets_the_f32_gate(B, S, Hq, Hkv, hd, causal):
    """The f32 forward's arithmetic (``split_tf32_forward``) against
    ``ref.forward_lse`` on the same inputs: its output and logsumexp, per
    element within ``chip_smoke.py`` phase 1b's f32 gate, 1e-5 + 1e-4
    |ref|; truncated TF32 products alone (``split=False``) break that gate
    on the output, which is why the kernel splits.  Measured here: the
    split form at most 0.08 of the gate on the output and 0.03 on the
    logsumexp; TF32 products alone 48 to 84 times it on the output."""
    _, (tq, tk, tv, _), _ = inputs(S * Hq + hd + 1, B, S, Hq, Hkv, hd,
                                   "float32")
    want_o, want_lse = tref.forward_lse(tq, tk, tv, causal=causal)
    got_o, got_lse = split_tf32_forward(tq, tk, tv, causal=causal)
    assert worst_of_f32_gate(got_o, want_o) <= 1.0
    assert worst_of_f32_gate(got_lse, want_lse) <= 1.0
    tf32_o, _ = split_tf32_forward(tq, tk, tv, causal=causal, split=False)
    assert worst_of_f32_gate(tf32_o, want_o) > 1.0


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_route_by_dtype(dtype, hd):
    """One route a call, the same both ways: bfloat16 takes the wgmma
    kernels at every head width, float32 the split-TF32 ones; each
    direction counts a call in exactly one route."""
    q = torch.zeros((1, 8, 2, hd), dtype=dtype)
    want = "tensor_cores" if dtype == torch.bfloat16 else "split_tf32"
    assert tkern.route(q) == want and want in tkern.ROUTES
    for fn in (tkern.flash_attention, tkern.flash_attention_bwd):
        assert set(fn.route_launches) == set(tkern.ROUTES)
