"""Parity of the plain version of the WKV6 backward kernels
(``repro_torch.kernels.rwkv6.ref.chunked_backward``) with JAX's gradients
of ``repro.models.rwkv.wkv_chunked``.

The same numpy-seeded operands and cotangents (of y and of the final state)
go to ``jax.vjp`` of JAX's chunked form at a chunk and to the port's
``chunked_backward`` at the same chunk, which writes the six gradients out
chunk by chunk in reverse as ``csrc/wkv6_bwd.cu`` computes them.  The
chunked form at a chunk is the function both compute (its clips at +-30
make it depend on the chunk, ROADMAP Queue 3), so decays that saturate the
clips are held too, at the model's prefill chunk of 256 as
``test_torch_wkv6.py::test_model_decays_at_the_prefill_chunk_match_jax``
builds them and at a short chunk with decays near -8 a step.  Tolerance:
1e-4 of each gradient's largest magnitude, as the forward's parity tests
(the same f32 formulas summed in another order, through exponentials of
sums of up to 256 decays; measured below 1e-5).

The kernel's own order is emulated here in plain torch (``reverse_walk``):
the chunk-start states recomputed by a forward sweep, then each chunk in
reverse by 64-row sub-tiles taken last first, every product between a pair
of sub-tiles, and dw's reversed sum carried across the sub-tiles; it is
held to JAX at the same tolerance, as ``test_three_pass_emulation_
matches_jax`` holds the forward's chunk-parallel route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_close
from repro.models import rwkv as jrwkv
from repro_torch.kernels.rwkv6 import ref as tref

NAMES = ("dr", "dk", "dv", "dw", "du", "dS0")
SUB = 64          # the kernel's sub-tile rows
CLAMP = 30.0


def operands(seed, B, T, H, K, *, decay_shift=-0.6, state=True,
             final_cotangent=True):
    """r, k, v, w_log (B,T,H,K), u (H,K), S0 (B,H,K,K), dy (B,T,H,K) and
    the final state's cotangent dS (B,H,K,K) as numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)) for _ in range(3))
    w_log = -np.exp(rng.standard_normal((B, T, H, K)) * 0.5 + decay_shift)
    w_log = np.clip(w_log, -8.0, -1e-5)
    u = rng.standard_normal((H, K)) * 0.3
    S0 = (rng.standard_normal((B, H, K, K)) if state
          else np.zeros((B, H, K, K)))
    dy = rng.standard_normal((B, T, H, K))
    dS = (rng.standard_normal((B, H, K, K)) if final_cotangent
          else np.zeros((B, H, K, K)))
    return [np.asarray(a, np.float32)
            for a in (r, k, v, w_log, u, S0, dy, dS)]


def jax_vjp(arrs, chunk):
    r, k, v, w, u, S0, dy, dS = (jnp.asarray(a) for a in arrs)
    _, vjp = jax.vjp(lambda *x: jrwkv.wkv_chunked(*x, chunk=chunk),
                     r, k, v, w, u, S0)
    return vjp((dy, dS))


def check(got, want, label):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        assert_rel_close(g, w, 1e-4, f"{label} {name}")


@pytest.mark.parametrize("B,T,H,K,chunk,shift,state,final", [
    (2, 32, 2, 8, 4, -0.6, True, True),
    (1, 64, 3, 16, 16, -0.6, True, False),
    (2, 128, 2, 16, 64, -0.6, False, True),
    (1, 512, 2, 32, 256, -0.6, True, True),
    (2, 64, 2, 16, 16, 2.0, True, True),
    (1, 96, 2, 8, 4, 2.0, False, True),
])
def test_chunked_backward_matches_jax_vjp(B, T, H, K, chunk, shift, state,
                                          final):
    """Chunks 4, 16, 64 and 256; a zero and a nonzero S0; with and without
    a cotangent on the final state; decays near -8 a step (shift 2.0),
    whose cumulative sums pass the clips inside each chunk."""
    arrs = operands(T + chunk + K, B, T, H, K, decay_shift=shift,
                    state=state, final_cotangent=final)
    targs = [torch.tensor(a) for a in arrs]
    if shift > 0:
        assert float(np.cumsum(arrs[3][:, :chunk], axis=1).min()) < -30
    got = tref.chunked_backward(*targs[:7], targs[7] if final else None,
                                chunk=chunk)
    check(got, jax_vjp(arrs, chunk), f"chunk {chunk}")


def test_model_decays_at_the_prefill_chunk_match_jax():
    """The RWKV6 prefill's chunk (256 at T = 1024) with the model's decays
    (about -0.55 a step): half a chunk of decays passes the clips, so the
    gradients run through both the clipped and the passed branches."""
    arrs = operands(1024, 1, 1024, 2, 64)
    LW = np.cumsum(arrs[3][:, :256], axis=1)
    assert float(np.abs(LW - LW[:, 128:129]).max()) > CLAMP
    got = tref.chunked_backward(*(torch.tensor(a) for a in arrs), chunk=256)
    check(got, jax_vjp(arrs, 256), "model decays")


def test_chunked_backward_matches_torch_autograd():
    """Against autograd of the port's own ``wkv_chunked`` (what the CPU
    wrapper returns): the same formulas, within 1e-5."""
    arrs = [torch.tensor(a) for a in operands(5, 2, 128, 2, 16)]
    leaves = [a.clone().requires_grad_(True) for a in arrs[:6]]
    y, S = tref.chunked_reference(*leaves, chunk=32)
    want = torch.autograd.grad((y * arrs[6]).sum() + (S * arrs[7]).sum(),
                               leaves)
    got = tref.chunked_backward(*arrs, chunk=32)
    for name, g, w in zip(NAMES, got, want):
        assert_rel_close(g, w, 1e-5, name)


# --------------------------------------------------------------------------
# csrc/wkv6_bwd.cu's order, emulated in plain torch
# --------------------------------------------------------------------------

def reverse_walk(r, k, v, w, u, S0, dy, dS, chunk):
    """The backward kernels' order in f32 over (B, H) at once: the states
    at the chunks' starts by a forward sweep (K2^T v summed by sub-tile),
    then each chunk in reverse, its 64-row sub-tiles last first: dQ_i over
    the sub-tiles j <= i, dKf_i and dv_i over j >= i (the pair's own
    sub-tile masked m < t), the elementwise terms, dv's K2 dS' and diag
    terms, dS's R^T dy share, dw's reversed sum carried across sub-tiles,
    and dZ and dLW_end added at the chunk's end; du's (b, h) partials
    summed over b in order."""
    B, T, H, K = r.shape
    L, n = chunk, T // chunk
    tiles = [(s, min(s + SUB, L)) for s in range(0, L, SUB)]
    f = lambda x: x.reshape(B, n, L, H, -1).permute(0, 3, 1, 2, 4)
    r_, k_, v_, w_, dy_ = (f(x) for x in (r, k, v, w, dy))    # (B,H,n,L,.)
    clip = lambda x: x.clamp(-CLAMP, CLAMP)
    starts, S = [], S0
    for c in range(n):
        starts.append(S)
        LW = w_[:, :, c].cumsum(2)
        LWe = LW[:, :, -1]
        U = 0
        for a, b in tiles:
            K2 = k_[:, :, c, a:b] * torch.exp(LWe[:, :, None] - LW[:, :, a:b])
            U = U + K2.transpose(-1, -2) @ v_[:, :, c, a:b]
        S = torch.exp(LWe)[..., None] * S + U
    out = {x: torch.zeros_like(t) for x, t in (("r", r_), ("k", k_),
                                                ("v", v_), ("w", w_))}
    du = torch.zeros(B, H, K)
    for c in reversed(range(n)):
        rc, kc, vc, wc, dyc = (x[:, :, c] for x in (r_, k_, v_, w_, dy_))
        S = starts[c]
        LW = wc.cumsum(2)
        LWp = LW - wc
        Z = LW[:, :, L // 2][:, :, None]
        LWe = LW[:, :, -1]
        Q = rc * torch.exp(clip(LWp - Z))
        Kf = kc * torch.exp(clip(Z - LW))
        rows = lambda x, i: x[:, :, tiles[i][0]:tiles[i][1]]
        dZ = torch.zeros(B, H, K)
        dLWe = torch.zeros(B, H, K)
        run = torch.zeros(B, H, K)
        dS_acc = 0
        for i in reversed(range(len(tiles))):
            a, b = tiles[i]
            own = torch.ones(b - a, b - a, dtype=torch.bool).tril(-1)
            dQ = 0
            for j in range(i + 1):
                dA = rows(dyc, i) @ rows(vc, j).transpose(-1, -2)
                if j == i:
                    dA = dA.masked_fill(~own, 0.0)
                dQ = dQ + dA @ rows(Kf, j)
            dKf, dv = 0, 0
            for j in range(i, len(tiles)):
                A = rows(Q, j) @ rows(Kf, i).transpose(-1, -2)
                dA = rows(dyc, j) @ rows(vc, i).transpose(-1, -2)
                if j == i:
                    A, dA = A.masked_fill(~own, 0.0), dA.masked_fill(~own, 0.0)
                dv = dv + A.transpose(-1, -2) @ rows(dyc, j)
                dKf = dKf + dA.transpose(-1, -2) @ rows(Q, j)
            ri, ki, lw = rows(rc, i), rows(kc, i), rows(LW, i)
            lwp = lw - rows(wc, i)
            xq, xk = lwp - Z, Z - lw
            eQ, eK = torch.exp(clip(xq)), torch.exp(clip(xk))
            eP, e2 = torch.exp(lwp), torch.exp(LWe[:, :, None] - lw)
            R, K2 = ri * eP, ki * e2
            dR = rows(dyc, i) @ S.transpose(-1, -2)
            dK2 = rows(vc, i) @ dS.transpose(-1, -2)
            ddiag = (rows(dyc, i) * rows(vc, i)).sum(-1, keepdim=True)
            diag = (ri * u[None, :, None] * ki).sum(-1, keepdim=True)
            bonus = ddiag * u[None, :, None]
            out["r"][:, :, c, a:b] = dQ * eQ + dR * eP + bonus * ki
            out["k"][:, :, c, a:b] = dKf * eK + dK2 * e2 + bonus * ri
            out["v"][:, :, c, a:b] = dv + K2 @ dS + diag * rows(dyc, i)
            dS_acc = dS_acc + R.transpose(-1, -2) @ rows(dyc, i)
            gQ = torch.where(xq.abs() <= CLAMP, dQ * Q[:, :, a:b], 0.0)
            gK = torch.where(xk.abs() <= CLAMP, dKf * Kf[:, :, a:b], 0.0)
            dLWp, E = gQ + dR * R, -gK - dK2 * K2
            for t in reversed(range(b - a)):
                out["w"][:, :, c, a + t] = run + E[:, :, t]
                run = run + dLWp[:, :, t] + E[:, :, t]
                dZ = dZ + (gK - gQ)[:, :, t]
                dLWe = dLWe + (dK2 * K2)[:, :, t]
                du = du + (ddiag * ri * ki)[:, :, t]
        dLWe = dLWe + (dS * S).sum(-1) * torch.exp(LWe)
        out["w"][:, :, c] += dLWe[:, :, None]
        out["w"][:, :, c, :L // 2 + 1] += dZ[:, :, None]
        dS = torch.exp(LWe)[..., None] * dS + dS_acc
    back = lambda x: x.permute(0, 2, 3, 1, 4).reshape(B, T, H, -1)
    du_sum = du[0]
    for i in range(1, B):
        du_sum = du_sum + du[i]
    return (*(back(out[x]) for x in ("r", "k", "v", "w")), du_sum, dS)


@pytest.mark.parametrize("B,T,H,K,chunk,shift", [
    (2, 512, 2, 32, 256, -0.6),     # 4 sub-tiles a chunk
    (1, 384, 2, 16, 192, -0.6),     # 3 sub-tiles, L / 2 inside the second
    (2, 300, 2, 16, 100, -0.6),     # a ragged last sub-tile of 36 rows
    (1, 160, 2, 16, 16, 2.0),       # one sub-tile of 16 rows, clips passed
    (2, 64, 2, 8, 4, 2.0),          # the per-head route's chunk 4
])
def test_reverse_walk_emulation_matches_jax(B, T, H, K, chunk, shift):
    arrs = operands(T * K + chunk, B, T, H, K, decay_shift=shift)
    got = reverse_walk(*(torch.tensor(a) for a in arrs), chunk)
    check(got, jax_vjp(arrs, chunk), f"reverse walk chunk {chunk}")
