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
import functools

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


@functools.lru_cache(maxsize=None)
def _jitted_vjp(chunk):
    def vjp(r, k, v, w, u, S0, dy, dS):
        _, pull = jax.vjp(lambda *x: jrwkv.wkv_chunked(*x, chunk=chunk),
                          r, k, v, w, u, S0)
        return pull((dy, dS))
    return jax.jit(vjp)


def jitted_vjp(arrs, chunk):
    """``jax_vjp`` compiled once a chunk, for the cases that share a shape."""
    return _jitted_vjp(chunk)(*(jnp.asarray(a) for a in arrs))


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


# --------------------------------------------------------------------------
# the chunk-parallel route of csrc/wkv6_bwd.cu, emulated in plain torch
# --------------------------------------------------------------------------

SEG = 16          # the blocked scan's segment rows


def blocked_lw(w_, chunk):
    """LW of (B, H, n, L, K) decays by the forward's blocked scan: 16-row
    segments summed in order, then the carry and the earlier segments'
    totals; a chunk that is no multiple of 64 is padded with zeros to whole
    64-row sub-tiles, as the kernels' ragged last sub-tile is."""
    B, H, n, L, K = w_.shape
    P = -(-L // SUB) * SUB
    w_ = torch.cat([w_, w_.new_zeros(B, H, n, P - L, K)], 3)
    local = w_.reshape(B, H, n, P // SEG, SEG, K).cumsum(4)
    base = torch.zeros(B, H, n, P // SEG, K, dtype=w_.dtype)
    carry = torch.zeros(B, H, n, K, dtype=w_.dtype)
    for sg in range(P // SEG):
        base[:, :, :, sg] = carry
        carry = carry + local[:, :, :, sg, -1]
    return (base[:, :, :, :, None] + local).reshape(B, H, n, P, K)[:, :, :,
                                                                   :L]


def running_lw(w_):
    """LW of (B, H, n, L, K) decays as one running sum a channel from 0, the
    order of ``torch.cumsum`` on the card."""
    out, run = torch.empty_like(w_), torch.zeros_like(w_[:, :, :, 0])
    for t in range(w_.shape[3]):
        run = run + w_[:, :, :, t]
        out[:, :, :, t] = run
    return out


def chunk_parallel_walk(r, k, v, w, u, S0, dy, dS, chunk, mm=torch.matmul):
    """The chunk-parallel backward's passes over (B, H) and all chunks at
    once, every product through ``mm``: the forward's chunk-start states
    S_c and D = e^{LW_end}; the G pass (G_c = R_c^T dy_c by 64-row
    sub-tile); the reverse prefix of dS (dS'_c, the cotangent of chunk c's
    end state, and dS0); the main pass by sub-tile i (dQ_i over j <= i, dKf_i
    and dv_i over j >= i, the pair's own sub-tile masked m < t, dR_i, dK2_i
    and K2_i dS'_c, the elementwise terms, dw's within-tile reversed sum and
    the sub-tile's per-channel totals); and the fix-up (the later sub-tiles'
    totals, dLW_end and dZ into dw; du's partials in a fixed order).  The
    forward's passes, G and the products take LW by the blocked scan; the
    elementwise terms take it as the plain version sums it (``running_lw``),
    on which the clips' gradient masks are decided.  A chunk that is no
    multiple of 64 ends in a ragged sub-tile of L - 64 (nsub - 1) rows, nsub
    = ceil(L / 64), which every pass bounds (its slices here)."""
    B, T, H, K = r.shape
    L, n, nsub = chunk, T // chunk, -(-chunk // SUB)
    f = lambda x: x.reshape(B, n, L, H, -1).permute(0, 3, 1, 2, 4)
    r_, k_, v_, w_, dy_ = (f(x) for x in (r, k, v, w, dy))    # (B,H,n,L,.)
    tile = lambda x, i: x[:, :, :, i * SUB:(i + 1) * SUB]
    tr = lambda x: x.transpose(-1, -2)
    LW = blocked_lw(w_, L)
    LWp = LW - w_
    Z = LW[:, :, :, L // 2][:, :, :, None]
    LWe = LW[:, :, :, -1]
    D = torch.exp(LWe)                                           # (B,H,n,K)
    # the forward's passes 1 and 2: the chunk-start states
    K2 = k_ * torch.exp(LWe[:, :, :, None] - LW)
    U = sum(mm(tr(tile(K2, s)), tile(v_, s)) for s in range(nsub))
    Sc, S = [], S0
    for c in range(n):
        Sc.append(S)
        S = D[:, :, c, :, None] * S + U[:, :, c]
    Sc = torch.stack(Sc, 2)
    # the G pass and the reverse prefix
    R = r_ * torch.exp(LWp)
    G = sum(mm(tr(tile(R, s)), tile(dy_, s)) for s in range(nsub))
    dSc, dSp = [None] * n, torch.zeros_like(S0) if dS is None else dS
    for c in reversed(range(n)):
        dSc[c] = dSp
        dSp = D[:, :, c, :, None] * dSp + G[:, :, c]
    dSc = torch.stack(dSc, 2)
    # the main pass, one sub-tile i at a time over every chunk
    clip = lambda x: torch.exp(x.clamp(-CLAMP, CLAMP))
    Q, Kf = r_ * clip(LWp - Z), k_ * clip(Z - LW)
    # the elementwise terms' LW, Z and LW_end, in the plain version's order
    LW = running_lw(w_)
    LWp, Z, LWe = LW - w_, LW[:, :, :, L // 2][:, :, :, None], LW[:, :, :, -1]
    xq, xk = LWp - Z, Z - LW
    eQ, eK = clip(xq), clip(xk)
    K2, R = k_ * torch.exp(LWe[:, :, :, None] - LW), r_ * torch.exp(LWp)
    diag = (r_ * u[None, :, None, None] * k_).sum(-1, keepdim=True)
    ddiag = (dy_ * v_).sum(-1, keepdim=True)
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r_, k_, v_, w_))
    tots = torch.zeros(B, H, n, nsub, 4, K, dtype=r.dtype)
    for i in range(nsub):
        ri = min(SUB, L - i * SUB)                      # sub-tile i's rows
        lower = torch.ones(ri, ri, dtype=torch.bool).tril(-1)   # m < t
        dQ = 0
        for j in range(i + 1):
            dA = mm(tile(dy_, i), tr(tile(v_, j)))
            dQ = dQ + mm(dA.masked_fill(~lower, 0) if j == i else dA,
                         tile(Kf, j))
        dKf = dvi = 0
        for j in range(i, nsub):
            AT = mm(tile(Kf, i), tr(tile(Q, j)))
            dAT = mm(tile(v_, i), tr(tile(dy_, j)))
            if j == i:
                AT, dAT = AT.masked_fill(~lower.T, 0), dAT.masked_fill(
                    ~lower.T, 0)
            dvi = dvi + mm(AT, tile(dy_, j))
            dKf = dKf + mm(dAT, tile(Q, j))
        dR = mm(tile(dy_, i), tr(Sc))
        dK2 = mm(tile(v_, i), tr(dSc))
        dv[:, :, :, i * SUB:(i + 1) * SUB] = (
            dvi + mm(tile(K2, i), dSc) + tile(diag, i) * tile(dy_, i))
        ri, ki = tile(r_, i), tile(k_, i)
        bonus = tile(ddiag, i) * u[None, :, None, None]
        eP, e2 = torch.exp(tile(LWp, i)), torch.exp(LWe[:, :, :, None]
                                                     - tile(LW, i))
        dr[:, :, :, i * SUB:(i + 1) * SUB] = (dQ * tile(eQ, i) + dR * eP
                                              + bonus * ki)
        dk[:, :, :, i * SUB:(i + 1) * SUB] = (dKf * tile(eK, i) + dK2 * e2
                                              + bonus * ri)
        gQ = torch.where(tile(xq, i).abs() <= CLAMP, dQ * ri * tile(eQ, i),
                         0.0)
        gK = torch.where(tile(xk, i).abs() <= CLAMP, dKf * ki * tile(eK, i),
                         0.0)
        E = -gK - dK2 * tile(K2, i)
        fr = gQ + dR * tile(R, i) + E                    # dLWp + E
        after = fr.flip(3).cumsum(3).flip(3) - fr        # sum over s > t
        dw[:, :, :, i * SUB:(i + 1) * SUB] = after + E
        tots[:, :, :, i] = torch.stack(
            [fr.sum(3), (gK - gQ).sum(3), (dK2 * tile(K2, i)).sum(3),
             (tile(ddiag, i) * ri * ki).sum(3)], 3)
    # the fix-up
    dLWe = tots[:, :, :, :, 2].sum(3) + (dSc * Sc).sum(-1) * D
    dZ = tots[:, :, :, :, 1].sum(3)
    for i in range(nsub):
        later = tots[:, :, :, i + 1:, 0].sum(3)
        rows = torch.arange(i * SUB, min((i + 1) * SUB, L))
        half = (rows <= L // 2).to(r.dtype)[:, None]
        dw[:, :, :, i * SUB:(i + 1) * SUB] += ((later + dLWe)[:, :, :, None]
                                               + half * dZ[:, :, :, None])
    du = tots[:, :, :, :, 3].sum((2, 3))
    du_sum = du[0]
    for b in range(1, B):
        du_sum = du_sum + du[b]
    back = lambda x: x.permute(0, 2, 3, 1, 4).reshape(B, T, H, -1)
    return (*(back(x) for x in (dr, dk, dv, dw)), du_sum, dSp)


@pytest.mark.parametrize("B,T,H,K,chunk,shift,state,final", [
    (2, 512, 2, 32, 256, -0.6, True, True),     # 4 sub-tiles a chunk
    (1, 768, 2, 16, 256, -0.6, False, False),   # S0 and dS both zero
    (1, 384, 2, 16, 192, -0.6, True, True),     # L / 2 in the second sub-tile
    (2, 256, 2, 16, 64, -0.6, True, True),      # one sub-tile a chunk
    (1, 512, 2, 16, 128, 2.0, True, True),      # decays past the clips
    (2, 256, 2, 8, 64, 2.0, False, False),
    (1, 130, 2, 16, 65, -0.6, True, True),      # a ragged sub-tile of 1 row
    (2, 192, 2, 16, 96, 2.0, True, True),       # 32 rows, past the clips
    (1, 288, 2, 8, 96, -0.6, False, False),
    (1, 750, 2, 16, 375, -0.6, True, True),     # 55 rows, L / 2 in the 3rd
])
def test_chunk_parallel_walk_matches_jax(B, T, H, K, chunk, shift, state,
                                         final):
    """The chunk-parallel backward's decomposition computes the gradients of
    JAX's chunked form at the chunk it is given, within 1e-4 of each
    gradient's largest magnitude: at multiples of 64, and at chunks that
    are not (65, 96 and T = 48,000's 375), whose last sub-tile is ragged."""
    arrs = operands(T * K + chunk + 1, B, T, H, K, decay_shift=shift,
                    state=state, final_cotangent=final)
    if shift > 0:
        assert float(np.cumsum(arrs[3][:, :chunk], axis=1).min()) < -CLAMP
    targs = [torch.tensor(a) for a in arrs]
    got = chunk_parallel_walk(*targs[:7], targs[7] if final else None, chunk)
    check(got, jax_vjp(arrs, chunk), f"chunk-parallel walk chunk {chunk}")


def test_chunk_parallel_walk_at_the_model_decays():
    """The RWKV6 train and prefill chunk of 256 with the model's decays,
    whose clips pass half a chunk's gradients and zero the rest."""
    arrs = operands(1025, 1, 1024, 2, 64)
    got = chunk_parallel_walk(*(torch.tensor(a) for a in arrs), 256)
    check(got, jax_vjp(arrs, 256), "chunk-parallel walk, model decays")


def test_bwd_tf32_split_keeps_the_gate_where_one_tf32_product_breaks_it():
    """Why the backward splits every product in three, as the forward does.
    Through the chunk-parallel walk in f64 at chunk 256 with the model's
    decays, against the same walk with exact products: one TF32 product per
    product departs by more than 1e-4 of some gradient's largest magnitude
    (the gate), while the split stays within 1e-5 of each, rounded to
    nearest or truncated (the kernel's masks) alike."""
    from test_torch_wkv6 import tf32_mm
    arrs = [torch.tensor(a).double()
            for a in operands(3, 1, 512, 2, 64)]
    want = chunk_parallel_walk(*arrs, 256)

    def worst(mm):
        got = chunk_parallel_walk(*arrs, 256, mm=mm)
        return max(float((g - w).abs().max() / w.abs().max())
                   for g, w in zip(got, want))

    assert worst(tf32_mm(1, "rna")) > 1e-4
    for rounding in ("rna", "trunc"):
        assert worst(tf32_mm(3, rounding)) <= 1e-5, rounding


# --------------------------------------------------------------------------
# the tile-parallel route of csrc/wkv6_bwd.cu, emulated in plain torch
# --------------------------------------------------------------------------

def tile_parallel_walk(r, k, v, w, u, S0, dy, dS, chunk):
    """The tile-parallel backward's passes over (B, H) at once, at a chunk
    L below 64, over tiles of m = L (64 // L) rows, whole chunks (64 where
    L divides 64; the last tile ragged): the forward's tile passes (LW by
    the blocked scan from each tile's start, U = K2^T V and D = e^{LW_end};
    the prefix, each tile's start state); G = (r e^{LWp})^T dy a tile and
    the reverse prefix over the tiles (each tile's end cotangent, dS0); then
    per tile: LW inside each chunk as one running sum from the chunk's first
    row, the chunks' own products over the tile masked to one chunk, the
    forward walk from the tile's start state (dR, and in slot w of at most 8
    the state at the first chunk start of 8-row window w), the backward walk
    from its end cotangent (dv's K2 dS' and dK2; at each chunk's first row
    e^{LW_end} <dS'_c, S_c> for dLW_end, S_c taken from its window's slot
    at L >= 8 and walked forward again from it at L < 8; then dS' <-
    e^{LW_end} dS' + R^T dy), the elementwise terms, dw's reversed sum
    inside each chunk; du by tile, the tiles added in order, then the
    batches."""
    B, T, H, K = r.shape
    L = chunk
    assert L < SUB and T % L == 0
    m = L * (SUB // L)
    tr = lambda x: x.transpose(-1, -2)
    f = lambda x: x.permute(0, 2, 1, 3)                     # (B,H,T,.)
    r_, k_, v_, w_, dy_ = (f(x) for x in (r, k, v, w, dy))
    tiles = [(a, min(a + m, T)) for a in range(0, T, m)]

    def tile_lw(x):
        """LW of a tile's rows by the blocked scan from 0."""
        n = x.shape[2]
        pad = torch.cat([x, x.new_zeros(B, H, SUB - n, K)], 2)
        local = pad.reshape(B, H, SUB // SEG, SEG, K).cumsum(3)
        base = torch.cat([torch.zeros(B, H, 1, K),
                          local[:, :, :-1, -1].cumsum(2)], 2)
        return (base[:, :, :, None] + local).reshape(B, H, SUB, K)[:, :, :n]
    # the forward's tile passes, then G and the reverse prefix over tiles
    St, Dt, S = [], [], S0
    G = []
    for a, b in tiles:
        LW = tile_lw(w_[:, :, a:b])
        LWe = LW[:, :, -1]
        U = tr(k_[:, :, a:b] * torch.exp(LWe[:, :, None] - LW)) @ v_[:, :, a:b]
        St.append(S)
        Dt.append(torch.exp(LWe))
        S = torch.exp(LWe)[..., None] * S + U
        G.append(tr(r_[:, :, a:b] * torch.exp(LW - w_[:, :, a:b]))
                 @ dy_[:, :, a:b])
    dSt = [None] * len(tiles)
    ds = torch.zeros_like(S0) if dS is None else dS
    for i in reversed(range(len(tiles))):
        dSt[i] = ds
        ds = Dt[i][..., None] * ds + G[i]
    dS0 = ds
    clip = lambda x: torch.exp(x.clamp(-CLAMP, CLAMP))
    outer = lambda a, b: a[..., :, None] * b[..., None, :]
    out = {x: torch.empty_like(t) for x, t in (("r", r_), ("k", k_),
                                                ("v", v_), ("w", w_))}
    du_tiles = []
    for i, (a, b) in enumerate(tiles):
        n = b - a
        rt, kt, vt, wt, dyt = (x[:, :, a:b] for x in (r_, k_, v_, w_, dy_))
        LW = torch.empty_like(wt)
        for t in range(n):
            LW[:, :, t] = wt[:, :, t] if t % L == 0 else LW[:, :, t - 1] \
                + wt[:, :, t]
        c0 = torch.arange(n) // L * L
        Z, LWe = LW[:, :, c0 + L // 2], LW[:, :, c0 + L - 1]
        LWp = LW - wt
        xq, xk = LWp - Z, Z - LW
        eQ, eK, eP, e2 = clip(xq), clip(xk), torch.exp(LWp), torch.exp(LWe
                                                                      - LW)
        Q, Kf, R, K2 = rt * eQ, kt * eK, rt * eP, kt * e2
        D = torch.exp(LW)                      # read at chunks' last rows
        ti = torch.arange(n)
        own = (ti[None, :] < ti[:, None]) & (c0[None, :] == c0[:, None])
        dA = (dyt @ tr(vt)).masked_fill(~own, 0.0)
        A = (Q @ tr(Kf)).masked_fill(~own, 0.0)
        dQ, dKf, dv = dA @ Kf, tr(dA) @ Q, tr(A) @ dyt
        s, up, slots = St[i], 0.0, {}
        dR, dK2, dvs = (torch.empty_like(x) for x in (rt, kt, vt))
        for t in range(n):                     # the forward walk
            if t % L == 0 and t // 8 not in slots:   # the window's first
                slots[t // 8] = s                    # chunk start
            dR[:, :, t] = torch.einsum("bhv,bhkv->bhk", dyt[:, :, t], s)
            up = up + outer(K2[:, :, t], vt[:, :, t])
            if (t + 1) % L == 0:
                s, up = D[:, :, t, :, None] * s + up, 0.0
        assert len(slots) <= 8

        def chunk_state(t):
            """S_c of the chunk that starts at row t, from its window's
            slot: the slot's own state at L >= 8 (a window holds one chunk
            start at most), else walked forward again from the window's
            first chunk start."""
            sc = slots[t // 8]
            if L < 8:
                up = 0.0
                for x in range(-(-(t // 8 * 8) // L) * L, t):
                    up = up + outer(K2[:, :, x], vt[:, :, x])
                    if (x + 1) % L == 0:
                        sc, up = D[:, :, x, :, None] * sc + up, 0.0
            return sc
        s, up, sd = dSt[i], 0.0, {}
        for t in reversed(range(n)):           # the backward walk
            dvs[:, :, t] = torch.einsum("bhk,bhkv->bhv", K2[:, :, t], s)
            dK2[:, :, t] = torch.einsum("bhv,bhkv->bhk", vt[:, :, t], s)
            up = up + outer(R[:, :, t], dyt[:, :, t])
            if t % L == 0:
                d = D[:, :, t + L - 1]
                # e^{LW_end} <dS', S>
                sd[t] = d * (s * chunk_state(t)).sum(-1)
                s, up = d[..., None] * s + up, 0.0
        ddiag = (dyt * vt).sum(-1, keepdim=True)
        diag = (rt * u[None, :, None] * kt).sum(-1, keepdim=True)
        bonus = ddiag * u[None, :, None]
        out["r"][:, :, a:b] = dQ * eQ + dR * eP + bonus * kt
        out["k"][:, :, a:b] = dKf * eK + dK2 * e2 + bonus * rt
        out["v"][:, :, a:b] = dv + dvs + diag * dyt
        gQ = torch.where(xq.abs() <= CLAMP, dQ * Q, 0.0)
        gK = torch.where(xk.abs() <= CLAMP, dKf * Kf, 0.0)
        k2k2 = dK2 * K2
        E = -gK - k2k2
        fr = gQ + dR * R + E                   # dLWp + E
        half = (torch.arange(L) <= L // 2).to(r.dtype)[:, None]
        for c in range(0, n, L):
            rows = slice(c, c + L)
            dlwe = k2k2[:, :, rows].sum(2) + sd[c]
            dz = (gK - gQ)[:, :, rows].sum(2)
            after = fr[:, :, rows].flip(2).cumsum(2).flip(2) - fr[:, :, rows]
            out["w"][:, :, a + c:a + c + L] = (
                after + E[:, :, rows] + dlwe[:, :, None]
                + half * dz[:, :, None])
        du_tiles.append((ddiag * rt * kt).sum(2))
    du = du_tiles[0]
    for x in du_tiles[1:]:
        du = du + x
    du_sum = du[0]
    for b in range(1, B):
        du_sum = du_sum + du[b]
    back = lambda x: x.permute(0, 2, 1, 3)
    return (*(back(out[x]) for x in ("r", "k", "v", "w")), du_sum, dS0)


@pytest.fixture
def one_thread():
    """Torch on one thread for a test of many tiny ops: beside the other
    test workers, a pool of threads a small product only waits on them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# chunk -> T: three 64-row tiles and a ragged one of 32 rows where the chunk
# divides 64; else tiles of m = chunk (64 // chunk) rows, the last ragged
# where m holds more than one chunk (3: 63 rows, the last 30; 10: 60, the
# last 40; 12: 60, the last 36), one chunk a tile at 48 and 63
TILE_WALK_T = {1: 224, 2: 224, 4: 224, 8: 224, 16: 224, 32: 224,
               3: 219, 10: 220, 12: 216, 48: 240, 63: 252}


@pytest.mark.parametrize("chunk", list(TILE_WALK_T))
@pytest.mark.parametrize("case", ["model", "clip", "clamp"])
def test_tile_parallel_walk_matches_jax(case, chunk, one_thread):
    """The tile-parallel backward's decomposition computes the gradients of
    JAX's chunked form at every chunk below 64, within 1e-4 of each
    gradient's largest magnitude, on T = ``TILE_WALK_T[chunk]`` (ragged
    last tiles), from a state and with a cotangent on the final state: at
    the model's decays (shift -0.6), at shift 2.0, where the clip binds
    inside chunks of 8 and more, and on the -8 clamp (64 rows span
    e^{-512}: no decay is factored across a tile).  Chunks that do not
    divide 64 (3, 10, 12, 48, 63, as T = 50,000 gives 10) cross the walk's
    8-row windows, whose slots then hold the state at each window's first
    chunk start.

    On the clamp dw is a difference of terms up to e^8 its size (at chunk
    1, dw_t = e^{w_t} <dS'_t, S_t>, less and plus K2 dK2), so f32 cannot
    hold it to 1e-4 of max |dw| there: JAX's own f32 gradient departs from
    an f64 evaluation of the same chunked form by up to 5.2e-4 of it (chunk
    2).  There the five other gradients are held to JAX within 1e-4, and dw
    to the f64 evaluation within twice JAX's own departure (at least
    1e-4).  dLW_end's state term is the dot of the two walks' states:
    telescoped from per-row terms instead (<dS'_{c-1}, S_c> - sum R dR +
    sum K2 dK2), dw lands 7.8e-4 from f64 at chunk 1 against JAX's
    1.2e-4."""
    B, T, H, K = 2, TILE_WALK_T[chunk], 2, 16
    shift = {"model": -0.6, "clip": 2.0, "clamp": 2.0}[case]
    arrs = operands(T + chunk + len(case), B, T, H, K, decay_shift=shift)
    if case == "clamp":
        arrs[3] = np.full_like(arrs[3], -8.0)
    targs = [torch.tensor(a) for a in arrs]
    got = tile_parallel_walk(*targs, chunk)
    assert all(torch.isfinite(g).all() for g in got)
    want = jitted_vjp(arrs, chunk)
    label = f"tile-parallel walk chunk {chunk}"
    if case != "clamp":
        check(got, want, label)
        return
    for name, g, w in zip(NAMES, got, want):
        if name != "dw":
            assert_rel_close(g, w, 1e-4, f"{label} {name}")
    from test_torch_wkv6 import chunked_f64
    f64 = [torch.tensor(a, dtype=torch.float64) for a in arrs]
    leaves = [a.clone().requires_grad_(True) for a in f64[:6]]
    y, S = chunked_f64(*leaves, chunk, torch.matmul)
    dy = f64[6].reshape(B, T // chunk, chunk, H, K).permute(0, 3, 1, 2, 4)
    exact = torch.autograd.grad((y * dy).sum() + (S * f64[7]).sum(),
                                leaves)[3]
    scale = float(exact.abs().max())
    own = float((got[3].double() - exact).abs().max()) / scale
    jax_err = float((torch.tensor(np.asarray(want[3])).double()
                     - exact).abs().max()) / scale
    assert own <= 2 * max(jax_err, 1e-4), (own, jax_err)


@pytest.mark.parametrize("chunk", [64, 16])
def test_bwd_route_by_chunk_and_alignment(chunk):
    """Each backward takes what its forward takes (K == V a multiple of 4,
    16-byte aligned operands) with dy and dS 16-byte aligned: the
    chunk-parallel kernels a chunk of 64 or more (multiples of 64, and 65,
    96 and T = 48,000's 375), the tile-parallel ones a chunk below 64 (the
    1040- and 300-token prompts' chunks 16 and 4, every odd length's 1, and
    T = 50,000's 10, 3, 12, 48 and 63); the per-head kernels the rest
    (other widths, misaligned operands or cotangents), at a chunk of each
    route (``chunk``)."""
    from repro_torch.kernels.rwkv6 import kernel as tk
    r, k, v, w, u, S0, dy, dS = (torch.tensor(a)
                                 for a in operands(7, 1, 256, 2, 32))
    assert tk.bwd_route(r, k, v, w, dy, dS, 256) == "chunk-parallel"
    assert tk.bwd_route(r, k, v, w, dy, None, 64) == "chunk-parallel"
    for c in (16, 4, 32, 1, 2, 8, 128 + 64, 10, 3, 12, 48, 63, 65, 96, 375):
        want = "chunk-parallel" if c >= 64 else "tile-parallel"
        assert tk.bwd_route(r, k, v, w, dy, dS, c) == want, c
    how = tk.bwd_route(r, k, v, w, dy, dS, chunk)
    assert how == ("chunk-parallel" if chunk == 64 else "tile-parallel")
    v28, dy28 = (x[..., :28].contiguous() for x in (v, dy))
    assert tk.bwd_route(r, k, v28, w, dy28, None, chunk) == "per-head"
    r30, k30, v30, w30, dy30 = (x[..., :30].contiguous()
                                for x in (r, k, v, w, dy))
    assert tk.bwd_route(r30, k30, v30, w30, dy30, None, chunk) == "per-head"

    def shifted(x):
        flat = torch.zeros(x.numel() + 1)
        return flat[1:].view(x.shape)
    assert tk.bwd_route(r, k, v, w, shifted(dy), dS, chunk) == "per-head"
    assert tk.bwd_route(r, k, v, w, dy, shifted(dS), chunk) == "per-head"
    assert tk.bwd_route(shifted(r), k, v, w, dy, dS, chunk) == "per-head"
