"""Plain PyTorch versions of the WKV6 kernel.

Counterpart of ``repro.kernels.rwkv6.ref``.  ``reference`` is the exact
per-step recurrence, as in JAX.  ``chunked_reference`` is the model's
chunked form at a given chunk: the function the kernel computes (its
log-decay clamps make the result depend on the chunk), which the kernel
wrapper returns for CPU tensors and ``chip_smoke.py`` holds the CUDA kernel
to on the card.
"""
import torch

from repro_torch.models import rwkv as _rwkv


def reference(r, k, v, w_log, u, S0):
    """r/k/v/w_log: (B,T,H,K); u: (H,K); S0: (B,H,K,V) -> (y, S_final)."""
    return _rwkv.wkv_recurrent(r, k, v, w_log, u, S0)


def chunked_reference(r, k, v, w_log, u, S0, *, chunk):
    """The chunked form at ``chunk`` (``T % chunk == 0``)."""
    return _rwkv.wkv_chunked(r, k, v, w_log, u, S0, chunk=chunk)


def chunked_backward(r, k, v, w_log, u, S0, dy, dS, *, chunk):
    """The gradients (dr, dk, dv, dw_log, du, dS0) of ``chunked_reference``
    at ``chunk`` for the cotangents ``dy`` of y and ``dS`` of the final
    state (None: zeros), in f32, written out chunk by chunk in reverse as
    the backward kernels (``csrc/wkv6_bwd.cu``) compute them.

    Per chunk, with S the state at its start and dS' the cotangent of the
    state at its end:

        dv  = A^T dy + diag dy + K2 dS'     dA = tril_{-1}(dy v^T)
        dQ  = dA Kf,  dKf = dA^T Q,  dR = dy S^T,  dK2 = v dS'^T
        dr  = dQ eQ + dR e^{LWp} + ddiag u k,   ddiag_t = dy_t . v_t
        dk  = dKf eK + dK2 e^{LW_end - LW} + ddiag u r
        dS  = e^{LW_end} dS' + R^T dy       (the previous chunk's dS')

    The log-decay terms: the clips pass the gradient on [-30, 30] and zero
    it outside (autograd of ``torch.clamp``); Z = LW[L / 2] and LW_end =
    LW[L - 1] gather theirs from the whole chunk; and LW = cumsum(w) turns
    dLW into dw by a reversed cumulative sum, less the ``LWp = LW - w``
    term.  du sums the (b, t) terms in a fixed order: per (b, h) over the
    chunks in reverse, then over b.
    """
    B, T, H, K = r.shape
    V = v.shape[-1]
    L = chunk
    if T % L:
        raise ValueError(f"T={T} must be divisible by chunk={L}")
    n = T // L
    f32 = lambda x: x.to(torch.float32)
    resh = lambda x: f32(x).reshape(B, n, L, H, x.shape[-1]).transpose(2, 3)
    r_, k_, v_, w_, dy_ = map(resh, (r, k, v, w_log, dy))    # (B,n,H,L,.)
    uf = f32(u)
    clamp = _rwkv.CLAMP
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    # the states at the chunks' starts, as the forward carries them
    starts, S = [], f32(S0)
    for c in range(n):
        starts.append(S)
        LW = torch.cumsum(w_[:, c], dim=2)
        LWe = LW[:, :, -1]
        K2 = k_[:, c] * torch.exp(LWe[:, :, None] - LW)
        S = (torch.exp(LWe)[..., None] * S
             + torch.einsum("bhlk,bhlv->bhkv", K2, v_[:, c]))
    dS = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
          if dS is None else f32(dS))
    grads = {name: [None] * n for name in ("r", "k", "v", "w")}
    du = torch.zeros((B, H, K), dtype=torch.float32, device=r.device)
    for c in reversed(range(n)):
        rc, kc, vc, wc, dyc = (x[:, c] for x in (r_, k_, v_, w_, dy_))
        S = starts[c]
        LW = torch.cumsum(wc, dim=2)
        LWp = LW - wc
        Z = LW[:, :, L // 2][:, :, None]
        LWe = LW[:, :, -1]
        xq, xk = LWp - Z, Z - LW
        eQ = torch.exp(torch.clamp(xq, -clamp, clamp))
        eK = torch.exp(torch.clamp(xk, -clamp, clamp))
        eP, e2 = torch.exp(LWp), torch.exp(LWe[:, :, None] - LW)
        Q, Kf, R, K2 = rc * eQ, kc * eK, rc * eP, kc * e2
        A = torch.where(tril, torch.einsum("bhlk,bhmk->bhlm", Q, Kf), 0.0)
        dA = torch.where(tril, torch.einsum("bhlv,bhmv->bhlm", dyc, vc), 0.0)
        ddiag = (dyc * vc).sum(-1, keepdim=True)             # (B,H,L,1)
        diag = (rc * uf[None, :, None] * kc).sum(-1, keepdim=True)
        grads["v"][c] = (torch.einsum("bhlm,bhlv->bhmv", A, dyc) + diag * dyc
                         + torch.einsum("bhlk,bhkv->bhlv", K2, dS))
        dQ = torch.einsum("bhlm,bhmk->bhlk", dA, Kf)
        dKf = torch.einsum("bhlm,bhlk->bhmk", dA, Q)
        dR = torch.einsum("bhlv,bhkv->bhlk", dyc, S)
        dK2 = torch.einsum("bhlv,bhkv->bhlk", vc, dS)
        grads["r"][c] = dQ * eQ + dR * eP + ddiag * uf[None, :, None] * kc
        grads["k"][c] = dKf * eK + dK2 * e2 + ddiag * uf[None, :, None] * rc
        du = du + (ddiag * rc * kc).sum(2)
        gQ = torch.where(xq.abs() <= clamp, dQ * Q, 0.0)
        gK = torch.where(xk.abs() <= clamp, dKf * Kf, 0.0)
        dLWp = gQ + dR * R
        dLW = dLWp - gK - dK2 * K2
        dZ = (gK - gQ).sum(2)                                # (B,H,K)
        dLWe = (dK2 * K2).sum(2) + (dS * S).sum(-1) * torch.exp(LWe)
        dLW[:, :, L // 2] += dZ
        dLW[:, :, -1] += dLWe
        grads["w"][c] = torch.flip(torch.cumsum(torch.flip(dLW, (2,)), 2),
                                   (2,)) - dLWp
        dS = (torch.exp(LWe)[..., None] * dS
              + torch.einsum("bhlk,bhlv->bhkv", R, dyc))
    out = [torch.stack(grads[x], dim=1).transpose(2, 3).reshape(B, T, H, -1)
           for x in ("r", "k", "v", "w")]
    return (*out, du.sum(0), dS)
