"""Wrappers of the hand-written CUDA chunked WKV6 (``csrc/wkv6.cu``,
forward; ``csrc/wkv6_bwd.cu``, backward).

Counterpart of ``repro.kernels.rwkv6.kernel``.  Given CPU tensors ``wkv6``
returns the plain chunked version (``ref.chunked_reference``), whose
autograd works; given CUDA tensors it launches the kernel on PyTorch's
current stream or raises.  Under grad, with an operand that requires grad,
it runs ``_WKV6Function``: the forward launches the kernel and saves its
operands; the backward launches the backward kernels (``wkv6_bwd``, counted
in ``wkv6_bwd.launches``) on the cotangents of y and of the final state,
and returns dS0 where S0 requires grad.
Beyond the TPU kernel it takes an optional initial state ``S0`` (zeros by
default, the TPU kernel's function), so that every chunked ``time_mix``
runs through it, a carried state included.  The kernels take float32
operands with K, V <= 64.

Three forward routes (``route``), each launched by state, prefix and
output passes except the last.  With K == V a multiple of 4 and 16-byte
aligned operands, a chunk of 64 or more runs the chunk-parallel kernels (in
parallel over chunks, their products on the tensor cores; a chunk that is
no multiple of 64, as T = 48,000 gives 375, ends in a ragged sub-tile), and
a chunk below 64 the tile-parallel ones: the chunk-parallel state and
prefix passes over tiles of m = chunk * (64 // chunk) rows, whole chunks
(64 where the chunk divides 64, as every RWKV6 prompt whose length is not
a multiple of 64 gives; 60 at T = 50,000's chunk 10; the last tile may be
ragged), whose carries compose the chunks', then an output pass that walks
each tile's chunks from the tile's state.  Any other call (other widths,
misaligned operands) runs the per-head kernel.  ``wkv6.launches`` counts
wrapper calls that launched, one per call whatever the route, and
``wkv6.route_launches`` the same by route.  ``route_launcher`` runs a call
on a route of one's choosing, to hold two routes to each other at one
shape.

The backward takes the forward's route (``bwd_route``) wherever dy (and
dS) are 16-byte aligned too, at every chunk, else the per-head one.
Chunk-parallel: four kernels on the tensor cores (G, reverse prefix, main
and fix-up passes) from the forward's chunk-start states, over 64-row
sub-tiles, the last ragged where the chunk is no multiple of 64 (375: 55
rows).  Tile-parallel: the G and reverse-prefix passes over the forward's
tiles of m rows, a block a tile that walks its chunks forward and back (dR,
dK2 and each chunk's e^{LW_end} <dS', S>, the state at the first chunk
start of each 8-row window kept on chip), a block a tile for the rest (dv's
state term, the chunks' own products on the tensor cores, the elementwise
terms), and du's sum over the tiles.  Both start from the forward's
scratch, which ``_WKV6Function`` keeps for its backward (the tile-parallel
route's: each tile's start state and decay, (B, H, ceil(T / m), K, K),
about 34 MB a layer at (2, 1040, 64, 64)); a call without it relaunches the
forward's state and prefix passes.  Any other call (other widths,
misaligned operands or cotangents) runs the two per-head kernels of the
first port, which recompute the states themselves; they are also the route
the others are held to on the card.  ``wkv6_bwd.launches`` counts wrapper
calls, one per call whatever the route, and ``wkv6_bwd.route_launches``
the same by route; ``bwd_route_launcher`` runs a backward on a route of
one's choosing.

Each launch is a dispatcher operator (``torch.ops.repro_torch.wkv6`` and
``wkv6_bwd``) with a CUDA implementation, which launches, and a Meta one,
which returns empty tensors of what the call's route returns (the
forward's chunk-start states included) and launches nothing: a meta
tensor takes the card's route, and the dry run
(``repro_torch.launch.dryrun``) counts the operations ``wkv_ops`` /
``wkv_bwd_ops`` (the operators' FLOP formulas) and the operands and
results.  A meta tensor has no address, so it counts as aligned.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6 import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"wkv6_f32": [_P] * 8 + [_I] * 6 + [_P],
               "wkv6_chunked_f32": [_P] * 12 + [_I] * 6 + [_P],
               "wkv6_tiled_f32": [_P] * 10 + [_I] * 6 + [_P]}
_BWD_SIGNATURES = {"wkv6_bwd_f32": [_P] * 15 + [_I] * 6 + [_P],
                   "wkv6_bwd_chunked_f32": [_P] * 22 + [_I] * 6 + [_P],
                   "wkv6_bwd_tiled_f32": [_P] * 17 + [_I] * 6 + [_P]}
_MAX_KV = 64
_SUB = 64        # rows of the chunk-parallel route's sub-tile, and the
#                  most of the tile-parallel route's tile
ROUTES = ("chunk-parallel", "tile-parallel", "per-head")
PASSES = {"state": 1, "prefix": 2, "output": 4}
# the tile-parallel backward's "walk" pass (dR, dK2 and each chunk's
# e^{LW_end} <dS', S>) runs between its prefix and main passes; its "fixup"
# sums du
BWD_PASSES = {"g": 1, "prefix": 2, "walk": 16, "main": 4, "fixup": 8}


def wkv_ops(B, T, H, K, L) -> int:
    """Operations of the chunked form at chunk L: the strictly lower
    intra-chunk product and its product with v, the inter-chunk product and
    the state update (2 per multiply-add), and about 12 per (row, channel)
    for the decay cumsum, the four exponentials and their products."""
    pairs = L * (L - 1) // 2
    per_chunk = 2 * (pairs * K + pairs * K + 2 * L * K * K + K * K) \
        + 12 * L * K
    return B * H * (T // L) * per_chunk


def wkv_bwd_ops(B, T, H, K, L) -> int:
    """Operations of the backward at chunk L: per chunk, five strictly
    lower intra-chunk products (A, dA, dQ, dKf, A^T dy) and five of the
    chunk's rows with the state (dR, dK2, K2 dS', R^T dy and the forward
    sweep's K2^T v), 2 per multiply-add, and about 30 per (row, channel)
    for the exponentials and the elementwise terms."""
    pairs = L * (L - 1) // 2
    per_chunk = 2 * (5 * pairs * K + 5 * L * K * K) + 30 * L * K
    return B * H * (T // L) * per_chunk


def route(r, k, v, w_log, chunk) -> str:
    """One of ``ROUTES``: the kernels a call with these operands and this
    chunk runs on the card."""
    K, V = r.shape[-1], v.shape[-1]
    if (K == V and K % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in (r, k, v, w_log))):
        return "chunk-parallel" if chunk >= _SUB else "tile-parallel"
    return "per-head"


def tile_rows(chunk) -> int:
    """Rows of the tile-parallel route's tile at a chunk below 64: the
    whole chunks that fit in 64 rows (64 where the chunk divides 64)."""
    return chunk * (_SUB // chunk)


def bwd_route(r, k, v, w_log, dy, dS, chunk) -> str:
    """One of ``ROUTES``: the backward kernels a call with these operands,
    cotangents (``dS`` None: zeros) and chunk runs on the card: the
    forward's route where dy and dS are 16-byte aligned, else per-head."""
    how = route(r, k, v, w_log, chunk)
    if how != "per-head" and all(t.data_ptr() % 16 == 0 for t in (dy, dS)
                                 if t is not None):
        return how
    return "per-head"


def _check(r, k, v, w_log, u, S0):
    what = "wkv6"
    B, T, H, K = r.shape
    V = v.shape[-1]
    args = (r, k, v, w_log, u) + (() if S0 is None else (S0,))
    # a meta tensor is the dry run's stand-in for the card
    if not all(t.device.type in ("cuda", "meta") and t.device == r.device
               for t in args):
        raise ValueError(f"{what}: operands must all be CPU tensors (plain "
                         "version) or all on one CUDA device (kernel), got "
                         f"{[str(t.device) for t in args]}")
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError(f"{what}: the kernel takes float32 operands, got "
                        f"{[t.dtype for t in args]}")
    if (k.shape != r.shape or w_log.shape != r.shape
            or v.shape[:3] != (B, T, H) or u.shape != (H, K)
            or (S0 is not None and S0.shape != (B, H, K, V))):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in args]} "
                         "do not agree with (B,T,H,K) x3, (B,T,H,V), (H,K), "
                         "(B,H,K,V)")
    if not (1 <= K <= _MAX_KV and 1 <= V <= _MAX_KV):
        raise ValueError(f"{what}: the kernel takes K, V <= {_MAX_KV}, got "
                         f"K={K} V={V}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{what}: operands must be contiguous")


def _scratch(r, chunk, how="chunk-parallel"):
    """The chunk- or tile-parallel forward's scratch, which its backward
    reuses."""
    B, T, H, K = r.shape
    f32 = dict(dtype=torch.float32, device=r.device)
    if how == "tile-parallel":
        n = -(-T // tile_rows(chunk))
        return (torch.empty((B, H, n, K, K), **f32),         # U, then S_tile
                torch.empty((B, H, n, K), **f32))            # e^{LW_end}
    n, nsub = T // chunk, -(-chunk // _SUB)
    return (torch.empty((B, H, n, K, K), **f32),             # U, then S_c
            torch.empty((B, H, n, nsub, K), **f32),          # carries
            torch.empty((B, H, n, K), **f32),                # Z
            torch.empty((B, H, n, K), **f32))                # e^{LW_end}


def _launcher(r, k, v, w_log, u, S0, chunk, how=None):
    """(y, S, lib, launch, scratch): ``launch(passes)`` runs the kernels of
    route ``how`` (the call's own by default) into y and S and returns the C
    entry's error code; ``passes`` (a mask of ``PASSES``) picks kernels of
    the chunk- and tile-parallel routes.  ``scratch`` is the chunk-parallel
    route's (the chunk-start states S_c, the carries, Z and e^{LW_end}) or
    the tile-parallel route's (the tile-start states and e^{LW_end} of
    each tile), which the backward reads; None on the per-head route."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    y = torch.empty_like(v)
    S = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    lib = _build.load("wkv6", _SIGNATURES)
    ptrs = [t.data_ptr() for t in (r, k, v, w_log, u)] + [
        None if S0 is None else S0.data_ptr(), y.data_ptr(), S.data_ptr()]
    # the stream current at each launch, so that a CUDA graph captures it
    stream = lambda: _build.stream_of(r)
    how = how or route(r, k, v, w_log, chunk)
    if how == "per-head":
        def launch(passes=7):
            return lib.wkv6_f32(*ptrs, B, T, H, K, V, chunk, stream())
        return y, S, lib, launch, None
    if how == "tile-parallel":
        # held by ``launch`` itself, not only by their addresses
        tiles = _scratch(r, chunk, how)

        def launch(passes=7):
            return lib.wkv6_tiled_f32(*ptrs, *(t.data_ptr() for t in tiles),
                                      B, T, H, K, chunk, passes, stream())
        return y, S, lib, launch, tiles
    scratch = _scratch(r, chunk)
    scratch_ptrs = [t.data_ptr() for t in scratch]

    def launch(passes=7):
        return lib.wkv6_chunked_f32(*ptrs, *scratch_ptrs, B, T, H, K, chunk,
                                    passes, stream())
    return y, S, lib, launch, scratch


def _forward(r, k, v, w_log, u, S0, chunk):
    """(y, S, scratch): the forward kernels' outputs and the chunk- or
    tile-parallel route's scratch (None on the per-head route)."""
    how = route(r, k, v, w_log, chunk)
    y, S, lib, launch, scratch = _launcher(r, k, v, w_log, u, S0, chunk, how)
    _build.check(lib, launch(), "wkv6")
    wkv6.launches += 1
    wkv6.route_launches[how] += 1
    return y, S, scratch


def _bwd_check(r, k, v, w_log, u, S0, dy, dS, chunk):
    what = "wkv6_bwd"
    _check(r, k, v, w_log, u, S0)
    B, T, H, K = r.shape
    V = v.shape[-1]
    if T % chunk:
        raise ValueError(f"T={T} must be divisible by chunk={chunk}")
    for name, t, shape in (("dy", dy, v.shape), ("dS", dS, (B, H, K, V))):
        if t is not None and (t.device != r.device or t.dtype != torch.float32
                              or tuple(t.shape) != tuple(shape)
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"tensor of shape {tuple(shape)} on {r.device}")


def _bwd_grads(r, v, S0):
    """The backward's outputs: dr, dk, dv, dw_log, du's (batch, head)
    partials (B, H, K) and dS0 (None where S0 is None)."""
    B, T, H, K = r.shape
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    dS0 = (None if S0 is None
           else torch.empty((B, H, K, v.shape[-1]), **f32))
    return dr, dk, torch.empty_like(v), dw, torch.empty((B, H, K), **f32), \
        dS0


def _bwd_launcher(r, k, v, w_log, u, S0, dy, dS, chunk, saved, how=None):
    """(grads, lib, launch): ``launch(passes)`` runs the backward kernels
    of route ``how`` (the call's own by default) into ``grads`` (dr, dk,
    dv, dw_log, du's (batch, head) partials, dS0) and returns the C entry's
    error code; ``passes`` (a mask of ``BWD_PASSES``) picks kernels of the
    chunk- and tile-parallel routes, which start from the forward's scratch
    ``saved`` and, where it is None, first relaunch the forward's state and
    prefix passes."""
    what = "wkv6_bwd"
    B, T, H, K = r.shape
    V = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=r.device)
    grads = _bwd_grads(r, v, S0)
    dr, dk, dv, dw, du, dS0 = grads
    lib = _build.load(what, _BWD_SIGNATURES)
    ptr = lambda t: None if t is None else t.data_ptr()
    # the stream current at each launch, so that a CUDA graph captures it
    stream = lambda: _build.stream_of(r)
    n = T // chunk
    how = how or bwd_route(r, k, v, w_log, dy, dS, chunk)
    if how == "per-head":
        scratch = torch.empty((B, H, n, K, V), **f32)       # chunk starts

        def launch(passes=15):
            return lib.wkv6_bwd_f32(*(ptr(t) for t in (
                r, k, v, w_log, u, S0, dy, dS, scratch, dr, dk, dv, dw, du,
                dS0)), B, T, H, K, V, chunk, stream())
        return grads, lib, launch
    if saved is None:
        _, _, flib, flaunch, saved = _launcher(r, k, v, w_log, u, S0, chunk,
                                               how)
        _build.check(flib, flaunch(PASSES["state"] | PASSES["prefix"]),
                     what)
    if how == "tile-parallel":
        nt = -(-T // tile_rows(chunk))
        own = (torch.empty((B, H, nt, K, K), **f32),         # G, then dS'
               torch.empty((B, H, nt, K), **f32))            # du by tile

        def launch(passes=31):
            return lib.wkv6_bwd_tiled_f32(*(ptr(t) for t in (
                r, k, v, w_log, u, dy, dS, *saved, *own, dr, dk, dv, dw, du,
                dS0)), B, T, H, K, chunk, passes, stream())
        return grads, lib, launch
    nsub = -(-chunk // _SUB)
    own = (torch.empty((B, H, n, K, K), **f32),              # G, then dS'
           torch.empty((B, H, n, nsub, K), **f32),           # LW's carries,
           torch.empty((B, H, n, K), **f32),                 # Z and LW_end
           torch.empty((B, H, n, K), **f32),                 # as cumsum's
           torch.empty((B, H, n, nsub, 4, K), **f32))        # totals

    def launch(passes=15):
        return lib.wkv6_bwd_chunked_f32(*(ptr(t) for t in (
            r, k, v, w_log, u, dy, dS, *saved, *own, dr, dk, dv, dw, du,
            dS0)), B, T, H, K, chunk, passes, stream())
    return grads, lib, launch


def wkv6_bwd(r, k, v, w_log, u, S0, dy, dS, *, chunk, saved=None):
    """(dr, dk, dv, dw_log, du, dS0) of ``wkv6`` at ``chunk`` for the
    cotangents ``dy`` of y and ``dS`` of the final state (None: zeros):
    the backward kernels on CUDA tensors, counted in ``wkv6_bwd.launches``.
    S0 None is the zero state, and then dS0 is None.  ``saved`` is the
    forward's chunk- or tile-parallel scratch (``_forward``'s third output),
    which spares those routes their recomputation of the states."""
    _bwd_check(r, k, v, w_log, u, S0, dy, dS, chunk)
    grads = torch.ops.repro_torch.wkv6_bwd(r, k, v, w_log, u, S0, dy, dS,
                                           chunk, list(saved or ()))
    return _summed(grads, S0)


def _summed(grads, S0):
    """The backward's outputs with du's batch partials added in order."""
    dr, dk, dv, dw, du = grads[:5]
    dS0 = grads[5] if S0 is not None else None
    du_sum = du[0]
    for i in range(1, du.shape[0]):
        du_sum = du_sum + du[i]
    return dr, dk, dv, dw, du_sum, dS0


def _fwd_cuda(r, k, v, w_log, u, S0, chunk):
    """The forward operator's CUDA implementation: y, S and the chunk- or
    tile-parallel route's scratch (empty on the per-head route)."""
    y, S, scratch = _forward(r, k, v, w_log, u, S0, chunk)
    return y, S, list(scratch or ())


def _fwd_meta(r, k, v, w_log, u, S0, chunk):
    B, T, H, K = r.shape
    S = torch.empty((B, H, K, v.shape[-1]), dtype=torch.float32,
                    device=r.device)
    how = route(r, k, v, w_log, chunk)
    scratch = _scratch(r, chunk, how) if how != "per-head" else ()
    return torch.empty_like(v), S, list(scratch)


def _bwd_cuda(r, k, v, w_log, u, S0, dy, dS, chunk, saved):
    """The backward operator's CUDA implementation: [dr, dk, dv, dw_log,
    du's partials] and dS0 where S0 is given."""
    how = bwd_route(r, k, v, w_log, dy, dS, chunk)
    grads, lib, launch = _bwd_launcher(r, k, v, w_log, u, S0, dy, dS, chunk,
                                       saved or None, how)
    _build.check(lib, launch(), "wkv6_bwd")
    wkv6_bwd.launches += 1
    wkv6_bwd.route_launches[how] += 1
    return [g for g in grads if g is not None]


def _bwd_meta(r, k, v, w_log, u, S0, dy, dS, chunk, saved):
    return [g for g in _bwd_grads(r, v, S0) if g is not None]


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("wkv6(Tensor r, Tensor k, Tensor v, Tensor w_log, Tensor u, "
            "Tensor? S0, int chunk) -> (Tensor, Tensor, Tensor[])")
_LIB.define("wkv6_bwd(Tensor r, Tensor k, Tensor v, Tensor w_log, Tensor u, "
            "Tensor? S0, Tensor dy, Tensor? dS, int chunk, Tensor[] saved) "
            "-> Tensor[]")
_LIB.impl("wkv6", _fwd_cuda, "CUDA")
_LIB.impl("wkv6", _fwd_meta, "Meta")
_LIB.impl("wkv6_bwd", _bwd_cuda, "CUDA")
_LIB.impl("wkv6_bwd", _bwd_meta, "Meta")


@register_flop_formula(torch.ops.repro_torch.wkv6)
def _fwd_flops(r_shape, k_shape, v_shape, w_shape, u_shape, S0_shape, chunk,
               *args, out_shape=None, **kwargs):
    B, T, H, K = r_shape
    return wkv_ops(B, T, H, K, chunk)


@register_flop_formula(torch.ops.repro_torch.wkv6_bwd)
def _bwd_flops(r_shape, k_shape, v_shape, w_shape, u_shape, S0_shape,
               dy_shape, dS_shape, chunk, *args, out_shape=None, **kwargs):
    B, T, H, K = r_shape
    return wkv_bwd_ops(B, T, H, K, chunk)


class _WKV6Function(torch.autograd.Function):
    """The forward kernels; the backward kernels."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, S0, chunk):
        y, S, scratch = torch.ops.repro_torch.wkv6(r, k, v, w_log, u, S0,
                                                   chunk)
        # the chunk- or tile-parallel route's scratch, for its backward
        # (empty on the per-head route, whose backward recomputes its
        # states)
        ctx.save_for_backward(r, k, v, w_log, u, S0, *scratch)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        r, k, v, w_log, u, S0, *saved = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(v)
        grads = wkv6_bwd(r, k, v, w_log, u, S0, dy.contiguous(),
                         None if dS is None else dS.contiguous(),
                         chunk=ctx.chunk, saved=saved or None)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def wkv6(r, k, v, w_log, u, *, chunk=64, S0=None):
    """r/k/w_log: (B,T,H,K); v: (B,T,H,V); u: (H,K); S0: (B,H,K,V) or None.

    Returns (y (B,T,H,V) in r's dtype, S (B,H,K,V) float32).
    """
    B, T, H, K = r.shape
    V = v.shape[-1]
    if T % chunk:
        raise ValueError(f"T={T} must be divisible by chunk={chunk}")
    if r.device.type == "cpu":
        if S0 is None:
            S0 = torch.zeros((B, H, K, V), dtype=torch.float32)
        return ref.chunked_reference(r, k, v, w_log, u, S0, chunk=chunk)
    _check(r, k, v, w_log, u, S0)
    args = (r, k, v, w_log, u, S0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        return _WKV6Function.apply(*args, chunk)
    return tuple(torch.ops.repro_torch.wkv6(*args, chunk)[:2])


wkv6.launches = 0
wkv6.route_launches = dict.fromkeys(ROUTES, 0)
wkv6_bwd.launches = 0
wkv6_bwd.route_launches = dict.fromkeys(ROUTES, 0)


def pass_launchers(r, k, v, w_log, u, *, chunk, S0=None) -> dict:
    """Pass name -> a callable that launches that kernel of the chunk- or
    tile-parallel route alone on this call's buffers, to time it (it counts
    no launch; the prefix pass rewrites its scratch in place, so only the
    first full call's values mean anything)."""
    _check(r, k, v, w_log, u, S0)
    if route(r, k, v, w_log, chunk) == "per-head":
        raise ValueError("wkv6: the per-head route has one kernel")
    _, _, lib, launch, _ = _launcher(r, k, v, w_log, u, S0, chunk)
    return {name: (lambda bit=bit: _build.check(lib, launch(bit), "wkv6"))
            for name, bit in PASSES.items()}


def route_launcher(r, k, v, w_log, u, *, chunk, how, S0=None):
    """A callable that runs this call's kernels on route ``how`` (one of
    ``ROUTES`` that takes the call: the per-head route takes any chunk
    that divides T) into buffers of its own and returns (y, S); it counts
    no launch.  It holds a route to another, or times it, at one shape."""
    _check(r, k, v, w_log, u, S0)
    if r.shape[1] % chunk:
        raise ValueError(f"T={r.shape[1]} must be divisible by chunk={chunk}")
    if how != "per-head" and how != route(r, k, v, w_log, chunk):
        raise ValueError(f"wkv6: chunk {chunk} does not take the {how} route")
    y, S, lib, launch, _ = _launcher(r, k, v, w_log, u, S0, chunk, how)

    def run():
        _build.check(lib, launch(), "wkv6")
        return y, S
    return run


def bwd_pass_launchers(r, k, v, w_log, u, dy, dS=None, *, chunk,
                       S0=None) -> dict:
    """Pass name -> a callable that launches that kernel of the chunk- or
    tile-parallel backward alone on this call's buffers, to time it, after
    the forward's state and prefix passes once (it counts no launch; the
    prefix pass rewrites its scratch in place, so only the first full call's
    values mean anything)."""
    _bwd_check(r, k, v, w_log, u, S0, dy, dS, chunk)
    how = bwd_route(r, k, v, w_log, dy, dS, chunk)
    if how == "per-head":
        raise ValueError("wkv6_bwd: the per-head route is timed whole")
    _, lib, launch = _bwd_launcher(r, k, v, w_log, u, S0, dy, dS, chunk,
                                   None)
    return {name: (lambda bit=bit: _build.check(lib, launch(bit),
                                                "wkv6_bwd"))
            for name, bit in BWD_PASSES.items()
            if name != "walk" or how == "tile-parallel"}


def bwd_route_launcher(r, k, v, w_log, u, dy, dS=None, *, chunk, how,
                       S0=None):
    """A callable that runs this call's backward on route ``how`` (one of
    ``ROUTES`` that takes the call: the per-head route takes any chunk that
    divides T), from the states it recomputes, into buffers of its own and
    returns (dr, dk, dv, dw_log, du, dS0); it counts no launch.  It holds
    a route to another, or times it, at one shape."""
    _bwd_check(r, k, v, w_log, u, S0, dy, dS, chunk)
    if how != "per-head" and how != bwd_route(r, k, v, w_log, dy, dS, chunk):
        raise ValueError(f"wkv6_bwd: chunk {chunk} does not take the {how} "
                         "route")
    grads, lib, launch = _bwd_launcher(r, k, v, w_log, u, S0, dy, dS, chunk,
                                       None, how)

    def run():
        _build.check(lib, launch(), "wkv6_bwd")
        return _summed(grads, S0)
    return run
