"""Parity of the port's RM price sweep (``repro_torch.kernels.gnep_sweep``)
with the JAX package.

On the CPU the port's wrappers run their plain PyTorch version; that plain
version is held to the JAX Pallas kernel run as the JAX tests run it
(``interpret=True``).  The JAX kernel computes in f32 whatever it is given,
so the comparison is at f32; the two accumulate each running sum in a
different order (blockwise carries and an in-tile cumsum against
``torch.cumsum`` and a tree sum), and two orders of N terms differ by at
most about 2N rounding units of the sum of the terms' magnitudes, so fill
and sum_fill are held to ``2N + 8`` ULPs of each row's ``sum(inc)`` and
p_fill to as many of its ``sum(inc * p)``.  Solver-level results use 64
ULPs of the allocation scale: prefix sums of <= 24 terms reordered through
a few iterations.  Prices, iteration counts and feasibility match exactly.

The CUDA kernel cannot run here, so its own order of operations (a striped
warp scan, ``chip_smoke.emulated_sweep``, which the kernel matches bit for
bit on the card) is written out in torch and held to the plain version and
the JAX reference within the same gate, and the wrapper's choice between its
16-byte and scalar entry points (``access_width``) is tested directly.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal, assert_ulp_close
from _torch_parity import batch_pair, np_, scenario_pair
from repro.core import game as jg
from repro.kernels.gnep_sweep import kernel as jk
from repro.kernels.gnep_sweep import ops as jops
from repro.kernels.gnep_sweep import ref as jref
from repro_torch.core import game as tg
from repro_torch.kernels.gnep_sweep import kernel as tk
from repro_torch.kernels.gnep_sweep import ops as tops
from repro_torch.kernels.gnep_sweep import ref as tref


def _chip_smoke_module():
    """``chip_smoke.py``, whose phase 1 holds the CUDA kernel bit for bit
    to its ``emulated_sweep`` (importing it runs no phase)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


emulated_sweep = _chip_smoke_module().emulated_sweep


def sweep_inputs(seed, B, Nc, N, dtype=np.float32):
    """A y-patterned increment tensor, p in greedy (descending) order and a
    slack that leaves some rows clipped."""
    rng = np.random.default_rng(seed)
    inc = rng.uniform(0.0, 10.0, (B, Nc, N)) * (rng.uniform(size=(B, Nc, N))
                                                > 0.4)
    p = -np.sort(-rng.uniform(0.1, 100.0, (B, N)), axis=1)
    spare = 0.3 * inc.sum(axis=(1, 2)) / Nc
    return inc.astype(dtype), spare.astype(dtype), p.astype(dtype)


def assert_sweep_close(got, want, inc, p):
    n = inc.shape[-1]
    ulps = 2 * n + 8
    scale = np.abs(inc).sum(-1)
    pscale = np.abs(inc * p[..., None, :]).sum(-1)
    fill, sf, pf = map(np_, got)
    assert_ulp_close(fill, np_(want[0]), ulps=ulps, scale=scale, err_msg="fill")
    assert_ulp_close(sf, np_(want[1]), ulps=ulps, scale=scale,
                     err_msg="sum_fill")
    assert_ulp_close(pf, np_(want[2]), ulps=ulps, scale=pscale,
                     err_msg="p_fill")


@pytest.mark.parametrize("B,Nc,N,bc,bn", [(3, 14, 12, 128, 512),
                                          (2, 26, 24, 8, 8),
                                          (1, 7, 5, 4, 2)])
def test_batched_plain_matches_jax_kernel(B, Nc, N, bc, bn):
    inc, spare, p = sweep_inputs(B * 100 + N, B, Nc, N)
    want = jk.rm_sweep_batched(inc, spare, p, block_c=bc, block_n=bn,
                               interpret=True)
    got = tk.rm_sweep_batched(*map(torch.as_tensor, (inc, spare, p)))
    assert_sweep_close(got, want, inc, p)


@pytest.mark.parametrize("Nc,N", [(14, 12), (3, 1)])
def test_single_plain_matches_jax_kernel(Nc, N):
    inc, spare, p = sweep_inputs(N, 1, Nc, N)
    want = jk.rm_sweep(inc[0], float(spare[0]), p[0], block_c=8, block_n=8,
                       interpret=True)
    got = tk.rm_sweep(torch.as_tensor(inc[0]),
                      torch.as_tensor(spare[0]), torch.as_tensor(p[0]))
    assert_sweep_close(got, want, inc[0], p[0])


def test_plain_matches_jax_reference_f64():
    inc, spare, p = sweep_inputs(7, 4, 22, 20, dtype=np.float64)
    assert_sweep_close(tref.reference_batched(*map(torch.as_tensor,
                                                   (inc, spare, p))),
                       jref.reference_batched(inc, spare, p), inc, p)
    assert_sweep_close(tref.reference(*map(torch.as_tensor,
                                           (inc[0], spare[0], p[0]))),
                       jref.reference(inc[0], spare[0], p[0]), inc[0], p[0])


def test_wrappers_take_the_plain_version_only_on_cpu():
    """CPU tensors: the plain version, bit for bit, and no launch counted.
    Any other device goes to the kernel path, which refuses what is not a
    CUDA tensor instead of falling back."""
    inc, spare, p = map(torch.as_tensor, sweep_inputs(1, 2, 9, 7,
                                                      dtype=np.float64))
    before = (tk.rm_sweep_batched.launches, tk.rm_sweep.launches)
    for got, want in zip(tk.rm_sweep_batched(inc, spare, p),
                         tref.reference_batched(inc, spare, p)):
        assert_bitwise_equal(np_(got), np_(want))
    for got, want in zip(tk.rm_sweep(inc[0], spare[0], p[0]),
                         tref.reference(inc[0], spare[0], p[0])):
        assert_bitwise_equal(np_(got), np_(want))
    assert (tk.rm_sweep_batched.launches, tk.rm_sweep.launches) == before
    meta = [t.to("meta") for t in (inc, spare, p)]
    with pytest.raises(ValueError, match="CUDA"):
        tk.rm_sweep_batched(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        tk.rm_sweep(meta[0][0], meta[1][0], meta[2][0])


def test_sweep_fns_are_memoized_and_named_as_in_jax():
    assert tops.make_sweep_fn() is tops.make_sweep_fn()
    assert tops.make_batched_sweep_fn() is tops.make_batched_sweep_fn()
    assert tops.make_sweep_fn().__name__ == jops.make_sweep_fn().__name__
    assert (tops.make_batched_sweep_fn().__name__
            == jops.make_batched_sweep_fn().__name__)


@pytest.mark.parametrize("with_sweep_fn", [False, True])
def test_rm_solve_matches_jax(with_sweep_fn):
    """rm_solve with and without the sweep plug-in against the JAX RM
    solve on the same instance and bids: the same price, allocations within
    64 ULPs."""
    rng = np.random.default_rng(11)
    sj, st = scenario_pair(rng, 17, capacity_factor=0.9)
    bids = rng.uniform(float(sj.rho_bar), 20.0, 17)
    rho_j, r_j, obj_j = jg.rm_solve(sj, bids)
    kw = {"sweep_fn": tops.make_sweep_fn()} if with_sweep_fn else {}
    rho_t, r_t, obj_t = tg.rm_solve(st, torch.as_tensor(bids), **kw)
    assert float(rho_t) == float(rho_j)
    assert_ulp_close(np_(r_t), np_(r_j), ulps=64, scale=np_(r_j))
    assert_ulp_close(np_(obj_t), np_(obj_j), ulps=64,
                     scale=np.abs(np_(sj.p) * np_(sj.r_up)).sum())


def test_batched_sweep_solve_matches_jax():
    """The sweep configuration of the batched solver against JAX's (its
    plain sweep off the TPU): iterations and feasibility exact."""
    bj, bt = batch_pair(5)
    want = jg.solve_distributed_batch(bj, sweep_fn=jops.make_batched_sweep_fn())
    got = tg.solve_distributed_batch(bt, sweep_fn=tops.make_batched_sweep_fn())
    np.testing.assert_array_equal(np_(got.iters), np_(want.iters))
    np.testing.assert_array_equal(np_(got.feasible), np_(want.feasible))
    for fld in ("r", "psi", "sM", "sR"):
        assert_ulp_close(np_(getattr(got, fld)), np_(getattr(want, fld)),
                         ulps=64, scale=np_(want.r), err_msg=fld)
    assert_bitwise_equal(np_(got.aux), np_(want.aux), label="rho")


# --------------------------------------------------------------------------
# The CUDA kernel's order of operations, and which access it takes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("N", [5, 37, 64, 400, 500, 518])
def test_kernel_order_within_the_reordering_gate(N, dtype):
    """The kernel's summation order (``chip_smoke.emulated_sweep``, which
    the kernel matches bit for bit on the card) against the plain version
    and the JAX reference within the (2N + 8)-ULP gate that
    ``chip_smoke.py`` holds the kernel to.  N = 518 is not a multiple of
    f32's vector of four (scalar access there) and takes two passes of
    f64's 512-value register rows; 5 and 37 are odd (scalar access in both
    types)."""
    inc_np, spare_np, p_np = sweep_inputs(N, 2, 12, N, dtype)
    inc, spare, p = map(torch.as_tensor, (inc_np, spare_np, p_np))
    width = tk.access_width(inc, p)
    assert width == (16 // inc.element_size()
                     if N % (16 // inc.element_size()) == 0 else 1)
    got = emulated_sweep(inc, spare, p, width)
    assert_sweep_close(got, tref.reference_batched(inc, spare, p),
                       inc_np, p_np)
    assert_sweep_close(got, jref.reference_batched(inc_np, spare_np, p_np),
                       inc_np, p_np)


def _offset_view(shape, dtype, offset):
    """A contiguous tensor of ``shape`` that starts ``offset`` elements into
    a 16-byte aligned buffer."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + offset, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset:].view(shape)
    assert view.is_contiguous()
    return view


@pytest.mark.parametrize("N,dtype,inc_offset,p_offset,want", [
    (500, torch.float64, 0, 0, 2),     # the main batched shape
    (400, torch.float64, 0, 0, 2),     # the main single instance
    (500, torch.float32, 0, 0, 4),
    (37, torch.float64, 0, 0, 1),      # the ragged batch: 296-byte rows
    (37, torch.float32, 0, 0, 1),
    (518, torch.float32, 0, 0, 1),     # 2,072-byte rows
    (518, torch.float64, 0, 0, 2),
    (500, torch.float64, 1, 0, 1),     # inc's base 8 bytes off
    (500, torch.float32, 2, 0, 1),
    (500, torch.float32, 4, 0, 4),     # 16 bytes off: still aligned
    (500, torch.float64, 0, 1, 1),     # p's base 8 bytes off
])
def test_access_width_follows_row_alignment(N, dtype, inc_offset, p_offset,
                                            want):
    """The wrapper's choice of the 16-byte or the scalar entry point: a
    16-byte vector only where every row of inc and p starts on a 16-byte
    boundary."""
    inc = _offset_view((2, N + 2, N), dtype, inc_offset)
    p = _offset_view((2, N), dtype, p_offset)
    assert tk.access_width(inc, p) == want

