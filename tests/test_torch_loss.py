"""Parity of the port's training loss (``repro_torch.models.transformer.
loss_fn``) and its gradients with JAX's ``jax.value_and_grad(loss_fn)``,
the prefill kernels' autograd wrappers off the CPU, and activation
rematerialisation.

Both packages run the reduced f32 configurations on the same weights and
numpy-seeded batches (``_torch_lm``).  The loss is held within 1e-5
relative: the same f32 formulas with sums in another order.  Every
gradient leaf, restacked into JAX's layout by
``convert.lm_params_to_numpy``, is held within 1e-4 of the leaf's largest
|g|: the backward of two to three layers of f32 sums (measured at most
1.3e-5, Jamba's ``A_log``).  The MoE families are in
``test_torch_loss_moe.py`` (their JAX gradients take longest).
"""
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_lm import MOE_ARCHS, check_loss_and_grads, lm_batch
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.rwkv6 import kernel as wkv
from repro_torch.launch.steps import make_grad_step
from repro_torch.models import LOCAL
from repro_torch.models import transformer as tt
from repro_torch.utils import tree_leaves

DENSE_ARCHS = tuple(a for a in ARCH_IDS if a not in MOE_ARCHS)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """The loss (with a loss_mask, 8 chunks) and every gradient leaf."""
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-base"])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("chunks", [1, 8])
def test_loss_mask_and_chunks_match_jax(arch, mask, chunks):
    """With and without loss_mask, in one chunk and in eight (Qwen3-0.6B
    ties its embeddings, so its embedding gradient sums both uses)."""
    check_loss_and_grads(arch, mask=mask, seed=3, loss_chunks=chunks)


def test_loss_chunks_do_not_change_the_port_loss():
    """gcd(S, loss_chunks) chunks: 1, 4 (gcd(36, 8)) and 36 chunks give the
    same loss within f32 rounding of the chunked sums."""
    cfg = t_reduced("qwen3-0.6b")
    params = tt.init_params(cfg, 0, device="cpu")
    _, tb = lm_batch(cfg, 5, 2, 36, mask=True)
    with torch.no_grad():
        losses = [float(tt.loss_fn(cfg.replace(loss_chunks=c), params,
                                   tb)[0]) for c in (1, 8, 36)]
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)
    assert losses[2] == pytest.approx(losses[0], rel=1e-6)


# --------------------------------------------------------------------------
# rematerialisation
# --------------------------------------------------------------------------

@pytest.fixture
def deterministic():
    """CPU autograd's index backward adds repeated rows with parallel
    atomics, so the MoE families' gradients vary in their last bits from
    run to run, with or without remat; deterministic algorithms order
    them."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


class _LiveStorages(TorchDispatchMode):
    """Weak references to the storage of every floating output of every
    operation run under the mode, with the operation that made it."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out if isinstance(out, (tuple, list))
                             else [out]):
            if t.is_floating_point():
                self.refs.append((weakref.ref(t.untyped_storage()),
                                  func.overloadpacket))
        return out

    def alive(self):
        """{storage id: the op that first made it} for storages still held
        (by autograd's saved tensors or a checkpoint's cache)."""
        gc.collect()
        first = {}
        for ref, op in self.refs:
            st = ref()
            if st is not None:
                first.setdefault(id(st), op)
        return first


PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.bmm)


def remat_run(arch, remat):
    """(loss, gradients, tensors packed by autograd, storages held after
    the forward: all, and those made by a matrix product) of the port at
    ``remat``."""
    cfg = t_reduced(arch).replace(remat=remat)
    params = tt.init_params(cfg, 0, device="cpu")
    _, tb = lm_batch(cfg, 1, 2, 32, mask=True)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    packed = [0]

    def pack(t):
        packed[0] += 1
        return t

    mode = _LiveStorages()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), mode:
        loss, _ = tt.loss_fn(cfg, params, tb)
    alive = mode.alive()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    products = sum(op in PRODUCTS for op in alive.values())
    return loss.detach(), grads, packed[0], len(alive), products


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_changes_memory_not_values(arch, deterministic):
    """remat none / dots / full: the loss and every gradient bit for bit.

    What the forward leaves for the backward: a pack hook of
    ``saved_tensors_hooks`` sees what autograd saves outside a
    checkpoint (inside one, the checkpoint's own hooks take the tensors),
    so it counts more under ``none`` than under ``dots`` or ``full``.
    Storages still held after the forward count what is kept in all:
    ``none`` > ``dots`` > ``full``, ``dots`` keeps exactly ``full``'s plus
    the outputs of the blocks' matrix products, and ``full`` keeps no
    product of a block."""
    runs = {r: remat_run(arch, r) for r in ("none", "dots", "full")}
    loss0, grads0 = runs["none"][:2]
    for remat in ("dots", "full"):
        loss, grads = runs[remat][:2]
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), remat
    packed = {r: v[2] for r, v in runs.items()}
    held = {r: v[3] for r, v in runs.items()}
    products = {r: v[4] for r, v in runs.items()}
    assert packed["none"] > packed["dots"] == packed["full"], packed
    assert held["none"] > held["dots"] > held["full"], held
    head = t_reduced(arch).moe.first_k_dense if t_reduced(arch).moe else 0
    if not head:      # the MoE head layers run unwrapped, as in JAX
        assert products["full"] == 0
    assert (held["dots"] - held["full"]
            == products["dots"] - products["full"] > 0), (held, products)


def test_a_depth_cut_inside_a_block():
    """Jamba cut to 5 of its 8-layer super-block (as the card's f32 check
    serves it) runs the 5 layers as one shorter block: its logits under no
    grad are the uncut model's first 5 layers', bit for bit, whatever
    ``remat``, and its loss and gradients do not depend on ``remat``."""
    cfg = t_reduced("jamba-v0.1-52b").replace(n_layers=5)
    full = t_reduced("jamba-v0.1-52b")
    params = tt.init_params(full, 0, device="cpu")
    cut = {**params, "layers": params["layers"][:5]}
    _, tb = lm_batch(cfg, 1, 2, 32)
    with torch.no_grad():
        want = tt.forward(cfg.replace(remat="none"), cut, tb)[0]
        for remat in ("full", "dots"):
            got = tt.forward(cfg.replace(remat=remat), cut, tb)[0]
            assert torch.equal(got, want), remat
    runs = [make_grad_step(cfg.replace(remat=r), LOCAL)(cut, tb)
            for r in ("none", "full")]
    assert torch.equal(runs[0][1], runs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][0]),
                                                 tree_leaves(runs[1][0])))


def test_dots_policy_saves_every_product_overload():
    """The selective policy matches the products by packet: the card's
    ``out_dtype`` overloads (``mm.dtype``, ``bmm.dtype``) and the CPU's
    plain ones are saved, everything else recomputed."""
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    ops = torch.ops.aten
    for op in (ops.mm.dtype, ops.mm.default, ops.bmm.dtype, ops.bmm.default,
               ops.addmm.default, ops.baddbmm.default):
        assert tt._save_products(None, op) == save, op
    for op in (ops.add.Tensor, ops.exp.default, ops.mul.Tensor):
        assert tt._save_products(None, op) != save, op


def test_remat_is_inert_without_grad():
    """Under no_grad the wrapped blocks run as they are: a prefill's caches
    and logits are bit for bit ``remat="none"``'s."""
    outs = []
    for remat in ("none", "full", "dots"):
        cfg = t_reduced("whisper-base").replace(remat=remat)
        params = tt.init_params(cfg, 0, device="cpu")
        _, tb = lm_batch(cfg, 2, 2, 8)
        with torch.no_grad():
            outs.append(tt.prefill(cfg, params, tb))
    for logits, caches in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(caches), tree_leaves(outs[0][1])))


# --------------------------------------------------------------------------
# the prefill kernels' autograd wrappers
# --------------------------------------------------------------------------

def test_kernel_wrappers_refuse_grad_before_anything():
    """Operands off the CPU that require grad, under grad, reach each
    wrapper's device check, which rejects operands on two devices (a meta
    one, the dry run's stand-in for the card, beside CPU ones) before the
    autograd Function, the build and the launch; all-meta operands run the
    kernels' operators forward and backward without a launch.  No forward
    or backward counter moves.  ``pass_launchers`` stays a timing helper
    with the same check."""
    meta = dict(device="meta", dtype=torch.float32)
    q = torch.empty((1, 8, 2, 32), **meta, requires_grad=True)
    k = torch.empty((1, 8, 2, 32), dtype=torch.float32)
    counters = (flash.flash_attention, flash.flash_attention_bwd,
                wkv.wkv6, wkv.wkv6_bwd)
    n = [fn.launches for fn in counters]
    with pytest.raises(ValueError, match="CUDA device"):
        flash.flash_attention(q, k, k)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        flash.flash_attention(q, k, k)
    r = torch.empty((1, 8, 2, 16), **meta)
    u = torch.empty((2, 16), dtype=torch.float32, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA device"):
        wkv.wkv6(r, r, r, r, u, chunk=4)
    with pytest.raises(ValueError, match="CUDA device"):
        wkv.pass_launchers(r, r, r, r, u, chunk=4)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        wkv.wkv6(r, r, r, r, u, chunk=4)
    km = k.to("meta")
    assert torch.autograd.grad(flash.flash_attention(q, km, km).sum(),
                               q)[0].is_meta
    um = u.detach().to("meta").requires_grad_(True)
    assert torch.autograd.grad(wkv.wkv6(r, r, r, r, um, chunk=4)[0].sum(),
                               um)[0].is_meta
    assert [fn.launches for fn in counters] == n


def test_cpu_operands_keep_the_plain_versions_autograd():
    """On the CPU the wrappers return the plain versions, whose gradients
    flow as before (here against autograd of the plain functions
    themselves), and count no launch."""
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rwkv6 import ref as wref
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 8, 2, 32)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    n = flash.flash_attention.launches
    got = torch.autograd.grad(flash.flash_attention(q, k, v).sum(), (q, k, v))
    want = torch.autograd.grad(fref.reference(q, k, v, causal=True).sum(),
                               (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash.flash_attention.launches == n
    r, kk, vv = (torch.tensor(rng.standard_normal((1, 8, 2, 16)) * 0.5,
                              dtype=torch.float32, requires_grad=True)
                 for _ in range(3))
    w = torch.tensor(-rng.random((1, 8, 2, 16)), dtype=torch.float32,
                     requires_grad=True)
    u = torch.tensor(rng.standard_normal((2, 16)), dtype=torch.float32,
                     requires_grad=True)
    n = wkv.wkv6.launches
    y, _ = wkv.wkv6(r, kk, vv, w, u, chunk=4)
    got = torch.autograd.grad(y.sum(), (r, kk, vv, w, u))
    y2, _ = wref.chunked_reference(r, kk, vv, w, u,
                                   torch.zeros((1, 2, 16, 16)), chunk=4)
    want = torch.autograd.grad(y2.sum(), (r, kk, vv, w, u))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert wkv.wkv6.launches == n


# --------------------------------------------------------------------------
# layers.dot / layers.bmm under autograd on the card's branch
# --------------------------------------------------------------------------

def _f32_stand_in(op):
    """The card's ``op(a, b, out_dtype=float32)`` as the CPU computes it:
    both operands cast to f32 (the overload has no CPU kernel)."""
    def run(a, b, out_dtype=None):
        return op(a.float(), b.float())
    return run


@pytest.mark.parametrize("op", [torch.mm, torch.bmm])
def test_f32_product_backward_is_the_f32_products(op):
    """``_F32Product``'s backward: f32 products of the f32 cotangent and
    the other operand, in the operands' dtype.  With the forward's
    ``out_dtype`` product stood in for by f32 casts, the gradients equal
    autograd of the f32 product rounded to bf16, bit for bit."""
    from repro_torch.models import layers
    rng = np.random.default_rng(1)
    lead = () if op is torch.mm else (3,)
    a = torch.tensor(rng.standard_normal((*lead, 24, 40)),
                     dtype=torch.bfloat16, requires_grad=True)
    b = torch.tensor(rng.standard_normal((*lead, 40, 16)),
                     dtype=torch.bfloat16, requires_grad=True)
    g = torch.tensor(rng.standard_normal((*lead, 24, 16)),
                     dtype=torch.float32)
    out = layers._F32Product.apply(a, b, _f32_stand_in(op))
    da, db = torch.autograd.grad(out, (a, b), g)
    af, bf = (t.detach().float().requires_grad_(True) for t in (a, b))
    wa, wb = torch.autograd.grad(op(af, bf), (af, bf), g)
    assert da.dtype == db.dtype == torch.bfloat16
    assert torch.equal(da, wa.bfloat16()) and torch.equal(db, wb.bfloat16())


@pytest.mark.parametrize("fn,shapes", [
    ("dot", ((2, 5, 32), (32, 24))), ("bmm", ((3, 5, 32), (3, 32, 24)))])
def test_dot_and_bmm_differentiate_off_the_cpu(fn, shapes):
    """Off the CPU (meta tensors stand in for the card's), bf16 operands
    take the ``out_dtype`` overloads, which torch cannot differentiate, and
    ``layers.dot`` / ``bmm`` still give f32 results and bf16 gradients of
    the operands' shapes."""
    from repro_torch.models import layers
    x, w = (torch.empty(s, device="meta", dtype=torch.bfloat16,
                        requires_grad=True) for s in shapes)
    out = getattr(layers, fn)(x, w)
    assert out.dtype == torch.float32
    gx, gw = torch.autograd.grad(out, (x, w), torch.empty_like(out))
    assert (gx.shape, gx.dtype) == (x.shape, torch.bfloat16)
    assert (gw.shape, gw.dtype) == (w.shape, torch.bfloat16)
