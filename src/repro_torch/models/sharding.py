"""Distribution context and sharding rules (counterpart of
``repro.models.sharding``).

``Distribution`` carries the mesh and its axis names through the model
code; with ``mesh=None`` (``LOCAL``) everything is the single-device
model.  Parameter specs follow Megatron-style tensor parallelism on the
``model`` axis, with optional FSDP sharding of the d_model / d_ff dimension
over the innermost data axis (``param_specs``: the reference's path rules,
unchanged).

The H100 counterpart of a mesh.  NCCL puts no two ranks of one process
group on the same card, so on a machine with one card a
``torch.distributed`` device mesh cannot hold more than one rank.  The port
lays a mesh out as its lane meshes do (``repro_torch.core.sharding``):

* a :class:`Mesh` is an object array of ``torch.device`` in the mesh's
  shape, with its axis names; a device may appear more than once
  (``launch.mesh.make_mesh(..., devices=["cuda:0"] * 16)``, ``["cpu"] *
  4`` in the CPU tests);
* a sharded tensor is one tensor on the mesh's first device; the shard on
  mesh position ``d`` is a view of it where that position holds the same
  device, and a copy to its device otherwise;
* ``Distribution(mesh=None)`` (``LOCAL``) is the single-device model bit
  for bit, and so is a 1 x 1 mesh of one device.

``Distribution.constrain(x, *spec)`` returns ``x`` unchanged:
``with_sharding_constraint`` never changes a value either.  It checks the
spec as JAX does: no longer than ``x.ndim``, every axis name on the mesh,
no axis used twice; it raises where JAX would.  So the constraints whose
only job is to schedule XLA (the head, residual, sequence-parallel and
logits constraints of ``transformer``, the FSDP all-gathers of the MoE
body) change no value here.  Three places under a mesh change values, and
the port reproduces them: the GQA key/value repeat up to the tensor-parallel
degree (``transformer._attn_mixer``), the sequence-sharded decode form
(``attention.decode_attention``) and the expert-parallel MoE, whose
capacity is taken per data-parallel rank (``moe.moe_apply``).

Training under a mesh.  The reference's data-parallel reduction order does
not exist here (its re-mesh test allows 2e-2 for it): a dense model's loss
is the same on every mesh, and so are its gradients where tp does not
exceed its kv heads; above them the GQA repeat's backward sums the
repeated heads' gradients in another order.  An MoE model's forward
depends on the data-parallel split only through the per-rank capacity;
its expert weights' gradients sum the ranks' contributions, as the
reference's ``psum`` does, in their own order.

Not applicable in eager PyTorch: ``jax.jit``'s ``in_shardings`` and its
compile caches, and buffer donation (a step is functional and returns new
trees).  GSPMD's padding of uneven dimensions has no counterpart either:
``launch.steps.sanitize`` replicates them, as in JAX.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


def _entry(e):
    """One dimension's entry as JAX normalises it: None, an axis name, or a
    tuple of two or more names (a 1-tuple becomes its name, () None)."""
    if e is None or isinstance(e, str):
        return e
    if isinstance(e, (tuple, list)) and all(isinstance(a, str) for a in e):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    raise TypeError(f"a PartitionSpec entry is None, an axis name or a "
                    f"tuple of axis names, not {e!r}")


class PartitionSpec(tuple):
    """A tuple of per-dimension entries, each None (replicated), an axis
    name or a tuple of names; entries are normalised as JAX's are, so
    ``tuple(P(...))`` equals ``tuple(jax.sharding.PartitionSpec(...))``.
    Missing trailing entries mean replicated dimensions."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out along named axes.

    Attributes
    ----------
    devices : np.ndarray
        Object array of ``torch.device`` in the mesh's shape (repeats
        allowed).
    axis_names : tuple of str
        One name an axis of ``devices``.
    """
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis name in {self.axis_names}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return (tuple(self.devices.shape), tuple(map(str, self.devices.flat)),
                tuple(self.axis_names))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def _check_spec(mesh: Mesh, spec, ndim: Optional[int] = None) -> None:
    """Raise ``ValueError`` where JAX refuses ``spec`` on ``mesh`` (and, given
    ``ndim``, on an array of that rank)."""
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"PartitionSpec {spec} has {len(spec)} entries for "
                         f"an array of rank {ndim}")
    seen = []
    for e in spec:
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            if a not in mesh.axis_names:
                raise ValueError(f"axis {a!r} of PartitionSpec {spec} is not "
                                 f"on the mesh's axes {mesh.axis_names}")
            if a in seen:
                raise ValueError(f"axis {a!r} is used twice in "
                                 f"PartitionSpec {spec}")
            seen.append(a)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the tensor lies whole on the mesh's first device
    (:attr:`device`)."""
    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        if not isinstance(self.mesh, Mesh):
            raise TypeError(f"NamedSharding needs a Mesh, not {self.mesh!r}")
        object.__setattr__(self, "spec", P(*self.spec))
        _check_spec(self.mesh, self.spec)

    @property
    def device(self) -> torch.device:
        return self.mesh.devices.flat[0]


@dataclass(frozen=True)
class Distribution:
    mesh: Optional[Mesh] = None
    dp_axes: Tuple[str, ...] = ("data",)   # ("pod","data") on multi-pod
    tp_axis: Optional[str] = "model"
    fsdp: bool = False

    @property
    def dp(self):
        return self.dp_axes if self.mesh is not None else None

    @property
    def tp(self):
        return self.tp_axis if self.mesh is not None else None

    @property
    def fsdp_axis(self):
        # FSDP shards the hidden param dim over the innermost dp axis ("data")
        return (self.dp_axes[-1] if (self.fsdp and self.mesh is not None)
                else None)

    def constrain(self, x, *spec):
        """``x`` itself, after checking ``spec`` as JAX's
        ``with_sharding_constraint`` does (a no-op without a mesh)."""
        if self.mesh is None:
            return x
        _check_spec(self.mesh, P(*spec), x.ndim)
        return x

    def tp_size(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.mesh.shape[self.tp_axis]


LOCAL = Distribution(mesh=None)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and tuples
    (a ``PartitionSpec`` is a leaf), the path being the keys and indices
    joined by ``/``; the structure and key order are kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def param_specs(cfg, params, dist: Distribution):
    """PartitionSpec tree matching ``params`` (path-based rules).

    Takes the port's per-layer tree (``params["layers"][i]``,
    ``params["enc_layers"][i]``: a layer's leaf gets the reference's spec
    without the leading None of its layer axis) and the stacked host layout
    of ``convert.lm_params_to_host`` and the checkpoints (``blocks/...``,
    ``enc_blocks/...``, ``dec_blocks/...``: the reference's spec itself).
    """
    fa = dist.fsdp_axis
    tp = dist.tp

    def spec_for(path: str, x):
        nd = x.ndim
        stacked = path.startswith(("blocks/", "enc_blocks/", "dec_blocks/"))
        lead = (None,) if stacked else ()
        core = nd - len(lead)

        def S(*s):
            return P(*(lead + s))

        leaf = path.split("/")[-1]
        parent = path.split("/")[-2] if "/" in path else ""
        if leaf in ("embed", "unembed_w"):
            return P(tp, fa) if leaf == "embed" else P(fa, tp)
        if leaf == "pos_embed":
            return P(None, fa)
        if parent == "experts" or parent.endswith("experts"):
            # (E, d, f) / (E, f, d): experts on tp, hidden dim on fsdp
            return S(tp, fa, None) if core == 3 else S(tp, None)
        if leaf in ("wq", "wk", "wv", "wg", "wu"):        # column parallel
            return S(fa, tp) if core == 2 else S(None)
        if leaf in ("wo", "wd"):                          # row parallel
            return S(tp, fa) if core == 2 else S(None)
        if leaf == "wr_router":
            return S(None, None)
        if leaf in ("in_proj",):                          # mamba (d, 2*d_in)
            return S(fa, tp)
        if leaf in ("out_proj",):                         # mamba (d_in, d)
            return S(tp, fa)
        if leaf in ("A_log", "x_proj"):                   # (d_in, *)
            return S(tp, None)
        if leaf in ("D", "dt_bias", "conv_b"):            # (d_in,)
            return S(tp)
        if leaf in ("conv_w",):                           # (d_conv, d_in)
            return S(None, tp)
        if leaf in ("dt_w",):                             # (dt_rank, d_in)
            return S(None, tp)
        if leaf == "rwkv_wo":                             # (d, d) row parallel
            return S(tp, fa)
        if leaf.startswith("rwkv_w"):
            # rwkv projections (d, d): column-parallel on the head dim
            return S(fa, tp) if core == 2 else S(*([None] * core))
        return S(*([None] * core))

    return map_with_path(spec_for, params)


def named_shardings(cfg, params, dist: Distribution):
    specs = param_specs(cfg, params, dist)
    return map_with_path(lambda _, s: NamedSharding(dist.mesh, s), specs)
