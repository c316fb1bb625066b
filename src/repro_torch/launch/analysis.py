"""Roofline analysis of a step counted on meta tensors (counterpart of
``repro.launch.analysis``).

JAX reads its terms from XLA's compiled artifacts; the port runs the step
eagerly, on meta tensors for the dry run (``repro_torch.launch.dryrun``)
or on the card to hold those counts to a measured step, under
``StepCounter``, which counts what is dispatched:

    compute term    = FLOPs / peak FLOP/s          (989 TFLOP/s bf16, H100)
    memory term     = bytes / HBM bandwidth        (3.35 TB/s)
    collective term = wire bytes / link bandwidth  (450 GB/s NVLink a way)

Two departures from XLA's numbers.  FLOPs count what
``torch.utils.flop_counter.FlopCounterMode`` counts, matrix products and
attention, plus each hand-written kernel's own operations, registered as
its dispatcher operator's FLOP formula (``flash_attention.kernel.fwd_ops``
/ ``bwd_ops``, ``rwkv6.kernel.wkv_ops`` / ``wkv_bwd_ops``); XLA's ``flops``
also counts elementwise work.  Bytes count each dispatched operator's
tensor operands (each distinct one once, a broadcast axis once) and results
on the step's device: a kernel's read-once, write-once traffic, as the
kernel table's bounds count it; an operand changed in place counts as read
and written; views and bare allocations move nothing and count nothing.
``cost_analysis_dict`` (XLA's list-or-dict shim) is not applicable.

The eager count sees every layer, so the port needs no scan correction
(``repro_torch.launch.bodies``).  ``memory_summary`` is a live-storage
tracker in the same mode: the step's arguments, outputs, temporaries and
peak, by storage.  Alias is 0: the port donates nothing.

Collective wire bytes use JAX's ring model, on records ``(op, dtype,
shape, group size)`` instead of HLO text (the port has no HLO):
    all-reduce:          2 (n-1)/n * result
    all-gather:            (n-1)/n * result          (result = gathered full)
    reduce-scatter:        (n-1)   * result          (result = shard)
    all-to-all:            (n-1)/n * result
    collective-permute:               result
Today a mesh repeats one device and no collective runs, so the dry run
feeds it nothing and writes its term as null (ROADMAP item 26).
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.flash_attention.kernel import bwd_ops as flash_bwd_ops
from repro_torch.kernels.flash_attention.kernel import fwd_ops as flash_fwd_ops
from repro_torch.kernels.rwkv6.kernel import wkv_bwd_ops, wkv_ops

__all__ = ["H100", "Hardware", "CostSummary", "Roofline", "StepCounter",
           "analyze_step", "collective_wire_bytes", "memory_summary",
           "model_flops", "roofline", "flash_fwd_ops", "flash_bwd_ops",
           "wkv_ops", "wkv_bwd_ops"]

# ---- NVIDIA H100 SXM, data sheet (dense rates; 80 GB HBM3) ----------------
HBM_BW = 3.35e12             # bytes/s
BF16_FLOPS = 989e12          # tensor cores, bf16 / fp16
TF32_FLOPS = 495e12          # tensor cores, TF32
FP32_FLOPS = 67e12           # CUDA cores
FP64_FLOPS = 34e12           # CUDA cores
NVLINK_BW = 450e9            # bytes/s each way (900 GB/s a card, all to all)


@dataclass(frozen=True)
class Hardware:
    """One card's peaks for :func:`roofline`."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    source: str = ""


H100 = Hardware(
    name="NVIDIA H100 80GB HBM3, 700.00 W",
    peak_flops=BF16_FLOPS, hbm_bw=HBM_BW, link_bw=NVLINK_BW,
    source="NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s "
           "HBM3, NVLink 900 GB/s a card (450 GB/s each way); at the full "
           "700 W power limit")


@dataclass
class CostSummary:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: Dict[str, float] = field(default_factory=dict)

    def __add__(self, o):
        by = dict(self.coll_by_op)
        for k, v in o.coll_by_op.items():
            by[k] = by.get(k, 0.0) + v
        return CostSummary(self.flops + o.flops,
                           self.bytes_accessed + o.bytes_accessed,
                           self.coll_bytes + o.coll_bytes, by)

    def scaled(self, k: float):
        return CostSummary(self.flops * k, self.bytes_accessed * k,
                           self.coll_bytes * k,
                           {a: b * k for a, b in self.coll_by_op.items()})


def collective_wire_bytes(records: Iterable[Tuple[str, torch.dtype, tuple,
                                                  int]]
                          ) -> Tuple[float, Dict[str, float]]:
    """Wire bytes of ``(op, dtype, result shape, group size)`` records."""
    total, by_op = 0.0, {}
    for op, dtype, shape, n in records:
        nbytes = float(dtype.itemsize * math.prod(shape))
        if op == "collective-permute":
            # participation is by source-target pairs, not groups
            wire = nbytes
        elif n <= 1:
            continue
        elif op == "all-reduce":
            wire = 2.0 * (n - 1) / n * nbytes
        elif op in ("all-gather", "all-to-all"):
            wire = (n - 1) / n * nbytes
        elif op == "reduce-scatter":
            wire = float(n - 1) * nbytes
        else:
            raise ValueError(f"unknown collective {op!r}")
        total += wire
        by_op[op] = by_op.get(op, 0.0) + wire
    return total, by_op


# --------------------------------------------------------------------------
# counting what a step dispatches
# --------------------------------------------------------------------------

_ALLOCATIONS = frozenset({torch.ops.aten.empty, torch.ops.aten.empty_like,
                          torch.ops.aten.empty_strided,
                          torch.ops.aten.new_empty,
                          torch.ops.aten.new_empty_strided})


def _bmm_flop(a, b, *args, out_val=None, **kwargs):
    """``aten.bmm``'s count, taking the ``out_dtype`` overload's extra
    argument (torch's own formula does not)."""
    n, m, k = a.shape
    return n * m * b.shape[2] * 2 * k


def _flop_formula(packet):
    """``torch.utils.flop_counter``'s formula for an operator (the kernels'
    own registered with it), called on the operator's arguments."""
    if packet is torch.ops.aten.bmm:
        return _bmm_flop
    return flop_registry.get(packet)


def _tensors(x):
    """The tensors of an operator's arguments or results (tensors, and
    lists, tuples and dicts of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast axis counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts a step's FLOPs, bytes and live storages.

    ``run(fn, *args)`` calls ``fn(*args)`` under this mode.  FLOPs are
    ``torch.utils.flop_counter``'s formulas, the ones ``FlopCounterMode``
    applies, read from its registry in this one mode (nesting
    ``FlopCounterMode``, whose own dispatch tries to decompose every other
    operator, doubles the time of a meta step; the tests hold the two
    counts equal).  Tensors on the device type of the first argument tensor
    are counted (meta in the dry run, cuda on the card); CPU tensors beside
    them (random-state copies) are not.  ``by_op`` keeps each operator's
    calls and bytes, ``flops_by_op`` its FLOPs."""

    def __init__(self):
        super().__init__()
        self.device_type = None
        self.flops = 0
        self.bytes = 0
        self.by_op: Dict[str, list] = {}
        self.flops_by_op: Dict[str, int] = {}
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._arg_ids: set = set()
        self._ops: Dict[object, tuple] = {}
        self.live_bytes = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.peak_bytes = 0

    # ---- live storages ---------------------------------------------------
    def _hold(self, t: torch.Tensor) -> int:
        """Tracks ``t``'s storage; returns its bytes where it is new."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self._refs[key] = weakref.ref(st, lambda _, key=key:
                                      self._release(key))
        self.live_bytes += n
        return n

    def _release(self, key):
        self.live_bytes -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        dev = self.device_type
        outs = [t for t in _tensors(out) if t.device.type == dev]
        op = self._ops.get(func)
        if op is None:
            packet = func.overloadpacket
            op = self._ops[func] = (
                str(packet), _flop_formula(packet),
                not (func.is_view or packet in _ALLOCATIONS))
        name, formula, moves = op
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        if moves:
            seen, n = set(), 0
            for t in _tensors(args) + _tensors(kwargs):
                if t.device.type == dev and id(t) not in seen:
                    seen.add(id(t))
                    n += _nbytes(t)
            n += sum(_nbytes(t) for t in outs)
            self.bytes += n
            rec = self.by_op.setdefault(name, [0, 0])
            rec[0] += 1
            rec[1] += n
        for t in outs:
            self._hold(t)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
        return out

    def run(self, fn, *args):
        """``fn(*args)``, counted; returns its output."""
        leaves = _tensors(args)
        if not leaves:
            raise ValueError("StepCounter.run: the step takes no tensor")
        self.device_type = leaves[0].device.type
        for t in leaves:
            if t.device.type == self.device_type:
                self.argument_bytes += self._hold(t)
                self._arg_ids.add(id(t.untyped_storage()))
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        with self:
            out = fn(*args)
        new = {id(t.untyped_storage()): t.untyped_storage().nbytes()
               for t in _tensors(out) if t.device.type == self.device_type}
        self.output_bytes = sum(n for k, n in new.items()
                                if k not in self._arg_ids)
        return out

    def cost(self) -> CostSummary:
        return CostSummary(flops=float(self.flops),
                           bytes_accessed=float(self.bytes))


def analyze_step(fn, *args) -> CostSummary:
    """``fn(*args)`` counted by :class:`StepCounter`."""
    counter = StepCounter()
    counter.run(fn, *args)
    return counter.cost()


def memory_summary(counter: StepCounter) -> Dict[str, float]:
    """A counted step's storages in GB: its arguments, the new storages its
    output holds, the rest of its peak (temporaries) and the peak of live
    storages, arguments included."""
    temp = counter.peak_bytes - counter.argument_bytes - counter.output_bytes
    return {"argument_gb": counter.argument_bytes / 1e9,
            "output_gb": counter.output_bytes / 1e9,
            "temp_gb": max(temp, 0) / 1e9,
            "alias_gb": 0.0,
            "peak_gb": counter.peak_bytes / 1e9}


@dataclass
class Roofline:
    t_compute: float
    t_memory: float
    t_collective: Optional[float]

    def _terms(self) -> dict:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        """The largest term; a null term (not measured) is left out."""
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self._terms().values())

    @property
    def compute_fraction(self) -> float:
        """Fraction of the bound spent on useful math = how close to the
        compute roofline this cell can get (1.0 = perfectly compute-bound)."""
        return self.t_compute / max(self.t_bound, 1e-30)


def roofline(cost: CostSummary, hw: Hardware = H100) -> Roofline:
    return Roofline(t_compute=cost.flops / hw.peak_flops,
                    t_memory=cost.bytes_accessed / hw.hbm_bw,
                    t_collective=cost.coll_bytes / hw.link_bw)


def model_flops(cfg, shape, n_params: int, active_params: int) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D inference (N = active)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active_params * tokens
