"""Meshes (counterpart of ``repro.launch.mesh``).  Functions, not module
constants, so importing this module touches no device.

A mesh takes one CUDA card a position (``devices`` omitted) and raises
where there are fewer cards than positions; it repeats a device only when
the caller lists the devices (``devices=["cuda:0"] * 16`` on one card,
``["cpu"] * 4`` on the CPU), as ``repro_torch.core.sharding.lane_mesh``
does.  ``repro_torch.models.sharding`` describes the layout.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.sharding import Distribution, Mesh
from repro_torch.utils import indexed_device, resolve_device


def make_mesh(shape, axes, *, devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.

    ``devices`` omitted: the first ``prod(shape)`` CUDA cards, raising
    where CUDA is absent or the cards are fewer.  Given: exactly
    ``prod(shape)`` devices (str or ``torch.device``), repeats allowed,
    laid out in row-major order.
    """
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    n = math.prod(shape)
    if devices is None:
        resolve_device("cuda")
        avail = torch.cuda.device_count()
        if n > avail:
            raise ValueError(f"a {shape} mesh needs {n} CUDA cards, {avail} "
                             "visible (pass devices=[...] to repeat a "
                             "device)")
        devices = [f"cuda:{i}" for i in range(n)]
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, got "
                         f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [indexed_device(d) for d in devices]
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def dist_for(mesh, *, fsdp: bool) -> Distribution:
    axes = mesh.axis_names
    dp_axes = tuple(a for a in axes if a != "model")
    tp = "model" if "model" in axes else None
    return Distribution(mesh=mesh, dp_axes=dp_axes, tp_axis=tp, fsdp=fsdp)
