"""PyTorch + CUDA port of the GNEP runtime capacity allocator.

Counterpart of the JAX package ``repro``, slice by slice (ROADMAP.md).  It
imports neither ``jax`` nor ``repro``.  Entry points that build inputs run
on the card (``device="cuda"``) unless the caller passes ``device="cpu"``;
solvers run where their tensors lie.  The CUDA kernels live in ``csrc/``
and are built by ``nvcc`` at first use (``kernels/_build.py``).
"""

__version__ = "1.0.0"
