"""Build the port's CUDA sources and bind them with ctypes.

Each ``csrc/<name>.cu`` exports plain C entry points (pointers, ints and a
``cudaStream_t``) and is compiled at first use by ``nvcc`` into
``build/kernels/lib<name>-<hash>.so`` at the repository root; the hash of
the source, its flags and the shared headers (``csrc/*.cuh``) names the
library, so an edited source or header is never served by a stale build.  Nothing here runs when a module is imported: the CPU tests
import every module on hosts that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: ``-fmad=false`` for the allocator kernels: the fused iteration is bitwise
#: against its plain torch version, which rounds every multiply and every
#: add on its own, and the sweep shares its flags.  The model kernels (flash
#: attention, WKV6) are held to their plain versions within a stated
#: tolerance and keep nvcc's default contraction into FMAs.
_NO_FMAD = ("gnep_sweep", "gnep_iter")


def nvcc_flags(name: str) -> tuple:
    return (("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
            + (("-fmad=false",) if name in _NO_FMAD else ())
            + ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"))

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin): cannot build "
                       "the port's CUDA kernels")


def _target(name: str) -> Path:
    flags = " ".join(nvcc_flags(name)).encode()
    # the shared headers too, so that an edited header rebuilds its sources
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + flags
                            + headers).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict:
    """Compile every named source that has no library yet, all ``nvcc``
    processes started together; raise with the compiler output on failure.

    Returns name -> compiler output (the ``ptxas`` report of registers,
    shared memory and spills) for the sources it compiled.
    """
    todo = [n for n in names if not _target(n).exists()]
    logs = {}
    if not todo:
        return logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *nvcc_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; declare ``signatures``
    (C function name -> list of ctypes argument types), each returning the
    ``int`` value of ``cudaGetLastError()`` after its launch."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream

