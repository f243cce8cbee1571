"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/repro_torch_kernels/`` at the repository root, at first use, then
loaded with ``ctypes``. The library name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header never loads a stale build. ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them.

``LAUNCHES`` counts kernel launches by the name of the TPU kernel body
each one replaces: a wrapper adds one where it launches a kernel and
nowhere else (its plain version on CPU tensors does not count).

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("aqua_decode", "aqua_prefill", "flash_attention")
LAUNCHES: Counter = Counter()


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when autograd would differentiate
    through kernel ``name``: grad mode on and some input requires grad.
    The hand-written kernels, like JAX's Pallas kernels, have no reverse
    mode, and their outputs (written through raw pointers) carry no
    ``grad_fn``: a loss through them would backpropagate nothing into
    q, k and v. Both devices refuse, as JAX's interpret mode does."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the hand-written kernels have no reverse mode (as "
            "JAX's Pallas kernels have none); differentiate through the "
            "`dense` or `aqua-masked-dense` attention backend (what "
            "`auto` picks under grad), or run inference under "
            "torch.no_grad()")


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the GPU")
    return path


def _lib_path(name: str) -> Path:
    """The library of ``<name>.cu``, tagged with a hash of the source, every
    header of ``csrc/`` and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for one nvcc; returns its output (ptxas register report)."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel; returns nvcc's output per
    source (empty for sources already built)."""
    with _lock:
        jobs = {name: _start(name) for name in SOURCES}
        return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """Load (building first if needed) ``lib<name>`` and set ``argtypes``
    and ``restype`` (int: the ``cudaError_t`` of the launch) of each
    entry point in ``signatures``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def aligned16(*tensors) -> bool:
    """Whether every tensor can be copied in 16-byte ``cp.async`` pieces
    along its last axis: a 16-byte aligned base and outer strides that are
    whole 16-byte units (the stride of an axis of size 1 is never used)."""
    for x in tensors:
        unit = 16 // x.element_size()
        if x.data_ptr() % 16 or any(st % unit for st, n in
                                    zip(x.stride()[:-1], x.shape[:-1])
                                    if n > 1):
            return False
    return True


def f32_copy_width(*tensors, block_dims: int = 4) -> int:
    """The float32 attention kernels' copy width in floats: 4 (16-byte
    ``cp.async`` pieces) where every tensor's last axis and the dim-blocks
    are whole 4-float units and :func:`aligned16` holds, else 1."""
    whole = block_dims % 4 == 0 and all(x.shape[-1] % 4 == 0
                                        for x in tensors)
    return 4 if whole and aligned16(*tensors) else 1


def check_cp_async(what: str, *tensors) -> None:
    """Raise ``ValueError`` unless :func:`aligned16` holds for every tensor
    (the bf16 kernels' loads)."""
    for x in tensors:
        if not aligned16(x):
            raise ValueError(f"{what} kernel needs 16-byte aligned "
                             f"{x.dtype} views (base and outer strides), "
                             f"got strides {x.stride()} at offset "
                             f"{x.storage_offset()}")


#: TMA tensor maps take strides below 2**40 bytes and sizes below 2**32
TMA_STRIDE_LIMIT = 2 ** 40
TMA_SIZE_LIMIT = 2 ** 32


def check_tma(what: str, *tensors) -> None:
    """Raise ``ValueError`` unless every tensor can be described by the
    bf16 kernels' TMA tensor maps: each axis under 2**32 elements and each
    outer stride under 2**40 bytes (the stride of an axis of size 1 is
    never used). The 16-byte alignment TMA also needs is
    :func:`check_cp_async`'s."""
    for x in tensors:
        size = x.element_size()
        if any(n >= TMA_SIZE_LIMIT for n in x.shape) or any(
                st * size >= TMA_STRIDE_LIMIT
                for st, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1):
            raise ValueError(f"{what} kernel's tensor maps need axes under "
                             f"2**32 elements and strides under 2**40 "
                             f"bytes, got shape {tuple(x.shape)} and strides "
                             f"{x.stride()}")


def check(err: int, what: str) -> None:
    """Raise for a failed launch; count a good one under ``what``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
    LAUNCHES[what] += 1
