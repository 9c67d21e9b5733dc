"""Build, load and launch the port's CUDA kernels.

Every kernel is one source ``csrc/<name>.cu`` (with the ``csrc/*.cuh``
headers the sources share) exporting one C entry point of the same name:
pointer arguments, int arguments, then the stream, returning the
``cudaGetLastError()`` of its launch. The sources are compiled at first
use, one ``nvcc`` per source run in parallel, into ``_build/`` (listed in
.gitignore), and bound with ctypes. Nothing here runs at import: the CPU
tests import every module, on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# pointer arguments, int arguments of each C entry point (then the stream)
ARITY = {
    "painn_message_l1": (10, 7),
    "painn_message_fused": (10, 6),
    "painn_update_fused": (12, 4),
    "painn_message_bwd": (17, 8),
    "painn_message_l1_banded": (11, 10),
    "painn_message_fused_banded": (11, 9),
    "painn_message_subset": (11, 10),
    "painn_message_bwd_banded": (18, 11),
    "painn_message_bwd2": (26, 8),
    "chgnet_conv": (14, 5),
    "chgnet_conv_banded": (15, 8),
    "chgnet_conv_bwd": (24, 8),
    "eam_rho_ep": (7, 4),
}
KERNELS = tuple(ARITY)
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found; set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    """Build output of one source, named by a hash of the source, the shared
    headers and the flags so that an edited source is never served a stale
    library."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_kernels(names=KERNELS) -> dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns each one's compiler output (the
    ``-Xptxas -v`` register and shared-memory report; "" if it was already
    built). Raises if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    logs: dict[str, str] = {}
    running = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            build_kernels((name,))
        lib = ctypes.CDLL(str(path))
        n_ptr, n_int = ARITY[name]
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def launch(name: str, tensors, ints) -> None:
    """Call a kernel's C entry point on PyTorch's current stream and raise
    on the cudaGetLastError() it returns (a refused launch never runs, and
    a later synchronize would not report it). ``None`` passes a null
    pointer."""
    dev = next(t for t in tensors if t is not None).device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(_lib(name), name)(*[0 if t is None else t.data_ptr() for t in tensors],
                                        *[int(i) for i in ints], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def check_inputs(name: str, dev: torch.device, **tensors) -> None:
    """Every input on ``dev``, of its dtype and shape, and contiguous.
    Each value is (tensor, dtype, shape)."""
    for arg, (t, dtype, shape) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
