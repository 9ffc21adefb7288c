"""Build the hand kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``build/kernels/lib<name>-<digest>.so`` beside the package, the first
time a wrapper needs it.  The digest covers the sources and flags, so an
edited kernel is rebuilt and a stale library is never loaded.  Several
sources build at once: :func:`build` starts one nvcc per missing library and
waits for all of them.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("quantize", "qmm", "epilogue", "fused_matmul", "depthwise",
           "chain")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points of each library: name -> argument types (all return the
# launch's cudaGetLastError() as an int)
SIGNATURES = {
    "quantize": {
        # x, x_bf16, out, out_f32, n, recip, qbit, nonneg, ftz, vec, stream
        "slfp_quantize": (_P, _I, _P, _I, _LL, _F, _I, _I, _I, _I, _P),
        "slfp_quantize_f32form": (_P, _I, _P, _LL, _I, _P),
    },
    "qmm": {
        # ..., then the tile plan (bm, bn, split, stages, smem), the
        # split-K workspace and the stream
        "slfp_qmm": (_P, _P, _I, _I, _P, _P, _P, _P, _I, _LL, _I, _I, _I,
                     _F, _I, _I, _F) + (_I,) * 5 + (_P, _P),
    },
    "epilogue": {
        # y, identity, s, t, raw, q, q_f32, rows, C, recip, relu, ftz, vec,
        # stream
        "slfp_epilogue": (_P, _P, _P, _P, _P, _P, _I, _LL, _I, _F, _I, _I,
                          _I, _P),
    },
    "fused_matmul": {
        "slfp_fused_matmul": (_P, _I, _LL, _I, _LL, _LL, _LL, _LL, _P, _I,
                              _I, _P, _P, _I, _LL, _I, _I, _I, _F, _I, _F,
                              _F, _I) + (_I,) * 5 + (_P, _P),
    },
    "depthwise": {
        # ..., then the route (ftz) and the plan (cg, tw, rows), the stream
        "slfp_dw3x3": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _F, _I, _I) + (_I,) * 4 + (_P,),
    },
    "chain": {
        # ..., the plan (rows, split), the recips, the route (ftz), the
        # stream
        "slfp_bottleneck_chain": (_P,) * 13 + (_I,) * 7 + (_F,) * 3
        + (_I, _P),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ at first "
            "use and need the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    # every shared header enters the digest: an edited header rebuilds
    # every library that may include it
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, all nvcc
    processes at once; returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        # write to a private name, then rename: a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          f"{out.decode(errors='replace')}")
        else:
            os.replace(tmp, library_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def launch(name: str, fn: str, *args) -> None:
    """Call ``fn`` of library ``name``; raise if the launch failed."""
    rc = getattr(load(name), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned16(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def check_cuda(*tensors) -> None:
    """Raise unless every tensor given is contiguous and on one CUDA
    device: the kernels take no strides."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel operands must share one CUDA device, got {devs}")
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


_FLT_MIN = float(np.finfo(np.float32).tiny)


def no_subnormal(t: torch.Tensor) -> bool:
    """No element of ``t`` is subnormal: what lets a kernel fold its
    flushes into the FTZ forms of its float instructions.  Reads the tensor
    as it is now (a device sync on the card); callers decide once where
    they lay out their weights."""
    a = t.detach().abs()
    return not bool(((a > 0) & (a < _FLT_MIN)).any())


def normal_scalar(v: float) -> bool:
    """float32(v) is zero or normal."""
    a = abs(float(np.float32(v)))
    return a == 0 or a >= _FLT_MIN
