"""ctypes bindings for the native host runtime (counterpart of the JAX
``utils/native.py``): the repository's ``native/slfp_native.cpp`` (SLFP<3,4>
codec, absmax, the CIFAR batch augmenter).

The port builds its own copy of the library at first use, with the flags of
``native/Makefile`` (``$CXX``, default ``g++``), into
``build/native/libslfp_native-<digest>.so`` beside the package.  The
digest covers the source, the flags and the target ``-march=native``
resolves to on this host, so a library built for another CPU is never
loaded (the one ``make -C native`` leaves in ``native/`` is not read).
Callers handle :func:`available` being False: every user has a numpy
route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shlex
import subprocess
import tempfile
from typing import Optional

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "slfp_native.cpp"
MAKEFILE = _REPO / "native" / "Makefile"
BUILD_DIR = _REPO / "build" / "native"
_lib: Optional[ctypes.CDLL] = None
_tried = False
error: Optional[str] = None     # why the library is not available
path: Optional[pathlib.Path] = None   # the library loaded


def _flags() -> list[str]:
    """``CXXFLAGS`` as ``native/Makefile`` sets it, then its link flags."""
    m = re.search(r"^CXXFLAGS\s*\?=\s*(.*)$", MAKEFILE.read_text(), re.M)
    if m is None:
        raise RuntimeError(f"no CXXFLAGS in {MAKEFILE}")
    return shlex.split(os.environ.get("CXXFLAGS", m.group(1)))


def _target(cxx: str, flags: list[str]) -> bytes:
    """What the compiler makes of the flags on this host (``-march=native``
    names this CPU)."""
    out = subprocess.run([cxx, *flags, "-Q", "--help=target"],
                         capture_output=True, timeout=60)
    return out.stdout


def _build() -> pathlib.Path:
    cxx = os.environ.get("CXX", "g++")
    flags = _flags()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([cxx, *flags]).encode())
    h.update(_target(cxx, flags))
    lib = BUILD_DIR / f"libslfp_native-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run([cxx, *flags, "-shared", "-o", tmp, str(SOURCE),
                              "-lpthread"], capture_output=True, text=True,
                             timeout=300)
        if out.returncode:
            raise RuntimeError(f"{cxx} failed:\n{out.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, error, path
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib_path = _build()
        lib = ctypes.CDLL(str(lib_path))
    except Exception as e:  # no compiler, a failed build or load
        error = f"{type(e).__name__}: {e}"
        return None
    i64, f32p, u8p, u64 = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64)
    lib.slfp34_pack.argtypes = [f32p, u8p, i64]
    lib.slfp34_unpack.argtypes = [u8p, f32p, i64]
    lib.slfp34_quantize_act.argtypes = [f32p, f32p, i64]
    lib.absmax.argtypes = [f32p, i64]
    lib.absmax.restype = ctypes.c_float
    lib.cifar_augment.argtypes = [u8p, f32p, i64, f32p, f32p,
                                  ctypes.c_int, u64]
    _lib, path = lib, lib_path
    return _lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _up(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def slfp34_pack(x: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.uint8)
    lib.slfp34_pack(_fp(x), _up(out), x.size)
    return out


def slfp34_unpack(codes: np.ndarray) -> np.ndarray:
    lib = _load()
    codes = np.ascontiguousarray(codes, np.uint8)
    out = np.empty(codes.shape, np.float32)
    lib.slfp34_unpack(_up(codes), _fp(out), codes.size)
    return out


def slfp34_quantize_act(x: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.float32)
    lib.slfp34_quantize_act(_fp(x), _fp(out), x.size)
    return out


def absmax(x: np.ndarray) -> float:
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    return float(lib.absmax(_fp(x), x.size))


def cifar_augment(images_u8: np.ndarray, mean, std, *, train: bool,
                  seed: int) -> np.ndarray:
    """Normalized NHWC float32 of 32x32x3 uint8 images; ``train`` draws a
    reflect-pad-4 crop and a flip per image from ``seed`` and its index."""
    lib = _load()
    images_u8 = np.ascontiguousarray(images_u8, np.uint8)
    n = images_u8.shape[0]
    out = np.empty((n, 32, 32, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.cifar_augment(_up(images_u8), _fp(out), n, _fp(mean), _fp(std),
                      1 if train else 0, seed & 0xFFFFFFFFFFFFFFFF)
    return out
