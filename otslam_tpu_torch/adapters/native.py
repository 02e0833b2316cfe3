"""ctypes bindings for the native host runtime (counterpart of
otslam_tpu/adapters/native.py).

The port keeps its own copy of the C++ source, `otslam_tpu_torch/native/
otslam_native.cpp`, and builds it on first use with g++ into
``otslam_tpu_torch_native/<hash of source and flags>/`` in the build root
(build_dirs.py: the checkout's ``build/``, or the user's cache directory
for an installed package; one that cannot be written raises), writing
the library by atomic rename (as kernels/_build.py does for nvcc), so two
processes that build at once never share a half-written file. The flags
leave out the JAX build's -march=native, so a library built on one machine
runs on any x86-64 host that shares the checkout. Every entry point has a NumPy fallback for a machine
without g++; `native_available()` says which one is in use. The FrameRing
is the sensor -> device frame queue: a C++ SPSC ring with drop-oldest
semantics (depth-1-QoS behaviour) whose buffers the capture thread fills
without holding the GIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import deque
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from otslam_tpu_torch.build_dirs import build_root, make_build_dir

NATIVE_SRC = Path(__file__).resolve().parents[1] / "native"
BUILD_ROOT = build_root() / "otslam_tpu_torch_native"
NATIVE_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def build_host_library(src: Path, flags: list[str]) -> Path | None:
    """The shared library of one C++ source, compiled by g++ under
    BUILD_ROOT/<hash of source and flags>/ on first use; None when g++ is
    missing or the build fails (the caller falls back or raises)."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / f"lib{src.stem}.so"
    if lib_path.is_file():
        return lib_path
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    make_build_dir(out_dir)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = str(Path(tmp) / lib_path.name)
        try:
            subprocess.run([gxx, *flags, str(src), "-o", tmp_lib],
                           check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                OSError):
            return None
        os.replace(tmp_lib, lib_path)  # atomic: no half-written library
    return lib_path


def load_native():
    """The loaded CDLL, building if needed; None when unavailable."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        path = build_host_library(NATIVE_SRC / "otslam_native.cpp",
                                  NATIVE_FLAGS)
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_int64
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_dropped.restype = ctypes.c_int64
        lib.ring_dropped.argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_int
        lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_double]
        lib.ring_pop.restype = ctypes.c_int
        lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_double)]
        lib.ring_pop_latest.restype = ctypes.c_int
        lib.ring_pop_latest.argtypes = lib.ring_pop.argtypes
        lib.depth_u16_to_m.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_float]
        lib.depth_m_to_u16.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_float,
                                       ctypes.c_float]
        lib.depth_filter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_float]
        lib.write_ply_points.restype = ctypes.c_int64
        lib.write_ply_points.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_int64]
        lib.write_pgm.restype = ctypes.c_int64
        lib.write_pgm.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the native library is in use, False on the NumPy
    fallback."""
    return load_native() is not None


class FrameRing:
    """SPSC RGB-D frame queue. Frames are (depth f32 (H,W), color u8 (H,W,3))
    packed into one contiguous slab per slot."""

    def __init__(self, height: int, width: int, capacity: int = 8):
        self.height, self.width = height, width
        self.depth_bytes = height * width * 4
        self.color_bytes = height * width * 3
        self.frame_bytes = self.depth_bytes + self.color_bytes
        self._lib = load_native()
        self._scratch = np.empty(self.frame_bytes, np.uint8)
        if self._lib is not None:
            self._ring = self._lib.ring_create(capacity, self.frame_bytes)
        else:  # NumPy fallback (deque-like)
            self._ring = None
            self._q: deque = deque(maxlen=capacity)
            self._dropped = 0
            self._cap = capacity

    def push(self, depth_m: np.ndarray, color_rgb: np.ndarray,
             stamp: float = 0.0) -> None:
        d = np.ascontiguousarray(depth_m, np.float32)
        c = np.ascontiguousarray(color_rgb, np.uint8)
        if self._ring is not None:
            buf = self._scratch
            buf[:self.depth_bytes] = d.view(np.uint8).reshape(-1)
            buf[self.depth_bytes:] = c.reshape(-1)
            self._lib.ring_push(self._ring,
                                buf.ctypes.data_as(ctypes.c_void_p),
                                float(stamp))
        else:
            if len(self._q) == self._cap:
                self._dropped += 1
            self._q.append((d.copy(), c.copy(), float(stamp)))

    def _unpack(self, buf) -> Tuple[np.ndarray, np.ndarray]:
        d = buf[:self.depth_bytes].view(np.float32).reshape(
            self.height, self.width)
        c = buf[self.depth_bytes:].reshape(self.height, self.width, 3)
        return d.copy(), c.copy()

    def _pop_impl(self, fn) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
        buf = np.empty(self.frame_bytes, np.uint8)
        stamp = ctypes.c_double(0.0)
        ok = fn(self._ring, buf.ctypes.data_as(ctypes.c_void_p),
                ctypes.byref(stamp))
        if not ok:
            return None
        d, c = self._unpack(buf)
        return d, c, stamp.value

    def pop(self):
        if self._ring is not None:
            return self._pop_impl(self._lib.ring_pop)
        return self._q.popleft() if self._q else None

    def pop_latest(self):
        """Flush the queue and return the freshest frame (scanner semantics)."""
        if self._ring is not None:
            return self._pop_impl(self._lib.ring_pop_latest)
        if not self._q:
            return None
        item = self._q[-1]
        self._q.clear()
        return item

    def __len__(self) -> int:
        if self._ring is not None:
            return int(self._lib.ring_size(self._ring))
        return len(self._q)

    @property
    def dropped(self) -> int:
        if self._ring is not None:
            return int(self._lib.ring_dropped(self._ring))
        return self._dropped

    def __del__(self):
        if getattr(self, "_ring", None) is not None and self._lib is not None:
            self._lib.ring_destroy(self._ring)
            self._ring = None


def depth_u16_to_m(raw: np.ndarray, depth_scale: float = 1000.0) -> np.ndarray:
    lib = load_native()
    raw = np.ascontiguousarray(raw, np.uint16)
    if lib is None:
        return raw.astype(np.float32) / depth_scale
    out = np.empty(raw.shape, np.float32)
    lib.depth_u16_to_m(raw.ctypes.data_as(ctypes.c_void_p),
                       out.ctypes.data_as(ctypes.c_void_p),
                       raw.size, float(depth_scale))
    return out


def depth_m_to_u16(depth: np.ndarray, depth_scale: float = 1000.0,
                   depth_max: float = 5.0) -> np.ndarray:
    lib = load_native()
    d = np.ascontiguousarray(depth, np.float32)
    if lib is None:
        d2 = d.copy()
        d2[~np.isfinite(d2)] = 0.0
        d2[(d2 > depth_max) | (d2 < 0)] = 0.0
        return np.round(d2 * depth_scale).astype(np.uint16)
    out = np.empty(d.shape, np.uint16)
    lib.depth_m_to_u16(d.ctypes.data_as(ctypes.c_void_p),
                       out.ctypes.data_as(ctypes.c_void_p),
                       d.size, float(depth_scale), float(depth_max))
    return out


def write_ply_points_native(path: str, points: np.ndarray,
                            colors: Optional[np.ndarray] = None) -> bool:
    """Fast binary PLY write through the native codec; False on fallback."""
    lib = load_native()
    if lib is None:
        return False
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    rgb = None
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = np.clip(c * 255.0, 0, 255).astype(np.uint8)
        rgb = np.ascontiguousarray(c.reshape(-1, 3))
    n = lib.write_ply_points(
        path.encode(), pts.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p) if rgb is not None else None,
        len(pts))
    return n == len(pts)
