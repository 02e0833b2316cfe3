"""Build and load the hand-written CUDA kernels (csrc/*.cu).

On first use each source is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface, which is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o      (one per source)
    nvcc -shared -o build/otslam_tpu_torch/<hash>/lib...so *.o

The library lands under ``build/`` at the root of the checkout, in a
directory named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.

``-fmad=false``: a fused multiply-add would round differently from the
plain PyTorch versions (flipping ``rint(u)`` at .5, the band comparisons,
a ray's cell and a nearest neighbour's d^2), and bit-identity with them is
the card check. It has a price: K3, K4 and K5 are bound by instruction
throughput and latency, not memory, and contraction would cut K3/K4's
arithmetic from 8 to 6 instructions a pair.

Every C entry point returns ``cudaGetLastError()`` after its launch;
`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "otslam_tpu_torch"
LIB_NAME = "libotslam_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    "otslam_classify": [_P, _P, _P, _P, _P,             # table gb ext band vis
                        _I, _I, _I, _I, _I, _I, _I, _I,  # n nb gby gbz th tw W H
                        _F, _F, _F, _F, _F, _F, _F, _F,  # ox oy oz vs half r rh sn
                        _F, _F, _F, _F, _F, _P],         # fx fy cx cy trunc stream
    "otslam_fuse": [_P, _P, _P, _P, _P, _P, _I,         # t w c ids ptr frames A
                    _P, _P, _P, _I, _I, _I, _I,         # depth cpk ext H W gby gbz
                    _F, _F, _F, _F, _F, _F, _F, _F,     # ox oy oz vs fx fy cx cy
                    _F, _F, _P],                        # trunc 1/trunc stream
    "otslam_nn": [_P, _P, _P, _I, _I, _I,               # src dst mask n m S
                  _P, _P, _P, _P],                      # bd bi parts stream
    "otslam_nn_window": [_P, _P, _P, _P, _P,            # src dst mask c0 c1
                         _I, _I, _I, _P, _P, _P, _P],   # n mp S bd bi parts
                                                        # stream
    "otslam_raycast": [_P, _I, _I, _P, _P, _P, _I, _I,  # grid H W cos sin xy B KB
                       _I, _F, _F, _F,                  # S res ox oy
                       _I, _I, _I,                      # lanes blocks threads
                       _P, _P, _P],                     # fs fo stream
}

_LIB: ctypes.CDLL | None = None
BUILD_LOG = {"seconds": None, "output": "", "path": None}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    return None


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use. Raises RuntimeError when
    nvcc is missing or the build fails; never returns a stub."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = BUILD_ROOT / _digest(srcs)
    lib_path = out_dir / LIB_NAME
    if not lib_path.is_file():
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (PATH, CUDA_HOME): the otslam_tpu_torch CUDA "
                "kernels are built from csrc/ on first use and need the CUDA "
                "toolkit; CPU tensors take the plain PyTorch path instead")
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs = [str(Path(tmp) / f"{s.stem}.o") for s in srcs]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s),
                                       "-o", o], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for s, o in zip(srcs, objs)]
            outs = [p.communicate()[0] for p in procs]
            BUILD_LOG["output"] = "".join(outs)
            failed = [s.name for s, p in zip(srcs, procs) if p.returncode]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n"
                                   f"{BUILD_LOG['output']}")
            tmp_lib = str(Path(tmp) / LIB_NAME)
            proc = subprocess.run([nvcc, "-shared", "-o", tmp_lib, *objs],
                                  capture_output=True, text=True)
            BUILD_LOG["output"] += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{BUILD_LOG['output']}")
            os.replace(tmp_lib, lib_path)  # atomic: no half-written library
        BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["path"] = str(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def check_operands(*tensors: torch.Tensor) -> None:
    """Kernel operands: contiguous CUDA tensors, all on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel operands must share one CUDA device: "
                             f"{t.device} vs {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream
