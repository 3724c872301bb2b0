"""Build, load and launch the CUDA kernels of csrc/field.cu.

The source is compiled at first use with nvcc for sm_90a into a shared
library with a plain C interface, under build/kernels/ at the root of the
checkout (listed in .gitignore), and loaded with ctypes. The library's
file name carries a hash of the source, so an edited source is rebuilt
and a stale library is never loaded. Nothing here runs at import time:
the CPU tests import this module on machines without nvcc or a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "field.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libcelo_field_{digest}.so"


def build() -> dict:
    """Compile csrc/field.cu unless the library for this source exists.

    Returns {"path", "seconds", "built", "ptxas"}: `ptxas` is the
    compiler's per-kernel register/spill report (empty when not built)."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False, "ptxas": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE.name}:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "built": True,
            "ptxas": proc.stderr}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        ptr = ctypes.c_void_p
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.celo_mont_mul.argtypes = [
            ctypes.c_int, u32p, i32p, ctypes.c_uint32,
            ptr, ptr, ptr, ctypes.c_int64, ptr,
        ]
        lib.celo_mont_mul.restype = ctypes.c_int
        lib.celo_mont_redc.argtypes = [
            ctypes.c_int, u32p, i32p, ctypes.c_uint32,
            ptr, ptr, ctypes.c_int64, ptr,
        ]
        lib.celo_mont_redc.restype = ctypes.c_int
        _lib = lib
    return _lib


class FieldConstants:
    """A field's constants as the C interface takes them (host arrays)."""

    def __init__(self, spec):
        self.n = spec.n
        self.p = (ctypes.c_uint32 * spec.n)(*[int(x) for x in spec.p_limbs])
        self.offset = (ctypes.c_int32 * spec.n)(
            *[int(x) for x in spec.offset_limbs]
        )
        self.n0inv = ctypes.c_uint32(int(spec.n0inv))


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch_mont_mul(consts: FieldConstants, a, b, out):
    """out = mont_mul(a, b) on the card; all [n, B] int32 contiguous."""
    err = library().celo_mont_mul(
        consts.n, consts.p, consts.offset, consts.n0inv,
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_int64(a.shape[1]),
        _stream(a),
    )
    _check(err, "mont_mul")


def launch_mont_redc(consts: FieldConstants, x, out):
    """out = mont_redc(x) on the card; both [n, B] int32 contiguous."""
    err = library().celo_mont_redc(
        consts.n, consts.p, consts.offset, consts.n0inv,
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int64(x.shape[1]), _stream(x),
    )
    _check(err, "mont_redc")
