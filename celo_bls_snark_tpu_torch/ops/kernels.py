"""Build, load and launch the CUDA kernels of csrc/.

Every .cu under csrc/ is compiled at first use with nvcc for sm_90a (one
nvcc per source, all started together) and linked into one shared library
with a plain C interface, under build/kernels/ at the root of the checkout
(listed in .gitignore), and loaded with ctypes. The library's file name
carries a hash of all sources, so an edited source is rebuilt and a stale
library is never loaded. Nothing here runs at import time: the CPU tests
import this module on machines without nvcc or a card.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SHAPE_THREADS = (32, 64, 128, 256, 512)  # block sizes of celo_mont_mul_shape

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


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):  # the .cuh headers too
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libcelo_field_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile csrc/*.cu unless the library for these sources exists.

    Returns {"path", "seconds", "built", "ptxas"}: `ptxas` is the
    compiler's per-kernel register/spill report, kept beside the library."""
    out = library_path()
    report = out.with_suffix(".ptxas.txt")
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False,
                "ptxas": report.read_text() if report.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src, obj in zip(sources(), objs)
    ]
    logs = [proc.communicate()[1] for proc in procs]
    for src, proc, log in zip(sources(), procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {src.name}:\n{log}"
            )
    tmp = BUILD_DIR / f"{tag}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    for obj in objs:
        obj.unlink()
    report.write_text("".join(logs))
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "built": True, "ptxas": "".join(logs)}


def _kernel_name(mangled: str):
    """`mont_mul_kernel<25,128,4>` from a mangled entry name (template
    arguments read off it), or None for another function: the mont_*
    kernels, f12_cyclo_sq_kernel and f12_mul_kernel."""
    k = re.search(r"\d+((?:mont_\w+?|f12_cyclo_sq|f12_mul)_kernel)I((?:Li\d+E)+)E", mangled)
    if k is None:
        return None
    return f"{k.group(1)}<{','.join(re.findall(r'Li(\d+)E', k.group(2)))}>"


def sass(path=None):
    """The SASS of a built library (cuobjdump -sass; by default the
    library of csrc/), or None where the toolkit has no cuobjdump."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    proc = subprocess.run([str(tool), "-sass", str(path or build()["path"])],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed:\n{proc.stderr}")
    return proc.stdout


def sass_count(mnemonic: str, text=None):
    """How many SASS instructions of `text` (by default the built
    library's) start with `mnemonic`, or None without cuobjdump."""
    text = sass() if text is None else text
    if text is None:
        return None
    return len(re.findall(rf"\b{re.escape(mnemonic)}[.\w]*\s", text))


def sass_histogram(text: str) -> dict:
    """{kernel: {"instructions": n, "top": [(mnemonic, count), ...]}} for
    the kernels _kernel_name names in a SASS dump, named as by
    ptxas_report."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = _kernel_name(m.group(1))
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)?)", ln)
        if m and name:
            out.setdefault(name, {})
            out[name][m.group(1)] = out[name].get(m.group(1), 0) + 1
    return {k: {"instructions": sum(h.values()),
                "top": sorted(h.items(), key=lambda kv: -kv[1])[:8]}
            for k, h in out.items()}


def ptxas_report(text: str) -> dict:
    """`ptxas -v` output -> {kernel: {"registers", "stack", "spill_stores",
    "spill_loads", "smem"}}, the kernel named as `mont_mul_kernel<25,128,4>`."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = _kernel_name(m.group(1)) or m.group(1)
            out[name] = {}
        elif name and "spill stores" in ln:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", ln)
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and "Used" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem"] = int(m.group(1)) if m else 0
    return out


def use_library(path=None) -> ctypes.CDLL:
    """Load the kernel library at `path` and make it the one the launch
    functions call (scripts/prof_variants.py times variants so); None
    builds and loads the library of csrc/."""
    global _lib
    _lib = None
    if path is not None:
        _lib = _bind(ctypes.CDLL(str(path)))
    return library()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(build()["path"]))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument and result types."""
    ptr = ctypes.c_void_p
    consts = [ctypes.c_int, ctypes.POINTER(FieldConsts)]
    lib.celo_mont_mul.argtypes = [*consts, ptr, ptr, ptr, ctypes.c_int64, ptr]
    lib.celo_mont_mul_shape.argtypes = [
        *consts, ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int, ptr,
    ]
    lib.celo_mont_mul_tc.argtypes = [
        *consts, ptr, ptr, ptr, ctypes.c_int64, ptr, ptr, ptr,
    ]
    lib.celo_mont_redc.argtypes = [*consts, ptr, ptr, ctypes.c_int64, ptr]
    lib.celo_mont_mul_tc_occupancy.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.celo_f12_cyclo_sq.argtypes = [
        *consts, ptr, ptr, ptr, ptr, ptr, ctypes.c_int64, ptr,
    ]
    lib.celo_f12_mul.argtypes = [
        *consts, ctypes.c_int, ptr, ptr, ptr, ptr, ctypes.c_int64, ptr,
    ]
    for fn in (lib.celo_mont_mul, lib.celo_mont_mul_shape,
               lib.celo_mont_mul_tc, lib.celo_mont_redc,
               lib.celo_mont_mul_tc_occupancy, lib.celo_f12_cyclo_sq,
               lib.celo_f12_mul):
        fn.restype = ctypes.c_int
    return lib


MAX_LIMBS = 49  # kMaxLimbs of csrc/field_common.cuh
MAX_WORDS = (MAX_LIMBS + 1) // 2


class FieldConsts(ctypes.Structure):
    """celo::FieldConsts of csrc/field_common.cuh, field for field."""

    _fields_ = [
        ("pw", ctypes.c_uint32 * MAX_WORDS),
        ("offset", ctypes.c_int32 * MAX_LIMBS),
        ("n0inv32", ctypes.c_uint32),
    ]


class FieldConstants:
    """A field's constants as the C interface takes them: the limb count
    and a host FieldConsts: 256p in 16-bit limbs (the load's offset), p in
    32-bit words (the top word 0: the guard limb) and n0inv32 = -p^-1 mod
    2^32."""

    def __init__(self, spec):
        n, words = spec.n, spec.p_words
        if n % 2 == 0 or n > MAX_LIMBS or int(words[-1]) != 0:
            raise ValueError(
                f"{spec.name}: the kernels take an odd limb count up to "
                f"{MAX_LIMBS} and a modulus below 2^(16 (n - 1))"
            )
        self.n = n
        c = self.consts = FieldConsts()
        for k in range(n):
            c.offset[k] = int(spec.offset_limbs[k])
        for j, w in enumerate(words):
            c.pw[j] = int(w)
        c.n0inv32 = int(spec.n0inv32)

    @property
    def args(self):
        return self.n, ctypes.byref(self.consts)


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch_mont_mul(consts: FieldConstants, a, b, out):
    """out = mont_mul(a, b) on the card; all [n, B] int32 contiguous."""
    err = library().celo_mont_mul(
        *consts.args, _ptr(a), _ptr(b), _ptr(out), ctypes.c_int64(a.shape[1]),
        _stream(a),
    )
    _check(err, "mont_mul")


def launch_mont_mul_shape(consts: FieldConstants, a, b, out, threads: int):
    """mont_mul's kernel at n = 25 with `threads` threads a block
    (SHAPE_THREADS)."""
    err = library().celo_mont_mul_shape(
        *consts.args, _ptr(a), _ptr(b), _ptr(out), ctypes.c_int64(a.shape[1]),
        ctypes.c_int(threads), _stream(a),
    )
    _check(err, f"mont_mul_shape[{threads}]")


def launch_mont_mul_tc(consts: FieldConstants, a, b, out, w1, w2):
    """out = mont_mul_tc(a, b) on the card; w1, w2: the field's padded u8
    weight matrices on the same card."""
    err = library().celo_mont_mul_tc(
        *consts.args, _ptr(a), _ptr(b), _ptr(out), ctypes.c_int64(a.shape[1]),
        _ptr(w1), _ptr(w2), _stream(a),
    )
    _check(err, "mont_mul_tc")


def tc_occupancy(n: int) -> dict:
    """What the CUDA runtime reports for mont_mul_tc at n limbs on the
    current card: {"blocks_per_sm", "smem_bytes"} (blocks of 128 threads
    that share an SM; a block's dynamic shared memory)."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = library().celo_mont_mul_tc_occupancy(
        ctypes.c_int(n), ctypes.byref(blocks), ctypes.byref(smem))
    _check(err, f"mont_mul_tc_occupancy[{n}]")
    return {"blocks_per_sm": blocks.value, "smem_bytes": smem.value}


def launch_f12_cyclo_sq(consts: FieldConstants, coeffs, one, out):
    """out = the cyclotomic squaring of the Fq12 batch whose 12 coefficients
    are `coeffs` ([n, B] int32 on the card, any strides: read where they
    lie); `one`: the field's Montgomery one as a host ctypes int32 array of
    n limbs; out: a contiguous [12, n, B] int32 tensor on the same card."""
    ptrs = (ctypes.c_void_p * 12)(*(x.data_ptr() for x in coeffs))
    rows = (ctypes.c_int64 * 12)(*(x.stride(0) for x in coeffs))
    cols = (ctypes.c_int64 * 12)(*(x.stride(1) for x in coeffs))
    err = library().celo_f12_cyclo_sq(
        *consts.args, ptrs, rows, cols, one, _ptr(out),
        ctypes.c_int64(out.shape[2]), _stream(out),
    )
    _check(err, "f12_cyclo_sq")


def launch_f12_mul(consts: FieldConstants, operands, out):
    """out = the Fq12 product of the batches whose 12 coefficients each are
    `operands` (one list of 12 [n, B] int32 tensors on the card for a
    square, two for a product; any strides: read where they lie); out: a
    contiguous [12, n, B] int32 tensor on the same card."""
    coeffs = [x for side in operands for x in side]
    k = len(coeffs)
    ptrs = (ctypes.c_void_p * k)(*(x.data_ptr() for x in coeffs))
    rows = (ctypes.c_int64 * k)(*(x.stride(0) for x in coeffs))
    cols = (ctypes.c_int64 * k)(*(x.stride(1) for x in coeffs))
    err = library().celo_f12_mul(
        *consts.args, ctypes.c_int(len(operands)), ptrs, rows, cols, _ptr(out),
        ctypes.c_int64(out.shape[2]), _stream(out),
    )
    _check(err, "f12_mul")


def launch_mont_redc(consts: FieldConstants, x, out):
    """out = mont_redc(x) on the card; both [n, B] int32 contiguous."""
    err = library().celo_mont_redc(
        *consts.args, _ptr(x), _ptr(out), ctypes.c_int64(x.shape[1]), _stream(x),
    )
    _check(err, "mont_redc")
