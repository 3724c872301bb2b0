"""Design variants of mont_mul, mont_redc and mont_mul_tc, built and timed
beside the shipped sources in one run on the card.

Each variant is a copy of csrc/ with one textual edit, compiled with the
flags of ops/kernels.py into build/variants/<name>/ (one thread per
variant). Per variant it prints the registers and spill bytes ptxas
reports, mont_mul_tc's blocks an SM and shared memory as the runtime
reports them, whether the output still equals the 16-bit-radix plain
versions (where the variant computes the function), and the card's time per
launch from a replayed CUDA graph: the multiplies at MUL_SHAPES and
TC_SHAPES, mont_redc at MUL_SHAPES. The shipped sources are timed first and
last, so drift over the run shows. It ends with the instruction counts of
the shipped kernels (cuobjdump -sass).

Variants:
  mul_bounds_none / _3 / _5  mont_mul built for 1 (no register cap below
                             255), 3 or 5 blocks of 128 threads an SM
                             (shipped: 4)
  mul_two_lanes              mont_mul with two lanes a thread at n = 17, 25,
                             their rounds interleaved
  redc_blocks_128            mont_redc in blocks of 128 threads at every
                             width (shipped: one warp a block up to one warp
                             a warp scheduler)
  tc_blocks_4                mont_mul_tc<49> built for 4 blocks an SM
                             (shipped: 3)
  tc_no_matrix               mont_mul_tc with both matrix products skipped:
                             what is left is loads, phase A, the hand-over
                             and the ripples (not the function)
  tc_no_product              mont_mul_tc with phase A's word product skipped
                             (not the function)
The last two split mont_mul_tc's time into its CUDA-core and tensor-core
parts: shipped - tc_no_matrix is what the matrix products cost.

Usage: python -m celo_bls_snark_tpu_torch.scripts.prof_variants [name ...]
"""

import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import field as F
from ..ops import kernels
from ..utils.devices import require_device
from ..utils.profiling import time_ms

ROOT = kernels.BUILD_DIR.parent / "variants"
SPECS = {17: F.FR, 25: F.FQ, 49: F.FQ761}
MUL_SHAPES = [(25, 2), (25, 12288), (25, 1 << 20), (17, 1 << 19),
              (49, 6 << 15), (49, 1 << 20)]
TC_SHAPES = [(25, 1 << 20), (17, 1 << 19), (49, 6 << 15), (49, 1 << 20)]

TWO_LANES = '''
template <int N, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t B, FieldConsts c) {
    constexpr int W = words_of(N);
    constexpr int LPT = N <= 25 ? 2 : 1;
    const int64_t first =
        static_cast<int64_t>(blockIdx.x) * (blockDim.x * LPT) + threadIdx.x;
    if (first >= B) return;
    uint32_t aw[LPT][W], bw[LPT][W], x[LPT][W + 1], y[LPT][W + 1];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
        const int64_t lane = first + l * blockDim.x;
        const int64_t src = lane < B ? lane : first;
        load_words<N>(a, src, B, c, aw[l]);
        load_words<N>(b, src, B, c, bw[l]);
    }
#pragma unroll
    for (int i = 0; i < W - 1; ++i)
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
            if (i & 1) celo::mont_round<W, false>(y[l], x[l], aw[l][i], bw[l], c, false);
            else celo::mont_round<W, false>(x[l], y[l], aw[l][i], bw[l], c, i == 0);
        }
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
        uint32_t t[W];
        celo::mont_round<W, true>(x[l], y[l], aw[l][W - 1], bw[l], c, false);
        celo::join_words<W>(x[l], y[l], t);
        const int64_t lane = first + l * blockDim.x;
        if (lane < B) {
#pragma unroll
            for (int k = 0; k < N; ++k)
                out[k * B + lane] = static_cast<int32_t>(limb_of<W>(t, k + 1));
        }
    }
}

'''


def _replace(old, new):
    def edit(text):
        if old not in text:
            raise ValueError(f"the source no longer holds {old!r}")
        return text.replace(old, new)
    return edit


MUL_LAUNCH = "mont_mul_kernel<N, kThreads, 4><<<grid_for(B, threads)"


def _two_lanes(text):
    i = text.index("// the word-form multiply: see the header")
    j = text.index("// REDC in words: see the header")
    text = text[:i] + TWO_LANES + text[j:]
    return _replace(MUL_LAUNCH, MUL_LAUNCH.replace(
        "threads)", "threads * (N <= 25 ? 2 : 1))"))(text)


def _bounds(blocks):
    return _replace(MUL_LAUNCH, MUL_LAUNCH.replace(", 4>", f", {blocks}>"))


def _no_matrix(text):
    for w in ("w1", "w2"):
        call = f"tile_product<S::KP, S::K, S::PS>({w},"
        text = _replace(call, "if (B < 0) " + call)(text)
    return text


# name -> ({file: edit}, which kernels to time, output still the function)
VARIANTS = {
    "shipped": ({}, ("mul", "redc", "tc"), True),
    "mul_bounds_none": ({"field.cu": _bounds(1)}, ("mul",), True),
    "mul_bounds_3": ({"field.cu": _bounds(3)}, ("mul",), True),
    "mul_bounds_5": ({"field.cu": _bounds(5)}, ("mul",), True),
    "mul_two_lanes": ({"field.cu": _two_lanes}, ("mul",), True),
    "redc_blocks_128": ({"field.cu": _replace(
        "const int threads = threads_for(B);\n    mont_redc_kernel",
        "const int threads = kThreads;\n    mont_redc_kernel")}, ("redc",), True),
    "tc_blocks_4": ({"field_tc.cu": _replace("min_of(N > 25 ? 3 : 4,", "min_of(4,")},
                    ("tc",), True),
    "tc_no_matrix": ({"field_tc.cu": _no_matrix}, ("tc",), False),
    "tc_no_product": ({"field_tc.cu": _replace(
        "mul_full_words<W>(aw, bw, t);",
        "for (int j = 0; j < W; ++j) { t[j] = aw[j]; t[j + W] = bw[j]; }\n"
        "            if (B < 0) mul_full_words<W>(aw, bw, t);")}, ("tc",), False),
}


def lazy_batch(spec, B, gen):
    """Random lazy [n, B] int32 limbs: a value below p plus s p, s in
    [-255, 255], re-split with random signed carries (value kept)."""
    n, dev = spec.n, gen.device
    lo = torch.randint(0, 1 << 16, (n, B), generator=gen, device=dev)
    lo[n - 2:] = 0
    s = torch.randint(-255, 256, (1, B), generator=gen, device=dev)
    limbs = lo + s * spec.column(spec.p_limbs, dev, torch.int64)
    d = torch.randint(-512, 512, (n - 1, B), generator=gen, device=dev)
    limbs[:-1] += d << 16
    limbs[1:] -= d
    return limbs.to(torch.int32).contiguous()


def build_variant(name):
    """Copy csrc/ with the variant's edits and compile it; returns
    (library path or None, compiler output)."""
    d = ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in kernels.CSRC.glob("*.cu*"):
        edit = VARIANTS[name][0].get(f.name)
        (d / f.name).write_text(edit(f.read_text()) if edit else f.read_text())
    nvcc, logs, objs = kernels._nvcc(), [], []
    for src in sorted(d.glob("*.cu")):
        objs.append(d / (src.stem + ".o"))
        proc = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(objs[-1]), str(src)],
                              capture_output=True, text=True)
        logs.append(proc.stderr)
        if proc.returncode != 0:
            return None, proc.stderr
    out = d / "libvariant.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(out), *map(str, objs)],
                          capture_output=True, text=True)
    return (out, "".join(logs)) if link.returncode == 0 else (None, link.stderr)


def measure(name, built, inputs, want):
    """Load the variant's library in place of the shipped one and time it."""
    path, log = built
    kernels.use_library(path)
    _, which, is_function = VARIANTS[name]
    regs = kernels.ptxas_report(log)
    res = {"variant": name,
           "registers_spill_stores_loads": {
               k: (v["registers"], v["spill_stores"], v["spill_loads"])
               for k, v in regs.items() if k.startswith("mont_")},
           "tc_occupancy": {n: kernels.tc_occupancy(n) for n in SPECS}}
    kerns = (("mul", F.mont_mul, MUL_SHAPES), ("redc", F.mont_redc, MUL_SHAPES),
             ("tc", F.mont_mul_tc, TC_SHAPES))
    for tag, kern, shapes in kerns:
        if tag not in which:
            continue
        for n, B in shapes:
            args = inputs[(n, B)][:1] if tag == "redc" else inputs[(n, B)]
            got = kern(SPECS[n], *args)
            torch.cuda.synchronize()
            if is_function and (tag, n, B) in want:
                res[f"{tag}_exact_{n}_{B}"] = bool(torch.equal(got, want[(tag, n, B)]))
            ms = time_ms(lambda: kern(SPECS[n], *args), 200 if B < 100000 else 30, graph=True)
            res[f"{tag}_ms_{n}_{B}"] = ms
    return res


def main():
    names = sys.argv[1:] or list(VARIANTS)
    device = require_device("cuda")
    with ThreadPoolExecutor(4) as pool:
        built = dict(zip(names, pool.map(build_variant, names)))
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    inputs = {(n, B): (lazy_batch(SPECS[n], B, gen), lazy_batch(SPECS[n], B, gen))
              for n, B in set(MUL_SHAPES + TC_SHAPES)}
    small = {k: v for k, v in inputs.items() if k[1] <= 6 << 15}
    want = {("mul", *k): F._mul_plain(SPECS[k[0]], *v) for k, v in small.items()}
    want.update({("tc", *k): w for (_, *k), w in want.items()})
    want.update({("redc", *k): F._redc_plain(SPECS[k[0]], v[0])
                 for k, v in small.items()})
    order = names + (["shipped"] if "shipped" in names and len(names) > 1 else [])
    ok = True
    for name in order:
        if built[name][0] is None:
            print(json.dumps({"variant": name, "build_failed": built[name][1][-2000:]}))
            ok = False
            continue
        res = measure(name, built[name], inputs, want)
        print(json.dumps(res), flush=True)
        ok &= all(v for k, v in res.items() if "_exact_" in k)
    kernels.use_library(None)  # back to the shipped library
    text = kernels.sass()
    if text:
        print(json.dumps({"sass_of_shipped": kernels.sass_histogram(text)}), flush=True)
    if not ok:
        raise SystemExit("a variant failed to build or is not exact")
    print("DONE")


if __name__ == "__main__":
    main()
