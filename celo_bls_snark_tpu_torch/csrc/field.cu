// Montgomery multiply and Montgomery reduction for the batched prime
// fields of ops/field.py, for Hopper (sm_90a).
//
// Data contract (the same as the JAX package's ops/field.py):
//   - a field batch is a row-major [n, B] int32 array: limb k of lane l at
//     k * B + l, 16-bit limbs, one guard limb, R = 2^(16 n);
//   - inputs are LAZY: signed limbs with |limb| < 2^26 and a value within
//     (-256 p, 256 p) (LAZY_P_BUDGET = 256);
//   - outputs are canonical 16-bit limbs of a value < 2p.
//
// mont_mul<N> replaces the Pallas kernel _make_pallas_mul of the JAX
// package's ops/field.py. Each operand gets the offset 256p added and is
// normalized to canonical limbs by one signed ripple; then a 16-bit-radix
// CIOS computes (A B + m p) / R with m = -A B p^-1 mod R. The 16-bit radix
// is kept on purpose: a 32-bit-word CIOS would divide by 2^(32 ceil(n/2)),
// which is not R when n is odd (2^416 != 2^400 for n = 25). The output is
// the same integer as the reference's mul_conv, so its canonical limbs are
// the same.
//
// mont_redc<N> replaces ops/field.py::_make_pallas_redc: the same offset
// and normalization, then REDC alone, (x + 256p + m p) / R. This is the
// value model of the Pallas kernel; the JAX CPU path (mul_conv by a raw 1)
// may differ from it by exactly p, which no zero test can see.
//
// Design. One thread per lane, all limbs in registers (for N = 25: a[25],
// b[25] and t[27] as uint32), every loop unrolled at compile time so that
// no array index is dynamic. Limb k of neighbouring lanes lies at
// neighbouring addresses, so each limb load and store is coalesced. The
// kernel masks the ragged edge itself: the caller pads nothing. The field
// constants (p, the offset 256p and n0inv = -p^-1 mod 2^16) come in as a
// kernel parameter, so one source serves every field.
//
// What bounds it: per lane about 2 n^2 32-bit multiplies and 4 n^2
// add/shift/mask operations (half of each for mont_redc) against 12 n
// bytes moved (8 n for mont_redc): at n = 25 that is 12.5 integer
// operations per byte, above the H100's 10 lane instructions per byte of
// HBM bandwidth, so it is bound by the integer pipes. This first
// version is simple and exact; making it fast (wide multiply-add chains,
// fewer mask/shift pairs, more lanes per thread) is later work.

#include "field_common.cuh"

namespace {

using celo::FieldConsts;
using celo::fill_consts;
using celo::kMask;
using celo::load_normalized;

constexpr int kThreads = 128;

// one CIOS reduction row: t += m p with m = t[0] n0inv mod 2^16, then
// t /= 2^16 (t[0] becomes divisible by 2^16; its high half moves to t[1])
template <int N>
__device__ __forceinline__ void reduce_row(uint32_t (&t)[N + 2],
                                           const FieldConsts& c) {
    const uint32_t m = (t[0] * c.n0inv) & kMask;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        const uint32_t prod = m * c.p[j];
        t[j] += prod & kMask;
        t[j + 1] += prod >> 16;
    }
    t[1] += t[0] >> 16;
#pragma unroll
    for (int j = 0; j < N + 1; ++j) t[j] = t[j + 1];
    t[N + 1] = 0;
}

// columns < 2^23 -> canonical limbs; the value is < 2p < R, so n limbs
template <int N>
__device__ __forceinline__ void store_carried(int32_t* __restrict__ out,
                                              int64_t lane, int64_t B,
                                              const uint32_t (&t)[N + 2]) {
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const uint32_t v = t[k] + carry;
        out[k * B + lane] = static_cast<int32_t>(v & kMask);
        carry = v >> 16;
    }
}

// THREADS is the block size the kernel is compiled for: the register
// budget ptxas works to follows from it (65,536 / THREADS, at most 255)
template <int N, int THREADS>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t B, FieldConsts c) {
    const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    uint32_t an[N], bn[N];
    load_normalized<N>(a, lane, B, c, an);
    load_normalized<N>(b, lane, B, c, bn);
    // column sums stay below 4 n 2^16 + carries < 2^23: no uint32 overflow
    uint32_t t[N + 2];
#pragma unroll
    for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const uint32_t ai = an[i];
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const uint32_t prod = ai * bn[j];
            t[j] += prod & kMask;
            t[j + 1] += prod >> 16;
        }
        reduce_row<N>(t, c);
    }
    store_carried<N>(out, lane, B, t);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
mont_redc_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 int64_t B, FieldConsts c) {
    const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    uint32_t xn[N];
    load_normalized<N>(x, lane, B, c, xn);
    uint32_t t[N + 2];
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = xn[j];
    t[N] = 0;
    t[N + 1] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) reduce_row<N>(t, c);
    store_carried<N>(out, lane, B, t);
}

unsigned grid_for(int64_t B, int threads = kThreads) {
    return static_cast<unsigned>((B + threads - 1) / threads);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each function launches on
// `stream`, does not synchronize, and returns cudaGetLastError() (0 when
// the launch was accepted). Pointers are device pointers to contiguous
// [n, B] int32 arrays; the field constants are host arrays of n entries.
extern "C" int celo_mont_mul(int n, const uint32_t* p, const int32_t* offset,
                             uint32_t n0inv, const int32_t* a,
                             const int32_t* b, int32_t* out, int64_t B,
                             void* stream) {
    FieldConsts c;
    int err = fill_consts(n, p, offset, n0inv, &c);
    if (err) return err;
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n) {
        case 17: mont_mul_kernel<17, kThreads><<<grid_for(B), kThreads, 0, s>>>(a, b, out, B, c); break;
        case 25: mont_mul_kernel<25, kThreads><<<grid_for(B), kThreads, 0, s>>>(a, b, out, B, c); break;
        case 49: mont_mul_kernel<49, kThreads><<<grid_for(B), kThreads, 0, s>>>(a, b, out, B, c); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int celo_mont_redc(int n, const uint32_t* p, const int32_t* offset,
                              uint32_t n0inv, const int32_t* x, int32_t* out,
                              int64_t B, void* stream) {
    FieldConsts c;
    int err = fill_consts(n, p, offset, n0inv, &c);
    if (err) return err;
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n) {
        case 17: mont_redc_kernel<17><<<grid_for(B), kThreads, 0, s>>>(x, out, B, c); break;
        case 25: mont_redc_kernel<25><<<grid_for(B), kThreads, 0, s>>>(x, out, B, c); break;
        case 49: mont_redc_kernel<49><<<grid_for(B), kThreads, 0, s>>>(x, out, B, c); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// mont_mul at n = 25 with the block size chosen by the caller (32, 64, 128,
// 256 or 512 threads): replaces the block-width sweep kernel make_mul of the
// JAX package's scripts/prof_field.py. Bound by the integer pipes like
// celo_mont_mul; each block size is its own instantiation, so the sweep
// shows what registers per thread and blocks per SM do to the same source.
extern "C" int celo_mont_mul_shape(int n, const uint32_t* p,
                                   const int32_t* offset, uint32_t n0inv,
                                   const int32_t* a, const int32_t* b,
                                   int32_t* out, int64_t B, int threads,
                                   void* stream) {
    FieldConsts c;
    int err = fill_consts(n, p, offset, n0inv, &c);
    if (err) return err;
    if (n != 25) return static_cast<int>(cudaErrorInvalidValue);
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned grid = grid_for(B, threads);
    switch (threads) {
        case 32: mont_mul_kernel<25, 32><<<grid, 32, 0, s>>>(a, b, out, B, c); break;
        case 64: mont_mul_kernel<25, 64><<<grid, 64, 0, s>>>(a, b, out, B, c); break;
        case 128: mont_mul_kernel<25, 128><<<grid, 128, 0, s>>>(a, b, out, B, c); break;
        case 256: mont_mul_kernel<25, 256><<<grid, 256, 0, s>>>(a, b, out, B, c); break;
        case 512: mont_mul_kernel<25, 512><<<grid, 512, 0, s>>>(a, b, out, B, c); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
