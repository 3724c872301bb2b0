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
// normalized by one signed ripple as it is loaded, packed two limbs to a
// 32-bit word; the mixed-radix interleaved Montgomery rounds of
// field_common.cuh (W - 1 rounds of 32 bits and one of 16, W = ceil(n / 2))
// then give (A B + m p) / R with m = -A B p^-1 mod R, the same integer as
// the reference's mul_conv and the 16-bit-radix kernel's, so the same
// canonical limbs.
//
// mont_redc<N> replaces ops/field.py::_make_pallas_redc: the same offset
// and normalization, then REDC alone in 16-bit radix, (x + 256p + m p) / R.
// This is the value model of the Pallas kernel; the JAX CPU path (mul_conv
// by a raw 1) may differ from it by exactly p, which no zero test can see.
//
// mont_mul16<N, THREADS> is the 16-bit-radix CIOS multiply that mont_mul
// was before the word form. It stays as the body of celo_mont_mul_shape
// (the block-width sweep) and so gives the old design's time beside the new
// one's, in the same run on the same card.
//
// Design of mont_mul. One thread per lane, a, b and the running sum t as W
// words in registers (a, b and the two arrays of the running sum, 4 W + 2
// words: 102 at n = 49, where the 16-bit form held 3 n + 2 = 149), every
// loop unrolled so that no array index is dynamic and a round renames
// registers instead of shifting them. Limb k of
// neighbouring lanes lies at neighbouring addresses, so each limb load and
// store is coalesced; each operand byte is read once, straight into
// registers, so shared memory and TMA have nothing to give here. The kernel
// masks the ragged edge itself: the caller pads nothing. The field
// constants come in as a kernel parameter, so one source serves every
// field. Below one warp per warp scheduler (B <= 32 x 4 x the SM count) the
// time is the latency of one thread's chain, and blocks of one warp spread
// the lanes over all schedulers; above it blocks of 128 threads, four to an
// SM (128 registers a thread at n = 49, no spill).
//
// What bounds it: per lane 2 W^2 word products, 4 W^2 32-bit multiply
// instructions counted as a low and a high half each (half of that for
// mont_redc's work), against 12 n bytes moved (8 n for mont_redc). At the
// card's rates (3.35 TB/s; 33.5e12 lane instructions/s) the bytes are the
// larger time at every n: 0.18 ns a lane against 0.075 ns at n = 49. The
// rounds are carry chains of IMAD.WIDE.U32.X (field_common.cuh): one
// instruction a word product, 872 instructions a lane at n = 25 (2,272 at
// n = 49) where the 16-bit form spends 5,528 and plain C on uint64_t spent
// 1,448 (a wide multiply-add and two to three carry adds a product). At
// 2^20 lanes it runs at 0.8 of the byte bound at n = 17, 25 and 49; at a few
// thousand lanes the time is one warp's chain, about 2.5 us. One lane a
// thread: two lanes a thread at n = 17 and 25 were tried and were slower at
// the small widths (half the warps) and no faster at the large ones.

#include "field_common.cuh"

namespace {

using celo::FieldConsts;
using celo::kMask;
using celo::limb_of;
using celo::load_normalized;
using celo::load_words;
using celo::mont_mul_words;
using celo::words_of;

constexpr int kThreads = 128;    // threads a block at full width
constexpr int kThreadsSmall = 32;  // below one warp per warp scheduler

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

// the word-form multiply: see the header, and field_common.cuh for the rounds
template <int N>
__global__ void __launch_bounds__(kThreads, 4)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t B, FieldConsts c) {
    constexpr int W = words_of(N);
    const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    uint32_t aw[W], bw[W], t[W];
    load_words<N>(a, lane, B, c, aw);
    load_words<N>(b, lane, B, c, bw);
    mont_mul_words<W>(aw, bw, c, t);
    // t holds the product times 2^16: its limbs 1..n are the result's
#pragma unroll
    for (int k = 0; k < N; ++k)
        out[k * B + lane] = static_cast<int32_t>(limb_of<W>(t, k + 1));
}

// The 16-bit-radix CIOS multiply. THREADS is the block size the kernel is
// compiled for: the register budget ptxas works to follows from it
// (65,536 / THREADS, at most 255)
template <int N, int THREADS>
__global__ void __launch_bounds__(THREADS)
mont_mul16_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
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

unsigned grid_for(int64_t B, int threads) {
    return static_cast<unsigned>((B + threads - 1) / threads);
}

// lanes up to which every warp can have a warp scheduler of its own
// (4 an SM); 0 until the first call asks the device
int64_t one_warp_a_scheduler() {
    static int64_t lanes = 0;
    if (lanes == 0) {
        int dev = 0, sms = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            return 0;
        lanes = static_cast<int64_t>(sms) * 4 * 32;
    }
    return lanes;
}

template <int N>
void launch_mul(const int32_t* a, const int32_t* b, int32_t* out, int64_t B,
                const FieldConsts& c, cudaStream_t s) {
    const int threads = B <= one_warp_a_scheduler() ? kThreadsSmall : kThreads;
    mont_mul_kernel<N><<<grid_for(B, threads), threads, 0, s>>>(a, b, out, B, c);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each function launches on
// `stream`, does not synchronize, and returns cudaGetLastError() (0 when
// the launch was accepted). Pointers are device pointers to contiguous
// [n, B] int32 arrays; `c` is a host pointer to the field's constants, laid
// out as celo::FieldConsts (ops/kernels.py builds it from the field's spec).
extern "C" int celo_mont_mul(int n, const FieldConsts* c, const int32_t* a,
                             const int32_t* b, int32_t* out, int64_t B,
                             void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n) {
        case 17: launch_mul<17>(a, b, out, B, *c, s); break;
        case 25: launch_mul<25>(a, b, out, B, *c, s); break;
        case 49: launch_mul<49>(a, b, out, B, *c, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int celo_mont_redc(int n, const FieldConsts* c, const int32_t* x,
                              int32_t* out, int64_t B, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned grid = grid_for(B, kThreads);
    switch (n) {
        case 17: mont_redc_kernel<17><<<grid, kThreads, 0, s>>>(x, out, B, *c); break;
        case 25: mont_redc_kernel<25><<<grid, kThreads, 0, s>>>(x, out, B, *c); break;
        case 49: mont_redc_kernel<49><<<grid, kThreads, 0, s>>>(x, out, B, *c); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// The 16-bit-radix multiply at n = 25 with the block size chosen by the
// caller (32, 64, 128, 256 or 512 threads): replaces the block-width sweep
// kernel make_mul of the JAX package's scripts/prof_field.py. It is bound
// by the bytes like celo_mont_mul and runs far above that bound, on about
// 10 n^2 integer instructions a lane; each block size is its own
// instantiation, so the sweep shows what registers per thread and blocks
// per SM do to the same source.
extern "C" int celo_mont_mul_shape(int n, const FieldConsts* c,
                                   const int32_t* a, const int32_t* b,
                                   int32_t* out, int64_t B, int threads,
                                   void* stream) {
    if (n != 25) return static_cast<int>(cudaErrorInvalidValue);
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned grid = grid_for(B, threads);
    switch (threads) {
        case 32: mont_mul16_kernel<25, 32><<<grid, 32, 0, s>>>(a, b, out, B, *c); break;
        case 64: mont_mul16_kernel<25, 64><<<grid, 64, 0, s>>>(a, b, out, B, *c); break;
        case 128: mont_mul16_kernel<25, 128><<<grid, 128, 0, s>>>(a, b, out, B, *c); break;
        case 256: mont_mul16_kernel<25, 256><<<grid, 256, 0, s>>>(a, b, out, B, *c); break;
        case 512: mont_mul16_kernel<25, 512><<<grid, 512, 0, s>>>(a, b, out, B, *c); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
