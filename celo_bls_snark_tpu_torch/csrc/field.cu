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
// the reference's mul_conv and a 16-bit-radix reduction's, so the same
// canonical limbs.
//
// mont_redc<N> replaces ops/field.py::_make_pallas_redc: the same offset
// and normalization, then REDC alone in the same words (redc_words of
// field_common.cuh: W - 1 rounds of 32 bits and one of 16, each t += m p,
// no a_i B row), (X + m p) / R with X = x + 256p and m = -X p^-1 mod R, the
// integer a 16-bit-radix REDC gives. This is the value model of the Pallas
// kernel; the JAX CPU path (mul_conv by a raw 1) may differ from it by
// exactly p, which no zero test can see.
//
// celo_mont_mul_shape runs mont_mul's own body at n = 25, compiled for and
// launched with 32 to 512 threads a block: the block-width sweep.
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
// SM (128 registers a thread at n = 49, no spill). mont_redc is launched
// the same way and holds x, the two arrays and t: 3 W + 2 words.
//
// What bounds them: per lane 2 W^2 word products for mont_mul and W^2 for
// mont_redc, 4 W^2 and 2 W^2 32-bit multiply instructions counted as a low
// and a high half each, against 12 n and 8 n bytes moved. At the card's
// rates (3.35 TB/s; 33.5e12 lane instructions/s) the bytes are the larger
// time at every n: 0.18 ns a lane against 0.075 ns for mont_mul at n = 49.
// The rounds are carry chains of IMAD.WIDE.U32.X (field_common.cuh): one
// instruction a word product, 872 instructions a lane at n = 25 (2,272 at
// n = 49) where the 16-bit form spends 5,528 and plain C on uint64_t spent
// 1,448 (a wide multiply-add and two to three carry adds a product).
// mont_redc takes 1,352 at n = 49 where 16-bit rows took 10,368 and were
// bound by them. At 2^20 lanes both kernels run at about 0.8 of the byte
// bound at n = 17, 25 and 49; at a few thousand lanes the time is one
// warp's chain, about 2.5 us (2.2 us for mont_redc). One lane a thread: two
// lanes a thread at n = 17 and 25 were tried and were slower at the small
// widths (half the warps) and no faster at the large ones.

#include "field_common.cuh"

namespace {

using celo::FieldConsts;
using celo::limb_of;
using celo::load_words;
using celo::mont_mul_words;
using celo::redc_words;
using celo::words_of;

constexpr int kThreads = 128;    // threads a block at full width
constexpr int kThreadsSmall = 32;  // below one warp per warp scheduler

// t holds the result times 2^16 in W words: its limbs 1..n are the result's
template <int N>
__device__ __forceinline__ void store_result(int32_t* __restrict__ out,
                                             int64_t lane, int64_t B,
                                             const uint32_t (&t)[words_of(N)]) {
#pragma unroll
    for (int k = 0; k < N; ++k)
        out[k * B + lane] = static_cast<int32_t>(limb_of<words_of(N)>(t, k + 1));
}

// the word-form multiply: see the header, and field_common.cuh for the
// rounds. THREADS and MIN_BLOCKS set the register budget ptxas works to
// (65,536 / (THREADS x MIN_BLOCKS), at most 255)
template <int N, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t B, FieldConsts c) {
    constexpr int W = words_of(N);
    const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    uint32_t aw[W], bw[W], t[W];
    load_words<N>(a, lane, B, c, aw);
    load_words<N>(b, lane, B, c, bw);
    mont_mul_words<W>(aw, bw, c, t);
    store_result<N>(out, lane, B, t);
}

// REDC in words: see the header, and field_common.cuh for the rounds
template <int N>
__global__ void __launch_bounds__(kThreads)
mont_redc_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 int64_t B, FieldConsts c) {
    constexpr int W = words_of(N);
    const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    uint32_t xw[W], t[W];
    load_words<N>(x, lane, B, c, xw);
    redc_words<W>(xw, c, t);
    store_result<N>(out, lane, B, t);
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

int threads_for(int64_t B) {
    return B <= one_warp_a_scheduler() ? kThreadsSmall : kThreads;
}

template <int N>
void launch_mul(const int32_t* a, const int32_t* b, int32_t* out, int64_t B,
                const FieldConsts& c, cudaStream_t s) {
    const int threads = threads_for(B);
    mont_mul_kernel<N, kThreads, 4><<<grid_for(B, threads), threads, 0, s>>>(a, b, out, B, c);
}

template <int N>
void launch_redc(const int32_t* x, int32_t* out, int64_t B,
                 const FieldConsts& c, cudaStream_t s) {
    const int threads = threads_for(B);
    mont_redc_kernel<N><<<grid_for(B, threads), threads, 0, s>>>(x, out, B, c);
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
    switch (n) {
        case 17: launch_redc<17>(x, out, B, *c, s); break;
        case 25: launch_redc<25>(x, out, B, *c, s); break;
        case 49: launch_redc<49>(x, out, B, *c, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// mont_mul's body at n = 25 with the block size chosen by the caller (32,
// 64, 128, 256 or 512 threads): replaces the block-width sweep kernel
// make_mul of the JAX package's scripts/prof_field.py, which sweeps the
// production multiply. Each block size is its own instantiation, built
// for 512 threads an SM (THREADS x MIN_BLOCKS = 512), so that every shape
// has mont_mul's budget of 128 registers and the sweep shows the block
// shape alone; the 128-thread shape is mont_mul's own instance. Bound by
// the bytes, as mont_mul is.
extern "C" int celo_mont_mul_shape(int n, const FieldConsts* c,
                                   const int32_t* a, const int32_t* b,
                                   int32_t* out, int64_t B, int threads,
                                   void* stream) {
    if (n != 25) return static_cast<int>(cudaErrorInvalidValue);
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned grid = grid_for(B, threads);
    switch (threads) {
        case 32: mont_mul_kernel<25, 32, 16><<<grid, 32, 0, s>>>(a, b, out, B, *c); break;
        case 64: mont_mul_kernel<25, 64, 8><<<grid, 64, 0, s>>>(a, b, out, B, *c); break;
        case 128: mont_mul_kernel<25, 128, 4><<<grid, 128, 0, s>>>(a, b, out, B, *c); break;
        case 256: mont_mul_kernel<25, 256, 2><<<grid, 256, 0, s>>>(a, b, out, B, *c); break;
        case 512: mont_mul_kernel<25, 512, 1><<<grid, 512, 0, s>>>(a, b, out, B, *c); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
