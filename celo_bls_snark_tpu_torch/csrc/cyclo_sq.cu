// The cyclotomic squaring of a batch of Fq12 elements (BLS12-377, n = 25
// limbs a coefficient) as one kernel, for Hopper (sm_90a):
// f12_cyclo_sq_kernel<N, L>.
//
// It replaces no TPU kernel. The JAX package and ops/tower.py compute the
// squaring as a composition: one 30-wide mont_mul launch between some 116
// elementwise int32 ops and two concatenations, 119 launches in all. The
// final exponentiation runs 316 of them in a row (five chains of 63
// squarings in f12_powx and one for m^3), about 37,600 graph nodes a call,
// each costing a node's 1-3 us on the card whatever its width. This kernel
// is one launch a squaring and computes the same limbs: csrc/cyclo_sq.cuh
// holds the per-lane arithmetic, csrc/cyclo_sq_host_check.cpp runs it on
// the host against the composition.
//
// What bounds it. Per lane 30 Montgomery products, 30 x 4 W^2 = 20,280
// 32-bit multiply instructions (W = 13 words), against 12 x 25 x 4 bytes in
// and out, 2,400 bytes: at the card's rates (33.5e12 lane instructions/s,
// 3.35 TB/s) 0.61 ns a lane of multiplies against 0.72 ns of bytes, so the
// bytes bound it, barely. Up to a few thousand lanes neither does: a launch
// costs the latency of its dependent chain, load, one multiply, combine,
// store. The composition's chain is 119 launches long; the kernel's is one
// multiply's latency (about 2.5 us at small widths, field.cu's header) plus
// its loads and stores.
//
// Design. A block holds L lanes (lane on threadIdx.x, the fast axis) and 32
// threads a lane (threadIdx.y); L is a template argument, so that every
// shared-memory address is a base and a constant. Phase 0: 75 tasks a
// lane, one (squaring, limb) pair each, spread over the 32 threads: a task
// loads limb k of its squaring's four input coefficients (a thread issues
// all its loads before it uses one) and writes limb k of the squaring's 12
// operand rows to shared memory (cyclo_rows: the inputs and the eight sums
// the composition pre-adds), so that each operand is one row and is summed
// once, not once a product. The inputs are read where they lie, as a row
// stride and a lane stride each: they are often slices of the previous
// squaring's output or of a wider product, and a copy to make them
// contiguous would be a launch of its own; a row's L lanes are neighbouring
// addresses, so the loads coalesce (L = 8: one 32-byte sector). Phase 1:
// thread y < 30 of a lane loads product y's two rows and multiplies them
// (load_words and mont_mul_words, as mont_mul: the same integer, the same
// limbs), and stores the product's words to shared memory. Phase 2: the
// same 75 tasks form limb k of the squaring's output coefficients and write
// them to the [12, n, B] output, coalesced as the loads are. Two
// __syncthreads, no atomics. Shared memory: 37 rows of n limbs and 30
// products of W words a lane, 5,260 bytes (42,080 at L = 8).
//
// L comes from B alone, as field.cu's threads_for chooses mont_mul's
// block: a lane is a warp of its own while every warp can have a warp
// scheduler to itself (B up to 4 x the SM count), so that the lanes spread
// over the SMs; above that eight lanes a block (256 threads), for whole
// sectors. 64 registers a thread, no spill (ptxas, sm_90a).
//
// Measured (chip_smoke's cyclo_sq line, H100 80GB HBM3 at 700 W, a launch
// from a replayed graph): 3.7 us at 1 lane, 5.9 us at 300, 16.8 us at
// 6,000, 160 us at 2^16 (the bytes' bound 47 us); the composition it
// replaces took 128, 183, 278 and 1,208 us on the same inputs. Up to a few
// thousand lanes the time is the chain's latency; at 2^16 it is the wide
// multiplies' issue rate, which the bound's FP32 lane rate overstates.

#include "cyclo_sq.cuh"

namespace {

using celo::CycloRows;
using celo::FieldConsts;
using celo::LaneProducts;
using celo::kCycloLeaves;
using celo::kCycloOne;
using celo::kCycloProducts;
using celo::kCycloRows;
using celo::kCycloRowsPerSq;
using celo::kMaxLimbs;
using celo::words_of;

constexpr int kThreadsPerLane = 32;
constexpr int kLanesWide = 8;

// where the 12 input coefficients lie: limb k of lane l of leaf i at
// p[i][k * row[i] + l * col[i]]; and the constant one's limbs
struct Fq12In {
    const int32_t* p[kCycloLeaves];
    int64_t row[kCycloLeaves];
    int64_t col[kCycloLeaves];
    int32_t one[kMaxLimbs];
};

// L lanes a block, 32 threads a lane. Built for 16 blocks of one lane or
// 3 blocks of eight lanes an SM (128 and 85 registers a thread at most)
template <int N, int L>
__global__ void __launch_bounds__(kThreadsPerLane * L, L == 1 ? 16 : 3)
f12_cyclo_sq_kernel(Fq12In in, int32_t* __restrict__ out, int64_t B, FieldConsts c) {
    constexpr int W = words_of(N);
    constexpr int kTasks = 3 * N;  // (squaring, limb) pairs a lane
    constexpr int kRounds = (kTasks + kThreadsPerLane - 1) / kThreadsPerLane;
    __shared__ int32_t rows[kCycloRows * N * L];          // [37][N][L]
    __shared__ uint32_t prods[kCycloProducts * W * L];    // [30][W][L]
    const int x = threadIdx.x, y = threadIdx.y;
    const int64_t lane = static_cast<int64_t>(blockIdx.x) * L + x;
    const bool live = lane < B;

    // phase 0: each (squaring, limb) task loads its four input limbs (all
    // loads of a thread issued before any is used) and writes the
    // squaring's 12 operand rows at that limb
    int32_t v4[kRounds][4];
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
        const int task = y + kThreadsPerLane * i, g = task / N, k = task % N;
        int leaf[4];
        celo::cyclo_inputs(g < 3 ? g : 0, leaf);  // a task past the last loads nothing
#pragma unroll
        for (int u = 0; u < 4; ++u)
            v4[i][u] = live && task < kTasks
                ? in.p[leaf[u]][k * in.row[leaf[u]] + lane * in.col[leaf[u]]] : 0;
    }
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
        const int task = y + kThreadsPerLane * i, g = task / N, k = task % N;
        if (task >= kTasks) break;
        int32_t v[kCycloRowsPerSq];
        celo::cyclo_rows(v4[i][0], v4[i][1], v4[i][2], v4[i][3], v);
#pragma unroll
        for (int r = 0; r < kCycloRowsPerSq; ++r)
            rows[((kCycloRowsPerSq * g + r) * N + k) * L + x] = v[r];
    }
    for (int k = y; k < N; k += kThreadsPerLane) rows[(kCycloOne * N + k) * L + x] = in.one[k];
    __syncthreads();

    // phase 1: product y of the lane, its words to shared memory
    if (y < kCycloProducts) {
        uint32_t t[W];
        celo::cyclo_product<N, L>(y, CycloRows<N, L>{rows + x}, c, t);
#pragma unroll
        for (int w = 0; w < W; ++w) prods[(y * W + w) * L + x] = t[w];
    }
    __syncthreads();

    // phase 2: the 12 output coefficients, one (squaring, limb) task at a time
    if (!live) return;
    const LaneProducts<N, L> r{prods + x};
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
        const int task = y + kThreadsPerLane * i, g = task / N, k = task % N;
        if (task >= kTasks) break;
        int32_t o[4];
        int ms, ps;
        celo::cyclo_combine(g, k, r, o, ms, ps);
        out[((2 * ms) * N + k) * B + lane] = o[0];
        out[((2 * ms + 1) * N + k) * B + lane] = o[1];
        out[((2 * ps) * N + k) * B + lane] = o[2];
        out[((2 * ps + 1) * N + k) * B + lane] = o[3];
    }
}

// lanes up to which each lane's warp can have a warp scheduler of its own
// (4 an SM); 0 until the first call asks the device
int64_t one_lane_a_scheduler() {
    static int64_t lanes = 0;
    if (lanes == 0) {
        int dev = 0, sms = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            return 0;
        lanes = static_cast<int64_t>(sms) * 4;
    }
    return lanes;
}

template <int N, int L>
void launch_lanes(const Fq12In& in, int32_t* out, int64_t B, const FieldConsts& c,
                  cudaStream_t s) {
    const unsigned grid = static_cast<unsigned>((B + L - 1) / L);
    f12_cyclo_sq_kernel<N, L><<<grid, dim3(L, kThreadsPerLane), 0, s>>>(in, out, B, c);
}

template <int N>
void launch(const Fq12In& in, int32_t* out, int64_t B, const FieldConsts& c,
            cudaStream_t s) {
    if (B <= one_lane_a_scheduler()) launch_lanes<N, 1>(in, out, B, c, s);
    else launch_lanes<N, kLanesWide>(in, out, B, c, s);
}

}  // namespace

// Plain C interface (loaded with ctypes), as field.cu's: launches on
// `stream`, does not synchronize, returns cudaGetLastError(). `p`, `row`
// and `col`: the 12 input coefficients' device pointers and their strides
// in elements (limb k of lane l of leaf i at p[i] + k row[i] + l col[i]),
// host arrays; `one`: the n limbs of the field's Montgomery one, host; `out`:
// a contiguous [12, n, B] int32 device array; `c`: the field's constants.
// Only n = 25 (Fq of BLS12-377) is built.
extern "C" int celo_f12_cyclo_sq(int n, const FieldConsts* c, const int32_t* const* p,
                                 const int64_t* row, const int64_t* col,
                                 const int32_t* one, int32_t* out, int64_t B,
                                 void* stream) {
    if (n != 25) return static_cast<int>(cudaErrorInvalidValue);
    if (B <= 0) return 0;
    Fq12In in;
    for (int i = 0; i < kCycloLeaves; ++i) {
        in.p[i] = p[i];
        in.row[i] = row[i];
        in.col[i] = col[i];
    }
    for (int k = 0; k < kMaxLimbs; ++k) in.one[k] = k < n ? one[k] : 0;
    launch<25>(in, out, B, *c, static_cast<cudaStream_t>(stream));
    return static_cast<int>(cudaGetLastError());
}
