// The Fq12 multiply of a batch (BLS12-377, n = 25 limbs a coefficient) as
// one kernel, for Hopper (sm_90a): f12_mul_kernel<N, L, SIDES>, SIDES = 2
// for a product, 1 for a square.
//
// It replaces no TPU kernel. The JAX package and ops/tower.py compute the
// Fq12 multiply as a composition: one 54-wide mont_mul launch between some
// 244 elementwise int32 ops and concatenations, 245 launches in all. The
// pairing runs it 63 times a Miller loop (the squaring of f), 35 times a
// final exponentiation (7 explicit, 28 inside f12_powx) and once for each
// level of a tree product: about 25,000 graph nodes a call, each costing a
// node's 1-3 us on the card whatever its width. This kernel is one launch a
// multiply and computes the same limbs: csrc/f12_mul.cuh holds the per-lane
// arithmetic, csrc/f12_mul_host_check.cpp runs it on the host against the
// composition.
//
// What bounds it. Per lane 54 Montgomery products, 54 x 4 W^2 = 36,504
// 32-bit multiply instructions (W = 13 words), against 24 coefficients in
// and 12 out, 36 x 25 x 4 = 3,600 bytes (a square reads 12: 2,400): at the
// card's rates (33.5e12 lane instructions/s, 3.35 TB/s) 1.09 ns a lane of
// multiplies against 1.07 ns of bytes (0.72 for a square), about 13 us at
// 12,000 lanes. Up to a few thousand lanes neither binds: a launch costs
// the latency of its dependent chain, load, one multiply, combine, store.
// The composition's chain is 245 launches long; the kernel's is one
// multiply's latency plus its loads and stores.
//
// Design. A block holds L lanes (lane on threadIdx.x, the fast axis) and 64
// threads a lane (threadIdx.y), two warps' worth, one thread a product; L
// and SIDES are template arguments, so that every shared-memory address is
// a base and a constant. Phase 0: one task a (side, limb) pair, 50 a lane
// (25 for a square): a task loads limb k of its side's 12 input
// coefficients (all 12 loads issued before one is used) and writes limb k
// of the side's 54 operand rows to shared memory (f12_row: the inputs and
// the sums the composition pre-adds at the Fq12, Fq6 and Fq2 levels), so
// that each operand is summed once. The inputs are read where they lie, as
// a row stride and a lane stride each: they are slices of the previous
// product's output, of a Miller loop's lanes (lane stride 2 in the tree
// product) or broadcast constants (lane stride 0), and a copy to make them
// contiguous would be a launch of its own; a row's L lanes are
// neighbouring addresses, so the loads coalesce (L = 8: one 32-byte
// sector). Phase 1: thread y < 54 of a lane loads product y's rows with
// load_words and multiplies them with mont_mul_words (mont_mul's body: the
// same integer, the same limbs; a square loads its one row once), and
// stores the product's words to shared memory. Phase 2: one task a limb,
// 25 a lane, forms limb k of the 12 output coefficients (f12_combine) and
// writes them to the [12, n, B] output, coalesced as the loads are. Two
// __syncthreads, no atomics. Shared memory, dynamic: SIDES x 54 rows of n
// limbs and 54 products of W words a lane, 13,608 bytes (8,208 for a
// square), 108,864 at L = 8.
//
// L comes from B alone, as field.cu's threads_for chooses mont_mul's block
// and cyclo_sq.cu its lanes: one lane a block while blocks of eight lanes
// would leave SMs without a block (B up to 8 x the SM count; the rows'
// shared memory lets 15 one-lane blocks share an SM), so that narrow
// batches spread over every SM; above that eight lanes a block (512
// threads), whose rows' loads and output stores fill whole sectors.
//
// 64 registers a thread and no spill in all four instantiations (ptxas,
// sm_90a; shared memory all dynamic).
//
// Measured (chip_smoke's f12_mul line, H100 80GB HBM3 at 700 W, a launch
// from a replayed graph): a product 3.4 us at 1 lane, 4.5 at 33, 6.1 at
// 300, 9.2 at 600, 29.8 at 6,000 and 67 at 12,000 (the bound 13 us); a
// square 3.7, 4.3, 5.4, 7.4, 26.0 and 53 us; the composition it replaces
// took 260-810 us on the same inputs. Up to 600 lanes the time is the
// chain's latency; at 6,000 and more it is the multiplies' issue rate at
// 16 lanes an SM, which the bound's FP32 lane rate overstates.

#include "f12_mul.cuh"

namespace {

using celo::FieldConsts;
using celo::kF12Leaves;
using celo::kF12Products;
using celo::LaneProducts;
using celo::words_of;

constexpr int kThreadsPerLane = 64;
constexpr int kLanesWide = 8;

// where the input coefficients lie: limb k of lane l of leaf i of side s at
// p[12 s + i][k * row[12 s + i] + l * col[12 s + i]] (a square fills side 0)
struct F12In {
    const int32_t* p[2 * kF12Leaves];
    int64_t row[2 * kF12Leaves];
    int64_t col[2 * kF12Leaves];
};

template <int N, int SIDES>
constexpr int smem_per_lane() {
    return (SIDES * kF12Products * N + kF12Products * words_of(N)) * 4;
}

// L lanes a block, 64 threads a lane; shared memory as smem_per_lane. Built
// for 8 blocks of one lane an SM (one_lane_a_block launches no more; 128
// registers a thread at most) or 2 of eight lanes (64 registers; the rows'
// shared memory allows no more)
template <int N, int L, int SIDES>
__global__ void __launch_bounds__(kThreadsPerLane * L, L == 1 ? 8 : 2)
f12_mul_kernel(F12In in, int32_t* __restrict__ out, int64_t B, FieldConsts c) {
    constexpr int W = words_of(N);
    extern __shared__ uint32_t smem[];
    int32_t* rows = reinterpret_cast<int32_t*>(smem);        // [SIDES][54][N][L]
    uint32_t* prods = smem + SIDES * kF12Products * N * L;   // [54][W][L]
    const int x = threadIdx.x, y = threadIdx.y;
    const int64_t lane = static_cast<int64_t>(blockIdx.x) * L + x;
    const bool live = lane < B;

    // phase 0: task y is (side y / N, limb y % N); it loads limb k of the
    // side's 12 coefficients and writes limb k of the side's 54 rows
    if (y < SIDES * N) {
        const int side = y / N, k = y % N;
        int32_t v[kF12Leaves];
#pragma unroll
        for (int i = 0; i < kF12Leaves; ++i) {
            const int e = kF12Leaves * side + i;
            v[i] = live ? in.p[e][k * in.row[e] + lane * in.col[e]] : 0;
        }
        int32_t* r = rows + (side * kF12Products * N + k) * L + x;
#pragma unroll
        for (int j = 0; j < kF12Products; ++j) r[j * N * L] = celo::f12_row(j, v);
    }
    __syncthreads();

    // phase 1: product y of the lane, its words to shared memory
    if (y < kF12Products) {
        const int32_t* a = rows + x;
        const int32_t* b = SIDES == 1 ? a : a + kF12Products * N * L;
        uint32_t t[W];
        celo::f12_product<N, L>(y, a, b, c, t);
#pragma unroll
        for (int w = 0; w < W; ++w) prods[(y * W + w) * L + x] = t[w];
    }
    __syncthreads();

    // phase 2: task y < N forms limb y of the 12 output coefficients
    if (!live || y >= N) return;
    int32_t o[kF12Leaves];
    celo::f12_combine(y, LaneProducts<N, L>{prods + x}, o);
#pragma unroll
    for (int i = 0; i < kF12Leaves; ++i) out[(i * N + y) * B + lane] = o[i];
}

// lanes up to which blocks of eight lanes would leave an SM without a
// block; 0 until the first call asks the device
int64_t one_lane_a_block() {
    static int64_t lanes = 0;
    if (lanes == 0) {
        int dev = 0, sms = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            return 0;
        lanes = static_cast<int64_t>(sms) * kLanesWide;
    }
    return lanes;
}

template <int N, int L, int SIDES>
cudaError_t allow_smem() {
    return cudaFuncSetAttribute(f12_mul_kernel<N, L, SIDES>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_per_lane<N, SIDES>() * L);
}

// Once: lift the 48 KB limit on dynamic shared memory for every
// instantiation, so that no launch inside a graph capture does it
template <int N>
cudaError_t prepare() {
    static bool done = false;
    if (!done) {
        cudaError_t e = allow_smem<N, 1, 1>();
        if (e == cudaSuccess) e = allow_smem<N, 1, 2>();
        if (e == cudaSuccess) e = allow_smem<N, kLanesWide, 1>();
        if (e == cudaSuccess) e = allow_smem<N, kLanesWide, 2>();
        if (e != cudaSuccess) return e;
        done = true;
    }
    return cudaSuccess;
}

template <int N, int L, int SIDES>
void launch_lanes(const F12In& in, int32_t* out, int64_t B, const FieldConsts& c,
                  cudaStream_t s) {
    const unsigned grid = static_cast<unsigned>((B + L - 1) / L);
    f12_mul_kernel<N, L, SIDES><<<grid, dim3(L, kThreadsPerLane),
                                  smem_per_lane<N, SIDES>() * L, s>>>(in, out, B, c);
}

template <int N, int SIDES>
void launch(const F12In& in, int32_t* out, int64_t B, const FieldConsts& c,
            cudaStream_t s) {
    if (B <= one_lane_a_block()) launch_lanes<N, 1, SIDES>(in, out, B, c, s);
    else launch_lanes<N, kLanesWide, SIDES>(in, out, B, c, s);
}

}  // namespace

// Plain C interface (loaded with ctypes), as field.cu's: launches on
// `stream`, does not synchronize, returns a CUDA error code. `sides`: 2
// for a product, 1 for a square (both operands one element); `p`, `row`
// and `col`: the sides' 12 input coefficients each, side by side, as
// device pointers and strides in elements (limb k of lane l of entry e at
// p[e] + k row[e] + l col[e]), host arrays of 12 x sides; `out`: a
// contiguous [12, n, B] int32 device array; `c`: the field's constants.
// Only n = 25 (Fq of BLS12-377) is built.
extern "C" int celo_f12_mul(int n, const FieldConsts* c, int sides,
                            const int32_t* const* p, const int64_t* row,
                            const int64_t* col, int32_t* out, int64_t B,
                            void* stream) {
    if (n != 25 || (sides != 1 && sides != 2)) return static_cast<int>(cudaErrorInvalidValue);
    if (B <= 0) return 0;
    const cudaError_t e = prepare<25>();
    if (e != cudaSuccess) return static_cast<int>(e);
    F12In in = {};
    for (int i = 0; i < kF12Leaves * sides; ++i) {
        in.p[i] = p[i];
        in.row[i] = row[i];
        in.col[i] = col[i];
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (sides == 1) launch<25, 1>(in, out, B, *c, s);
    else launch<25, 2>(in, out, B, *c, s);
    return static_cast<int>(cudaGetLastError());
}
