// Montgomery multiply with the reduction on the tensor cores, for Hopper
// (sm_90a): mont_mul_tc<N>, N = 17, 25, 49.
//
// It replaces the Pallas kernel _make_pallas_mul_mxu of the JAX package's
// ops/field.py and computes the same function as mont_mul (field.cu): lazy
// a, b -> canonical limbs of (A B + m p) / R, A = a + 256p, B = b + 256p,
// m = -A B p^-1 mod R. m is unique in [0, R), so the output equals
// mont_mul's limb for limb. The form is the separated one:
//
//   phase A  T = A B as 16-bit-radix column sums, per lane, on the CUDA
//            cores (n^2 products); the low n columns are normalized to
//            T mod R and their carry is folded into column n once;
//   phase B  m = (T mod R) N' mod R, N' = -p^-1 mod R: a product with a
//            constant operand, so it is W1 [2n, 2n] (a lower-triangular
//            Toeplitz matrix of the 8-bit pieces of N') times the 8-bit
//            pieces of T mod R, on the tensor cores;
//   phase C  m p as W2 [4n, 2n] (Toeplitz in the pieces of p) times the
//            pieces of m, on the tensor cores;
//   final    one ripple over the columns of T + m p; columns n..2n-1 are
//            the result.
//
// The tensor-core products are mma.sync.m16n8k32 on unsigned 8-bit
// operands with 32-bit integer accumulation: every piece is 0..255 and a
// sum has at most 2n <= 98 terms of at most 255^2, under 2^23, so s32 is
// exact. Both operands take the u8 form: s8 would read 128..255 as
// negative.
//
// What bounds it. Per lane: 12 n bytes moved, about 3 n^2 integer
// operations for the one product that stays on the CUDA cores, and
// 24 n^2 8-bit multiply-adds on the tensor cores. At the card's rates
// (3.35 TB/s, 33.5e12 lane instructions/s, 1,979e12 8-bit operations/s)
// that is, at n = 49, 0.18 ns a lane for the bytes, 0.21 ns for the
// CUDA-core product and 0.03 ns for the tensor cores: bound by the
// integer pipes, at half of mont_mul's operation count. At n = 17 and 25
// the bytes are the largest of the three.
//
// Design. One thread owns one lane through phase A and the ripples, as in
// mont_mul; phase A scans by column, so only the two operands and the high
// half of T stay in registers. A warp owns its 32 lanes through the
// matrix products too: its threads stage their pieces in shared memory as
// the B operand [lanes, K] (K padded with zeros to a multiple of 32), the
// warp multiplies W (the A operand, read from global memory, where it
// stays in cache) by those 32 columns tile by tile, writes the s32 result
// to shared memory, and each thread reads its own lane's column back. So
// the only synchronization is __syncwarp. Tiles of W that are all zero
// (above the diagonal, below the band) are skipped at compile time. The
// result buffer is [4n padded to 16 rows, 128 + 8 lanes] s32: 113 KB at
// n = 49, dynamic shared memory. This first version is simple and exact:
// wgmma, TMA loads of W and a persistent layout are later work.

#include "field_common.cuh"

namespace {

using celo::FieldConsts;
using celo::fill_consts;
using celo::kMask;
using celo::load_normalized;

constexpr int kLanes = 128;          // threads (= lanes) per block
constexpr int kResStride = kLanes + 8;  // s32 per result row (bank spread)

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int N>
struct Shape {
    static constexpr int K = 2 * N;                  // pieces per operand
    static constexpr int KP = round_up(K, 32);       // padded MMA depth
    static constexpr int R1 = round_up(2 * N, 16);   // padded rows of W1
    static constexpr int R2 = round_up(4 * N, 16);   // padded rows of W2
    static constexpr int PS = KP + 16;               // bytes per lane of pieces
    static constexpr int kPieceBytes = kLanes * PS;  // one pieces buffer
    static constexpr int kSmemBytes = 2 * kPieceBytes + R2 * kResStride * 4;
};

__device__ __forceinline__ void mma_u8(int32_t (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// res[r, l] = sum_k W[r, k] * pieces[l, k] for this warp's 32 lanes.
// W: global, row-major [ROWS, KP] u8, W[r, k] = w8[r - k] for 0 <= r - k < K
// (a banded lower-triangular Toeplitz matrix), zero elsewhere.
// pieces: shared, this warp's lane 0, [32, PS] u8; res: shared, this warp's
// column 0, rows of kResStride s32.
template <int ROWS, int KP, int PS, int K>
__device__ __forceinline__ void warp_matmul(const uint8_t* __restrict__ W,
                                            const uint8_t* pieces, int32_t* res,
                                            int warp_lane) {
    const int g = warp_lane >> 2;   // fragment row / column group
    const int t4 = warp_lane & 3;   // thread in group
#pragma unroll
    for (int mt = 0; mt < ROWS / 16; ++mt) {
        int32_t acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
#pragma unroll
        for (int ks = 0; ks < KP / 32; ++ks) {
            // all r < k in the tile, or all r - k >= K: the tile of W is zero
            if (mt * 16 + 15 < ks * 32) continue;
            if (mt * 16 - (ks * 32 + 31) >= K) continue;
            const uint8_t* wa = W + (mt * 16 + g) * KP + ks * 32 + t4 * 4;
            const uint32_t a0 = *reinterpret_cast<const uint32_t*>(wa);
            const uint32_t a1 = *reinterpret_cast<const uint32_t*>(wa + 8 * KP);
            const uint32_t a2 = *reinterpret_cast<const uint32_t*>(wa + 16);
            const uint32_t a3 = *reinterpret_cast<const uint32_t*>(wa + 8 * KP + 16);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const uint8_t* pb = pieces + (nt * 8 + g) * PS + ks * 32 + t4 * 4;
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pb);
                const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pb + 16);
                mma_u8(acc[nt], a0, a1, a2, a3, b0, b1);
            }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            int32_t* r0 = res + (mt * 16 + g) * kResStride + nt * 8 + 2 * t4;
            int32_t* r1 = r0 + 8 * kResStride;
            r0[0] = acc[nt][0];
            r0[1] = acc[nt][1];
            r1[0] = acc[nt][2];
            r1[1] = acc[nt][3];
        }
    }
}

template <int N>
__global__ void __launch_bounds__(kLanes)
mont_mul_tc_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ out, int64_t B,
                   const uint8_t* __restrict__ W1, const uint8_t* __restrict__ W2,
                   FieldConsts c) {
    using S = Shape<N>;
    extern __shared__ __align__(16) uint8_t smem[];
    const int tl = threadIdx.x;
    const int warp = tl >> 5, warp_lane = tl & 31;
    uint8_t* tpieces = smem + tl * S::PS;                    // T mod R
    uint8_t* mpieces = smem + S::kPieceBytes + tl * S::PS;   // m
    int32_t* res = reinterpret_cast<int32_t*>(smem + 2 * S::kPieceBytes);
    const uint8_t* warp_tpieces = smem + warp * 32 * S::PS;
    const uint8_t* warp_mpieces = smem + S::kPieceBytes + warp * 32 * S::PS;
    int32_t* warp_res = res + warp * 32;
    const int32_t* my_res = res + tl;

    // every thread of a warp runs the matrix products, so a lane past the
    // ragged edge computes on lane B - 1's operands and stores nothing
    const int64_t lane = static_cast<int64_t>(blockIdx.x) * kLanes + tl;
    const int64_t src = lane < B ? lane : B - 1;

    // the pad of both pieces buffers: zeros (K..KP-1)
#pragma unroll
    for (int k = S::K; k < S::KP; k += 2) {
        *reinterpret_cast<uint16_t*>(tpieces + k) = 0;
        *reinterpret_cast<uint16_t*>(mpieces + k) = 0;
    }

    // phase A: column sums of A B, scanned by column; th = columns n..2n-1
    uint32_t th[N];
    {
        uint32_t an[N], bn[N];
        load_normalized<N>(a, src, B, c, an);
        load_normalized<N>(b, src, B, c, bn);
        uint32_t hi_prev = 0, carry = 0;
#pragma unroll
        for (int k = 0; k < 2 * N; ++k) {
            uint32_t lo = 0, hi = 0;
#pragma unroll
            for (int i = 0; i < N; ++i) {
                const int j = k - i;
                if (j >= 0 && j < N) {
                    const uint32_t prod = an[i] * bn[j];
                    lo += prod & kMask;
                    hi += prod >> 16;
                }
            }
            const uint32_t col = lo + hi_prev;  // < 2 n 2^16 < 2^23
            hi_prev = hi;
            if (k < N) {
                // the low half, normalized: the pieces of T mod R
                const uint32_t v = col + carry;
                carry = v >> 16;
                *reinterpret_cast<uint16_t*>(tpieces + 2 * k) =
                    static_cast<uint16_t>(v & kMask);
            } else if (k == N) {
                th[0] = col + carry;  // the low half's carry, folded in once
            } else {
                th[k - N] = col;
            }
        }
    }
    __syncwarp();

    // phase B: m = (T mod R) N' mod R, as radix-2^8 columns then 16-bit limbs
    warp_matmul<S::R1, S::KP, S::PS, S::K>(W1, warp_tpieces, warp_res, warp_lane);
    __syncwarp();
    {
        uint32_t carry = 0;
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const uint32_t v = static_cast<uint32_t>(my_res[(2 * j) * kResStride])
                + (static_cast<uint32_t>(my_res[(2 * j + 1) * kResStride]) << 8)
                + carry;
            carry = v >> 16;
            *reinterpret_cast<uint16_t*>(mpieces + 2 * j) =
                static_cast<uint16_t>(v & kMask);
        }
        // the carry beyond n limbs is dropped: m is taken mod R
    }
    __syncwarp();

    // phase C: m p, all 4n radix-2^8 columns
    warp_matmul<S::R2, S::KP, S::PS, S::K>(W2, warp_mpieces, warp_res, warp_lane);
    __syncwarp();

    // final: (T + m p) / R by one ripple; the low n columns cancel mod R
    // and only their carry matters
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 2 * N; ++k) {
        const uint32_t t = k < N
            ? static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(tpieces + 2 * k))
            : th[k - N];
        const uint32_t v = t
            + static_cast<uint32_t>(my_res[(2 * k) * kResStride])
            + (static_cast<uint32_t>(my_res[(2 * k + 1) * kResStride]) << 8)
            + carry;
        carry = v >> 16;
        if (k >= N && lane < B)
            out[static_cast<int64_t>(k - N) * B + lane] = static_cast<int32_t>(v & kMask);
    }
    // the result is < 2p < R: column 2n ripples to 0
}

template <int N>
int launch_tc(const int32_t* a, const int32_t* b, int32_t* out, int64_t B,
              const uint8_t* W1, const uint8_t* W2, const FieldConsts& c,
              cudaStream_t s) {
    static bool attr_set = false;
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            mont_mul_tc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            Shape<N>::kSmemBytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    const unsigned grid = static_cast<unsigned>((B + kLanes - 1) / kLanes);
    mont_mul_tc_kernel<N><<<grid, kLanes, Shape<N>::kSmemBytes, s>>>(
        a, b, out, B, W1, W2, c);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, as in field.cu. W1 and W2 are device pointers to the
// field's weight matrices as ops/field.py builds them: row-major u8,
// [2n padded to 16, 2n padded to 32] and [4n padded to 16, 2n padded to 32].
extern "C" int celo_mont_mul_tc(int n, const uint32_t* p, const int32_t* offset,
                                uint32_t n0inv, const int32_t* a,
                                const int32_t* b, int32_t* out, int64_t B,
                                const uint8_t* W1, const uint8_t* W2,
                                void* stream) {
    FieldConsts c;
    int err = fill_consts(n, p, offset, n0inv, &c);
    if (err) return err;
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n) {
        case 17: return launch_tc<17>(a, b, out, B, W1, W2, c, s);
        case 25: return launch_tc<25>(a, b, out, B, W1, W2, c, s);
        case 49: return launch_tc<49>(a, b, out, B, W1, W2, c, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
