// Montgomery multiply with the reduction on the tensor cores, for Hopper
// (sm_90a): mont_mul_tc<N>, N = 17, 25, 49.
//
// It replaces the Pallas kernel _make_pallas_mul_mxu of the JAX package's
// ops/field.py and computes the same function as mont_mul (field.cu): lazy
// a, b -> canonical limbs of (A B + m p) / R, A = a + 256p, B = b + 256p,
// m = -A B p^-1 mod R. m is unique in [0, R), so the output equals
// mont_mul's limb for limb. The form is the separated one:
//
//   phase A  T = A B, all 2n limbs, per lane on the CUDA cores, in 32-bit
//            words (W^2 wide multiply-adds, W = ceil(n / 2): the word
//            arithmetic of field_common.cuh). The words are canonical, so
//            the low 2n bytes of T are the 8-bit pieces of T mod R as they
//            stand;
//   phase B  m = (T mod R) N' mod R, N' = -p^-1 mod R: a product with a
//            constant operand, so it is W1 [2n, 2n] (a lower-triangular
//            Toeplitz matrix of the 8-bit pieces of N') times the pieces of
//            T mod R, on the tensor cores;
//   phase C  m p as W2 [4n, 2n] (Toeplitz in the pieces of p) times the
//            pieces of m, on the tensor cores;
//   ripple   the radix-2^8 column sums of m p are added to T's limbs and
//            carried upward; limbs n..2n-1 are the result.
//
// The tensor-core products are mma.sync.m16n8k32 on unsigned 8-bit
// operands with 32-bit integer accumulation: every piece is 0..255 and a
// sum has at most 2n <= 98 terms of at most 255^2, under 2^23, so s32 is
// exact. Both operands take the u8 form: s8 would read 128..255 as
// negative.
//
// What bounds it. Per lane: 12 n bytes moved, W^2 word products (2 W^2
// 32-bit multiply instructions, a low and a high half each) for the one
// product that stays on the CUDA cores, and 24 n^2 8-bit multiply-adds on
// the tensor cores. At the card's rates (3.35 TB/s, 33.5e12 lane
// instructions/s, 1,979e12 8-bit operations/s) that is, at n = 49, 0.18 ns a
// lane for the bytes, 0.037 ns for the CUDA-core product and 0.029 ns for
// the tensor cores: bound by the bytes, at every n. What the kernel spends
// beyond that is the hand-over between the two kinds of unit: the pieces
// and the column sums cross shared memory once each way. Measured at n = 49
// and 196,608 lanes (scripts/prof_variants.py), the matrix products with
// their fragment loads and result stores are a fifth of the time, phase A's
// product a quarter, and loads, stores, hand-over and ripples the rest: the
// CUDA-core work, not the tensor cores, is what a faster version has to cut,
// which is why the products stay mma.sync and are not wgmma.
//
// Design. One thread owns one lane through phase A and the ripples. A warp
// owns its 32 lanes through the matrix products too: its threads stage
// their pieces in shared memory as the B operand [lanes, K] (K padded with
// zeros to a multiple of 32), and the warp multiplies W (the A operand) by
// those 32 columns one tile of 16 rows at a time. Both ripples carry upward
// only, and 16 rows of column sums make 8 limbs that nothing later needs
// again, so the s32 result buffer holds ONE tile a warp ([16, 32 + 8]:
// 10 KB a block where all 4n rows took 113 KB at n = 49): the warp writes a
// tile, each thread reads its lane's 16 sums, ripples 8 limbs with the carry
// kept in a register, and the buffer is reused. The only synchronization
// between the phases is __syncwarp: once after a tile is written, once after
// it is read (before the next tile overwrites it). Tiles of W that are all
// zero (above the diagonal, below the band) are skipped at compile time.
//
// W1 and W2 are constants of the field. They are banded Toeplitz matrices,
// so a block does not stage their 40 KB (n = 49) but the vectors that
// generate them, 2.8 KB, and every fragment register of the A operand is one
// aligned word of those (toeplitz_copies): no fragment comes from global
// memory after the block's first microsecond. Through the products only the
// high half of T stays in registers; the ripple reads T's low limbs back
// from the lane's own pieces. A block takes 49,920 bytes of shared memory at
// n = 49 (33,024 at 25; 32,512 at 17), so shared memory allows four blocks
// an SM where the 113 KB buffer allowed one; at n = 49 the kernel is built
// for three (160 registers a thread, no spill: at four the cap of 128 spills
// 32 bytes and runs no faster), at n = 17 and 25 for four.

#include "field_common.cuh"

namespace {

using celo::FieldConsts;
using celo::kMask;
using celo::limb_of;
using celo::load_words;
using celo::mul_full_words;
using celo::words_of;

constexpr int kLanes = 128;           // threads (= lanes) per block
constexpr int kChunk = 16;            // rows of W x pieces per hand-over
constexpr int kResStride = 32 + 8;    // s32 per row of a warp's tile (bank spread)
constexpr int kSmemPerSm = 232448;    // shared memory the blocks of an SM can use

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
constexpr int min_of(int a, int b) { return a < b ? a : b; }

template <int N>
struct Shape {
    static constexpr int W = words_of(N);            // words per operand
    static constexpr int K = 2 * N;                  // pieces per operand
    static constexpr int KP = round_up(K, 32);       // padded MMA depth
    static constexpr int R1 = round_up(2 * N, 16);   // padded rows of W1
    static constexpr int R2 = round_up(4 * N, 16);   // padded rows of W2
    static constexpr int PS = KP + 16;               // bytes per lane of pieces
    static constexpr int kPieceBytes = kLanes * PS;  // one pieces buffer
    static constexpr int kResBytes = (kLanes / 32) * kChunk * kResStride * 4;
    // W as its generating vector (see toeplitz_copies): four shifted copies
    // of R + KP bytes each, a copy's stride 32 bytes past a multiple of 128
    // so that the four copies start 8 banks apart
    static constexpr int CS1 = round_up(R1 + KP + 4, 128) + 32;
    static constexpr int CS2 = round_up(R2 + KP + 4, 128) + 32;
    static constexpr int kWBytes = 4 * (CS1 + CS2);
    static constexpr int kSmemBytes = 2 * kPieceBytes + kResBytes + kWBytes;
    // blocks an SM the kernel is built for: four (128 registers a thread),
    // three at n = 49 (see the header), fewer where the shared memory (plus
    // 1 KB the system keeps a block) does not allow it
    static constexpr int kBlocks =
        min_of(N > 25 ? 3 : 4, kSmemPerSm / (kSmemBytes + 1024));
    static_assert(kBlocks >= 1, "a block must fit an SM's shared memory");
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

// W is a banded Toeplitz matrix, W[r, k] = w8[r - k] for 0 <= r - k < K and
// zero elsewhere, so its ROWS x KP bytes are all in one vector of
// ROWS + KP bytes: with V[i] = w8[ROWS - i] (zero outside 0 <= ROWS - i < K),
// W[r, k .. k + 3] = V[ROWS - r + k .. + 3], the four bytes of one fragment
// register. A block builds V in shared memory from W's first column (W[i, 0]
// = w8[i]) instead of staging the matrix (40 KB at n = 49, which would halve
// the blocks an SM): 2.8 KB. The fragment's address ROWS - r + k is a
// multiple of 4 less r mod 4, so there are four copies, copy c holding V
// shifted by c bytes, and a thread reads whole aligned words from the copy
// its row selects. Two kinds of entries that are zero in the padded matrix
// come out nonzero this way and change nothing: columns from K up meet the
// zero pad of the pieces, and the rows of W1 from 2n up only make limbs of m
// from n up, which are dropped.
template <int ROWS, int KP, int K, int CS>
__device__ __forceinline__ void toeplitz_copies(const uint8_t* __restrict__ Wm,
                                                uint8_t* copies, int tl) {
    constexpr int LV = ROWS + KP;
    for (int e = tl; e < 4 * LV; e += kLanes) {
        const int c = e / LV, x = e % LV;
        const int d = ROWS - (x + c);
        copies[c * CS + x] = d >= 0 && d < K ? Wm[d * KP] : 0;
    }
}

// Tile mt (16 rows) of W x pieces for this warp's 32 lanes:
//   res[r, l] = sum_k W[16 mt + r, k] * pieces[l, k].
// wv: this thread's place in W's vector copies (shared): the word that
// holds W[g, 4 t4 .. 4 t4 + 3]; row r, column k lie k - r bytes further.
// pieces: shared, this warp's lane 0, rows of PS bytes. res: shared, this
// warp's tile, rows of kResStride s32. g, t4: the thread's fragment row
// group and place in it.
template <int KP, int K, int PS>
__device__ __forceinline__ void tile_product(const uint8_t* wv, int mt,
                                             const uint8_t* pieces,
                                             int32_t* res, int g, int t4) {
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
        const uint8_t* wa = wv + (ks * 32 - mt * 16);
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(wa);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(wa - 8);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(wa + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(wa + 8);
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
        int32_t* r0 = res + g * kResStride + nt * 8 + 2 * t4;
        *reinterpret_cast<int2*>(r0) = make_int2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<int2*>(r0 + 8 * kResStride) =
            make_int2(acc[nt][2], acc[nt][3]);
    }
}

template <int N>
__global__ void __launch_bounds__(kLanes, Shape<N>::kBlocks)
mont_mul_tc_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ out, int64_t B,
                   const uint8_t* __restrict__ W1, const uint8_t* __restrict__ W2,
                   FieldConsts c) {
    using S = Shape<N>;
    constexpr int W = S::W;
    extern __shared__ __align__(16) uint8_t smem[];
    const int tl = threadIdx.x;
    const int warp = tl >> 5, warp_lane = tl & 31;
    const int g = warp_lane >> 2, t4 = warp_lane & 3;
    uint8_t* tpieces = smem + tl * S::PS;                    // T mod R
    uint8_t* mpieces = smem + S::kPieceBytes + tl * S::PS;   // m
    const uint8_t* warp_tpieces = smem + warp * 32 * S::PS;
    const uint8_t* warp_mpieces = smem + S::kPieceBytes + warp * 32 * S::PS;
    int32_t* warp_res = reinterpret_cast<int32_t*>(smem + 2 * S::kPieceBytes)
        + warp * kChunk * kResStride;
    const int32_t* my_res = warp_res + warp_lane;

    // once a block: W1 and W2 as shifted copies of their generating vectors
    uint8_t* v1 = smem + 2 * S::kPieceBytes + S::kResBytes;
    uint8_t* v2 = v1 + 4 * S::CS1;
    toeplitz_copies<S::R1, S::KP, S::K, S::CS1>(W1, v1, tl);
    toeplitz_copies<S::R2, S::KP, S::K, S::CS2>(W2, v2, tl);
    // row g of a tile is congruent to g mod 4: copy (-g) mod 4 is aligned
    const int copy = (4 - (g & 3)) & 3;
    const uint8_t* w1 = v1 + copy * S::CS1 + (S::R1 - g - copy) + 4 * t4;
    const uint8_t* w2 = v2 + copy * S::CS2 + (S::R2 - g - copy) + 4 * t4;
    __syncthreads();

    // the pad of both pieces buffers: zeros from word W up (bytes 2n, 2n+1
    // are the masked top half of word W - 1)
#pragma unroll
    for (int j = W; j < S::KP / 4; ++j) {
        reinterpret_cast<uint32_t*>(tpieces)[j] = 0;
        reinterpret_cast<uint32_t*>(mpieces)[j] = 0;
    }

    // every thread of a warp runs the matrix products, so a lane past
    // the ragged edge computes on lane B - 1's operands, stores nothing
    const int64_t lane = static_cast<int64_t>(blockIdx.x) * kLanes + tl;
    const int64_t src = lane < B ? lane : B - 1;

    // phase A: T = A B in words
    uint32_t t[2 * W];
    {
        uint32_t aw[W], bw[W];
        load_words<N>(a, src, B, c, aw);
        load_words<N>(b, src, B, c, bw);
        mul_full_words<W>(aw, bw, t);
    }
    // the pieces of T mod R: T's low 2n bytes, little endian
#pragma unroll
    for (int j = 0; j < W - 1; ++j)
        reinterpret_cast<uint32_t*>(tpieces)[j] = t[j];
    reinterpret_cast<uint32_t*>(tpieces)[W - 1] = t[W - 1] & kMask;
    __syncwarp();

    // phase B: m = (T mod R) N' mod R, tile by tile: 16 radix-2^8
    // column sums -> 8 limbs of m, written as m's pieces
    uint32_t carry = 0;
#pragma unroll
    for (int mt = 0; mt < S::R1 / 16; ++mt) {
        tile_product<S::KP, S::K, S::PS>(w1, mt, warp_tpieces, warp_res, g, t4);
        __syncwarp();
        uint32_t mw[4];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            const uint32_t v =
                static_cast<uint32_t>(my_res[(2 * jj) * kResStride])
                + (static_cast<uint32_t>(my_res[(2 * jj + 1) * kResStride]) << 8)
                + carry;
            carry = v >> 16;
            // limbs from n up are dropped: m is taken mod R
            const uint32_t limb = 8 * mt + jj < N ? v & kMask : 0;
            if (jj & 1) mw[jj / 2] |= limb << 16;
            else mw[jj / 2] = limb;
        }
        *reinterpret_cast<uint4*>(mpieces + 16 * mt) =
            make_uint4(mw[0], mw[1], mw[2], mw[3]);
        __syncwarp();  // the tile is read (and m's pieces are written)
    }

    // phase C and the ripple: (T + m p) / R, tile by tile; the low n
    // limbs cancel mod R and only their carry matters. T's low limbs
    // are read back from this lane's pieces (they are T's low bytes), so
    // only the high half of T stays in registers through the products
    carry = 0;
#pragma unroll
    for (int mt = 0; mt < S::R2 / 16; ++mt) {
        tile_product<S::KP, S::K, S::PS>(w2, mt, warp_mpieces, warp_res, g, t4);
        __syncwarp();
        uint32_t low[4] = {0, 0, 0, 0};
        if (8 * mt < N) {
            const uint4 q = *reinterpret_cast<const uint4*>(tpieces + 16 * mt);
            low[0] = q.x, low[1] = q.y, low[2] = q.z, low[3] = q.w;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            const int k = 8 * mt + jj;
            if (k < 2 * N) {
                const uint32_t v = (k < N ? limb_of<4>(low, jj) : limb_of<2 * W>(t, k))
                    + static_cast<uint32_t>(my_res[(2 * jj) * kResStride])
                    + (static_cast<uint32_t>(my_res[(2 * jj + 1) * kResStride]) << 8)
                    + carry;
                carry = v >> 16;
                if (k >= N && lane < B)
                    out[static_cast<int64_t>(k - N) * B + lane] =
                        static_cast<int32_t>(v & kMask);
            }
        }
        __syncwarp();
    }
    // the result is < 2p < R: limb 2n ripples to 0
}

// Once per instantiation: lift the 48 KB limit on dynamic shared memory and
// ask the runtime how many blocks of the kernel share an SM. Returns a CUDA
// error code.
template <int N>
int prepare(int* blocks_per_sm) {
    static int per_sm = 0;
    if (per_sm == 0) {
        cudaError_t e = cudaFuncSetAttribute(
            mont_mul_tc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            Shape<N>::kSmemBytes);
        int blocks = 0;
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, mont_mul_tc_kernel<N>, kLanes, Shape<N>::kSmemBytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (blocks < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
        per_sm = blocks;
    }
    if (blocks_per_sm) *blocks_per_sm = per_sm;
    return 0;
}

template <int N>
int launch_tc(const int32_t* a, const int32_t* b, int32_t* out, int64_t B,
              const uint8_t* W1, const uint8_t* W2, const FieldConsts& c,
              cudaStream_t s) {
    const int err = prepare<N>(nullptr);
    if (err) return err;
    const int64_t grid = (B + kLanes - 1) / kLanes;
    mont_mul_tc_kernel<N><<<static_cast<unsigned>(grid), kLanes,
                            Shape<N>::kSmemBytes, s>>>(a, b, out, B, W1, W2, c);
    return static_cast<int>(cudaGetLastError());
}

template <int N>
int occupancy(int* blocks_per_sm, int* smem_bytes) {
    *smem_bytes = Shape<N>::kSmemBytes;
    return prepare<N>(blocks_per_sm);
}

}  // namespace

// Plain C interface, as in field.cu. W1 and W2 are device pointers to the
// field's weight matrices as ops/field.py builds them: row-major u8,
// [2n padded to 16, 2n padded to 32] and [4n padded to 16, 2n padded to 32].
extern "C" int celo_mont_mul_tc(int n, const FieldConsts* c, const int32_t* a,
                                const int32_t* b, int32_t* out, int64_t B,
                                const uint8_t* W1, const uint8_t* W2,
                                void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n) {
        case 17: return launch_tc<17>(a, b, out, B, W1, W2, *c, s);
        case 25: return launch_tc<25>(a, b, out, B, W1, W2, *c, s);
        case 49: return launch_tc<49>(a, b, out, B, W1, W2, *c, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// What the runtime says of mont_mul_tc<n> on the current card: the blocks
// of 128 threads that share an SM, and a block's dynamic shared memory.
extern "C" int celo_mont_mul_tc_occupancy(int n, int* blocks_per_sm,
                                          int* smem_bytes) {
    switch (n) {
        case 17: return occupancy<17>(blocks_per_sm, smem_bytes);
        case 25: return occupancy<25>(blocks_per_sm, smem_bytes);
        case 49: return occupancy<49>(blocks_per_sm, smem_bytes);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
