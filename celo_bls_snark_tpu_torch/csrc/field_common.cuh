// Shared by field.cu and field_tc.cu: the field constants as a kernel
// parameter, the lazy-limb load of ops/field.py's data contract, and the
// Montgomery arithmetic in 32-bit words that mont_mul, mont_redc and
// mont_mul_tc run.
//
// Data contract: a field batch is a row-major [n, B] int32 array, limb k of
// lane l at k * B + l; inputs are lazy signed 16-bit-radix limbs,
// |limb| < 2^26, value in (-256p, 256p); R = 2^(16 n), n odd (17, 25, 49),
// one guard limb, so p < 2^(16 (n - 1)) and (2 * 256)^2 p < R.
//
// Why words. The card multiplies 32 x 32 bits into 64 in one instruction
// (IMAD.WIDE.U32), so an operand held as W = ceil(n / 2) words costs W^2
// wide multiply-adds a product where 16-bit limbs cost n^2 multiplies and
// 4 n^2 masks, shifts and adds: about a tenth of the instructions, and half
// the registers. The top word holds one limb (n is odd).
//
// Mixed radix. A word-by-word Montgomery reduction of W rounds would divide
// by 2^(32 W) = 2^16 R. But m = -A B p^-1 mod R is unique in [0, R) in
// whatever digits it is computed, so the interleaved (CIOS) form runs
// W - 1 rounds of 32 bits (round i adds a's word i times b and
// m_i = t_0 n0inv32 mod 2^32 times p, then drops a word) and one last round
// of 16 bits (a's top half word, m_top = t_0 n0inv32 mod 2^16, drop 16
// bits). Together they divide by 2^(32 (W - 1) + 16) = R exactly, the
// digits m_0 .. m_top concatenate to the same m as a 16-bit-radix reduction
// computes (ops/field.py's _mul_plain), and (A B + m p) / R is the same
// integer: its canonical limbs are equal.
// REDC alone (redc_words) runs the same rounds without the a_i B rows:
// (X + m p) / R with m = -X p^-1 mod R, again the 16-bit-radix integer.
//
// Range (derived, not assumed; tests/test_torch_field.py checks it with
// Python integers at the budget's ends). A, B < 512p. After a 32-bit round
// t' < t / 2^32 + B + p, so t < 514p throughout, and 514p < 2^(32 W - 23)
// because 2^18 p < R = 2^(32 W - 16): t fits W words between rounds, with
// no carry word (the classic CIOS keeps two more). Inside a round the
// running sum is below 2^32 * 514p < 2^(32 (W + 1)): one more word. Before
// the last round's 16-bit shift
// t + a_top B + m_top p < 2^16 * 514p < 2^(32 W), again W words; after it
// the value is < 2p < R, n limbs. For REDC take B out: X < 512p, a round
// gives t' < t / 2^32 + p, so t < 513p between rounds, and the same bounds
// hold.
//
// Every loop is unrolled at compile time, so that a round renames registers
// instead of shifting them. The file also compiles for the host (the
// carry chains emulated), where its digits can be held against Python
// integers: csrc/host_check.cpp.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CELO_HD __host__ __device__ __forceinline__
#define CELO_HD_CONSTEXPR __host__ __device__ constexpr
#else
#define CELO_HD inline
#define CELO_HD_CONSTEXPR constexpr
#endif

namespace celo {

constexpr uint32_t kMask = 0xFFFFu;
constexpr int kMaxLimbs = 49;
constexpr int kMaxWords = (kMaxLimbs + 1) / 2;

CELO_HD_CONSTEXPR int words_of(int n) { return (n + 1) / 2; }

// pw comes first: the kernel parameter starts 8-byte aligned, and so do the
// word pairs the rounds read (with pw at 4 mod 8, ptxas gave mont_mul<49> 8
// more instructions a lane)
struct FieldConsts {
    uint32_t pw[kMaxWords];      // p in 32-bit words; the top word is 0
    int32_t offset[kMaxLimbs];   // 256p in 16-bit limbs
    uint32_t n0inv32;            // -p^-1 mod 2^32 (its low half: mod 2^16)
};

// lazy int32 limbs of one lane -> the canonical limbs of (value + 256p),
// packed: word j = limb 2j | limb 2j+1 << 16; the top word holds limb n-1
// alone. One signed ripple: value + 256p lies in (0, 512p) < R, so the
// carry out is 0
template <int N>
CELO_HD void load_words(const int32_t* __restrict__ x, int64_t lane, int64_t B,
                        const FieldConsts& c, uint32_t (&w)[words_of(N)]) {
    static_assert(N % 2 == 1, "the mixed radix takes an odd limb count");
    int32_t carry = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const int32_t v = x[k * B + lane] + c.offset[k] + carry;
        carry = v >> 16;  // arithmetic shift: floor division
        const uint32_t limb = static_cast<uint32_t>(v) & kMask;
        if (k & 1) w[k / 2] |= limb << 16;
        else w[k / 2] = limb;
    }
}

// limb k of a value held in words
template <int W>
CELO_HD uint32_t limb_of(const uint32_t (&w)[W], int k) {
    return (w[k / 2] >> (16 * (k & 1))) & kMask;
}

// The word-form products of one lane, each as mont_mul_words leaves it (its
// limbs 1 .. N are the product's limbs 0 .. N - 1): word w of product j at
// p[(j * W + w) * L]. The Fq12 kernels (cyclo_sq.cu, f12_mul.cu) keep the
// products of their L lanes side by side in shared memory, p at the lane;
// their host checks keep one lane (L = 1). Gives limb k of product j.
template <int N, int L>
struct LaneProducts {
    const uint32_t* p;
    CELO_HD int32_t operator()(int j, int k) const {
        const int l = k + 1;
        return static_cast<int32_t>((p[(j * words_of(N) + l / 2) * L] >> (16 * (l & 1))) & kMask);
    }
};

// ---------------------------------------------------------------------------
// Carry chains. A 32 x 32 -> 64 product added to an aligned pair of words
// with carry in and out is ONE instruction on this card
// (IMAD.WIDE.U32.X), but only ptxas emits it, from the PTX pair
// mad.lo.cc / madc.hi.cc on the same operands; plain C on uint64_t costs
// the wide multiply-add and two to three carry adds. So the chains are PTX,
// each step an asm volatile (the order of the steps is the carry's path).
// For the host the same steps are emulated with an explicit carry flag.
// ---------------------------------------------------------------------------

#ifndef __CUDA_ARCH__
inline uint32_t& carry_flag() {
    static thread_local uint32_t cf = 0;
    return cf;
}
inline uint32_t add_with_carry(uint32_t x, uint32_t y, uint32_t cin, bool set) {
    const uint64_t s = static_cast<uint64_t>(x) + y + cin;
    if (set) carry_flag() = static_cast<uint32_t>(s >> 32);
    return static_cast<uint32_t>(s);
}
#endif

// (hi:lo) = a b
CELO_HD void mul_wide(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
    const uint64_t prod = static_cast<uint64_t>(a) * b;
    lo = static_cast<uint32_t>(prod);
    hi = static_cast<uint32_t>(prod >> 32);
}

// (hi:lo) += a b; starts a chain (no carry in), carry out
CELO_HD void mad_wide_cc(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    asm volatile("mad.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.cc.u32 %1, %2, %3, %1;"
                 : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
#else
    uint32_t pl, ph;
    mul_wide(pl, ph, a, b);
    lo = add_with_carry(lo, pl, 0, true);
    hi = add_with_carry(hi, ph, carry_flag(), true);
#endif
}

// (hi:lo) += a b + carry; carry out
CELO_HD void madc_wide_cc(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    asm volatile("madc.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.cc.u32 %1, %2, %3, %1;"
                 : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
#else
    uint32_t pl, ph;
    mul_wide(pl, ph, a, b);
    lo = add_with_carry(lo, pl, carry_flag(), true);
    hi = add_with_carry(hi, ph, carry_flag(), true);
#endif
}

// (hi:lo) = a b + (shi:slo) + carry; carry out. The sum lands two words
// below its addend: the shift by 64 bits that a round owes is a renaming
CELO_HD void madc_wide_cc_from(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b,
                               uint32_t slo, uint32_t shi) {
#ifdef __CUDA_ARCH__
    asm volatile("madc.lo.cc.u32 %0, %2, %3, %4;\n\tmadc.hi.cc.u32 %1, %2, %3, %5;"
                 : "=&r"(lo), "=&r"(hi) : "r"(a), "r"(b), "r"(slo), "r"(shi));
#else
    uint32_t pl, ph;
    mul_wide(pl, ph, a, b);
    lo = add_with_carry(slo, pl, carry_flag(), true);
    hi = add_with_carry(shi, ph, carry_flag(), true);
#endif
}

// d += x; starts a chain, carry out
CELO_HD void add_cc(uint32_t& d, uint32_t x) {
#ifdef __CUDA_ARCH__
    asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(d) : "r"(x));
#else
    d = add_with_carry(d, x, 0, true);
#endif
}

// d += x + carry; carry out
CELO_HD void addc_cc(uint32_t& d, uint32_t x) {
#ifdef __CUDA_ARCH__
    asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(d) : "r"(x));
#else
    d = add_with_carry(d, x, carry_flag(), true);
#endif
}

// d += x + carry; ends a chain
CELO_HD void addc(uint32_t& d, uint32_t x) {
#ifdef __CUDA_ARCH__
    asm volatile("addc.u32 %0, %0, %1;" : "+r"(d) : "r"(x));
#else
    d = add_with_carry(d, x, carry_flag(), false);
#endif
}

// One interleaved round of the Montgomery product, on word ai of a:
//   t = (t + ai b + m p) / 2^32,  m = (t_0 + ai b_0) n0inv32 mod 2^32
// (LAST: ai is a's top half word, m is taken mod 2^16 and nothing is
// dropped; the caller takes t >> 16). Returns m, this round's digit.
//
// t is held as two arrays of W + 1 words, t = even + 2^32 odd, so that
// every product lands on an aligned pair of words: b_j ai goes to even's
// pair (j, j + 1) for even j and to odd's pair (j - 1, j) for odd j, and
// one chain runs up each array. After the m p chains even_0 is 0 and
// t / 2^32 = odd + even_1 + 2^32 (even >> 64): the arrays swap roles for
// the next round, which begins by adding even_1 (the carry goes to the new
// odd array, whose word 0 weighs 2^32) and takes the two-word shift of the
// old even array as it adds its products (madc_wide_cc_from). On entry to
// a round that is not the first, `odd` is therefore last round's even
// array and `even` last round's odd array.
//
// No chain carries out of its array: both parts are nonnegative and their
// sum is below 2^(32 (W + 1)) (header), so even fits W + 1 words and odd W.
// b has W words, p has W - 1 (guard limb), W is odd.
//
// mad_row is the round's first half, t += ai b with the swap and shift it
// owes the round before; mont_round adds m p. b points at W words.
template <int W>
CELO_HD void mad_row(uint32_t (&even)[W + 1], uint32_t (&odd)[W + 1],
                     uint32_t ai, const uint32_t* b, bool first) {
    static_assert(W % 2 == 1 && W >= 5, "an odd word count");
    if (first) {
#pragma unroll
        for (int j = 0; j <= W - 1; j += 2) mul_wide(even[j], even[j + 1], b[j], ai);
#pragma unroll
        for (int j = 0; j <= W - 3; j += 2) mul_wide(odd[j], odd[j + 1], b[j + 1], ai);
        odd[W - 1] = 0;
    } else {
        add_cc(even[0], odd[1]);
#pragma unroll
        for (int j = 0; j <= W - 3; j += 2)
            madc_wide_cc_from(odd[j], odd[j + 1], b[j + 1], ai, odd[j + 2], odd[j + 3]);
        odd[W - 1] = 0;
        addc(odd[W - 1], 0);
        mad_wide_cc(even[0], even[1], b[0], ai);
#pragma unroll
        for (int j = 2; j <= W - 1; j += 2) madc_wide_cc(even[j], even[j + 1], b[j], ai);
    }
    odd[W] = 0;
}

template <int W, bool LAST>
CELO_HD uint32_t mont_round(uint32_t (&even)[W + 1], uint32_t (&odd)[W + 1],
                            uint32_t ai, const uint32_t (&b)[W],
                            const FieldConsts& c, bool first) {
    mad_row<W>(even, odd, ai, b, first);
    uint32_t m = even[0] * c.n0inv32;
    if (LAST) m &= kMask;
    mad_wide_cc(odd[0], odd[1], c.pw[1], m);
#pragma unroll
    for (int j = 2; j <= W - 3; j += 2) madc_wide_cc(odd[j], odd[j + 1], c.pw[j + 1], m);
    addc(odd[W - 1], 0);
    mad_wide_cc(even[0], even[1], c.pw[0], m);
#pragma unroll
    for (int j = 2; j <= W - 3; j += 2) madc_wide_cc(even[j], even[j + 1], c.pw[j], m);
    addc_cc(even[W - 1], 0);
    addc(even[W], 0);
    return m;
}

// One round of REDC alone: m = t_0 n0inv32 mod 2^32 (LAST: mod 2^16),
// t += m p. It is mad_row with m and p in place of ai and b: the swap and
// shift owed to the round before ride on the products, and word 0 of t is
// even_0 + odd_1 (mad_row's first add), from which m is taken before the
// chains start. p's top word is 0, so the even chain's last product only
// carries. Round 0 takes even = X's words (and a zero top word), odd = 0.
// Returns m.
template <int W, bool LAST>
CELO_HD uint32_t redc_round(uint32_t (&even)[W + 1], uint32_t (&odd)[W + 1],
                            const FieldConsts& c) {
    uint32_t m = (even[0] + odd[1]) * c.n0inv32;
    if (LAST) m &= kMask;
    mad_row<W>(even, odd, m, c.pw, false);
    return m;
}

// t = x + 2^32 y in W words: the last round's two arrays joined (the sum is
// below 2^(32 W))
template <int W>
CELO_HD void join_words(const uint32_t (&x)[W + 1], const uint32_t (&y)[W + 1],
                        uint32_t (&t)[W]) {
    t[0] = x[0];
    t[1] = x[1];
    add_cc(t[1], y[0]);
#pragma unroll
    for (int k = 2; k < W; ++k) {
        t[k] = x[k];
        if (k < W - 1) addc_cc(t[k], y[k - 1]);
        else addc(t[k], y[k - 1]);
    }
}

// t = (a b + m p) / R * 2^16 in W words: the Montgomery product's limb k is
// limb k + 1 of t (the last round drops nothing). digits, when given, gets
// the W digits m_0 .. m_top.
template <int W>
CELO_HD void mont_mul_words(const uint32_t (&a)[W], const uint32_t (&b)[W],
                            const FieldConsts& c, uint32_t (&t)[W],
                            uint32_t* digits = nullptr) {
    uint32_t x[W + 1], y[W + 1];  // the two arrays; they swap roles each round
#pragma unroll
    for (int i = 0; i < W - 1; ++i) {
        const uint32_t m = (i & 1) ? mont_round<W, false>(y, x, a[i], b, c, false)
                                   : mont_round<W, false>(x, y, a[i], b, c, i == 0);
        if (digits) digits[i] = m;
    }
    // W - 1 is even: x is the even array of the last round
    const uint32_t m = mont_round<W, true>(x, y, a[W - 1], b, c, false);
    if (digits) digits[W - 1] = m;
    join_words<W>(x, y, t);
}

// t = (x + m p) / R * 2^16 in W words, x < 512p: REDC's limb k is limb
// k + 1 of t, as for mont_mul_words. digits, when given, gets m_0 .. m_top.
template <int W>
CELO_HD void redc_words(const uint32_t (&xw)[W], const FieldConsts& c,
                        uint32_t (&t)[W], uint32_t* digits = nullptr) {
    uint32_t x[W + 1], y[W + 1];
#pragma unroll
    for (int k = 0; k < W; ++k) {
        x[k] = xw[k];
        y[k] = 0;
    }
    x[W] = 0;
    y[W] = 0;
#pragma unroll
    for (int i = 0; i < W - 1; ++i) {
        const uint32_t m = (i & 1) ? redc_round<W, false>(y, x, c)
                                   : redc_round<W, false>(x, y, c);
        if (digits) digits[i] = m;
    }
    const uint32_t m = redc_round<W, true>(x, y, c);
    if (digits) digits[W - 1] = m;
    join_words<W>(x, y, t);
}

// t = a b, all 2 W words (a b < (512p)^2 < R^2 / 2^16): the same rows
// without the reduction. Row i adds a_i b, hands out the finished word i
// (even_0) and drops it; what is left after the last row is the high half.
template <int W>
CELO_HD void mul_full_words(const uint32_t (&a)[W], const uint32_t (&b)[W],
                            uint32_t (&t)[2 * W]) {
    uint32_t x[W + 1], y[W + 1];
#pragma unroll
    for (int i = 0; i < W; ++i) {
        if (i & 1) {
            mad_row<W>(y, x, a[i], b, false);
            t[i] = y[0];
        } else {
            mad_row<W>(x, y, a[i], b, i == 0);
            t[i] = x[0];
        }
    }
    // W - 1 is even: x was the last even array; the high half is y + (x >> 32)
    t[W] = y[0];
    add_cc(t[W], x[1]);
#pragma unroll
    for (int k = 1; k < W; ++k) {
        t[W + k] = y[k];
        if (k < W - 1) addc_cc(t[W + k], x[k + 1]);
        else addc(t[W + k], x[k + 1]);
    }
}

}  // namespace celo
