// The Fq12 multiply of ops/tower.py::f12_mul_plain, one lane at a time, in
// the int32 limb arithmetic of ops/field.py and the word-form Montgomery
// multiply of field_common.cuh. The kernel (f12_mul.cu) spreads a lane's
// work over threads; csrc/f12_mul_host_check.cpp runs the same functions on
// the host.
//
// An Fq12 element is 12 Fq coefficients, the leaves of ((x00, x01, x02),
// (x10, x11, x12)), each x_hs an Fq2 (c0, c1): leaf 6h + 2s + c. The output
// has the same layout.
//
// Operands. The composition is Karatsuba at every level: the Fq12 product
// multiplies three Fq6 pairs (x_0 y_0, x_1 y_1, (x_0 + x_1)(y_0 + y_1)),
// each Fq6 product six Fq2 pairs (the slots 0, 1, 2 and the sums 1 + 2,
// 0 + 1, 0 + 2), each Fq2 product three Fq pairs (c0, c1, c0 + c1): 54
// products, j = 18 H + 3 q + r for Fq6 pair H, Fq2 pair q and Fq pair r.
// Each side's operand of product j is one row that the kernel forms limb by
// limb from the side's 12 input coefficients (f12_row: the inputs and the
// pre-added sums of all three levels); a product is load_words and
// mont_mul_words on two rows, the same integer as mont_mul of the
// composition's pre-added tensors. A square (both sides the same element)
// forms one side's rows and multiplies each by itself.
//
// Combine. Limb k of the output is a fixed int32 combination of limb k of
// the 54 products (f12_combine): nothing carries across limbs, so each limb
// is formed on its own. With no int32 overflow (the sums stay within a few
// hundred times 2^16) the combination equals the composition's elementwise
// ops limb for limb, whatever the order of its additions.

#pragma once

#include "field_common.cuh"

namespace celo {

constexpr int kF12Leaves = 12;    // Fq coefficients of an Fq12, in and out
constexpr int kF12Products = 54;  // Fq products; also the operand rows of a side

// limb of the Fq6-level operand H (x_0, x_1, x_0 + x_1) at slot s, component c
CELO_HD int32_t f12_fq6_operand(int H, int s, int c, const int32_t (&x)[kF12Leaves]) {
    const int32_t lo = x[2 * s + c], hi = x[6 + 2 * s + c];
    return H == 0 ? lo : H == 1 ? hi : lo + hi;
}

// limb of the Fq2-level operand q of Fq6 pair H (slots 0, 1, 2, then the
// sums 1 + 2, 0 + 1, 0 + 2), component c
CELO_HD int32_t f12_fq2_operand(int H, int q, int c, const int32_t (&x)[kF12Leaves]) {
    if (q < 3) return f12_fq6_operand(H, q, c, x);
    const int s0 = q == 3 ? 1 : 0, s1 = q == 4 ? 1 : 2;
    return f12_fq6_operand(H, s0, c, x) + f12_fq6_operand(H, s1, c, x);
}

// limb k of operand row j of one side, from limb k of its 12 coefficients
CELO_HD int32_t f12_row(int j, const int32_t (&x)[kF12Leaves]) {
    const int H = j / 18, q = j % 18 / 3, r = j % 3;
    return r < 2 ? f12_fq2_operand(H, q, r, x)
                 : f12_fq2_operand(H, q, 0, x) + f12_fq2_operand(H, q, 1, x);
}

// product j of one lane: t = mont_mul(a_j, b_j) * 2^16 in W words, limb k
// of row j of each side at a[(j N + k) L] and b[(j N + k) L] (b == a for a
// square, whose rows are loaded once)
template <int N, int L>
CELO_HD void f12_product(int j, const int32_t* a, const int32_t* b, const FieldConsts& c,
                         uint32_t (&t)[words_of(N)]) {
    constexpr int W = words_of(N);
    uint32_t aw[W];
    load_words<N>(a + j * N * L, 0, L, c, aw);
    if (b == a) {
        mont_mul_words<W>(aw, aw, c, t);
        return;
    }
    uint32_t bw[W];
    load_words<N>(b + j * N * L, 0, L, c, bw);
    mont_mul_words<W>(aw, bw, c, t);
}

// Limb k of the 12 output coefficients from limb k of the 54 products, by
// the composition's combines: each Fq2 product (v0 - 5 v1, t - (v0 + v1));
// each Fq6 product (v0 + u (m12 - (v1 + v2)), (m01 - (v0 + v1)) + u v2,
// (m02 - (v0 + v2)) + v1) with u (a, b) = (-5 b, a); the Fq12 product
// (V0 + v V1, (T - V0) - V1) with v (c0, c1, c2) = (u c2, c0, c1).
template <class Products>
CELO_HD void f12_combine(int k, const Products& P, int32_t (&out)[kF12Leaves]) {
    int32_t f[3][3][2];  // the Fq6 products V0, V1, T: [H][slot][component]
#pragma unroll
    for (int H = 0; H < 3; ++H) {
        int32_t v[6][2];  // the Fq2 products of Fq6 pair H
#pragma unroll
        for (int q = 0; q < 6; ++q) {
            const int j = 18 * H + 3 * q;
            const int32_t p0 = P(j, k), p1 = P(j + 1, k), p2 = P(j + 2, k);
            v[q][0] = p0 - p1 * 5;
            v[q][1] = p2 - (p0 + p1);
        }
        const int32_t d0 = v[3][0] - (v[1][0] + v[2][0]), d1 = v[3][1] - (v[1][1] + v[2][1]);
        f[H][0][0] = v[0][0] + -(d1 * 5);
        f[H][0][1] = v[0][1] + d0;
        f[H][1][0] = (v[4][0] - (v[0][0] + v[1][0])) + -(v[2][1] * 5);
        f[H][1][1] = (v[4][1] - (v[0][1] + v[1][1])) + v[2][0];
        f[H][2][0] = (v[5][0] - (v[0][0] + v[2][0])) + v[1][0];
        f[H][2][1] = (v[5][1] - (v[0][1] + v[2][1])) + v[1][1];
    }
    out[0] = f[0][0][0] + -(f[1][2][1] * 5);
    out[1] = f[0][0][1] + f[1][2][0];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        out[2 + c] = f[0][1][c] + f[1][0][c];
        out[4 + c] = f[0][2][c] + f[1][1][c];
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int c = 0; c < 2; ++c) out[6 + 2 * s + c] = (f[2][s][c] - f[0][s][c]) - f[1][s][c];
}

}  // namespace celo
