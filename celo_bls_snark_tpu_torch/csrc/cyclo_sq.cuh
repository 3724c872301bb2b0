// The Granger-Scott cyclotomic squaring of ops/tower.py::f12_cyclo_sq_plain,
// one Fq12 lane at a time, in the int32 limb arithmetic of ops/field.py and
// the word-form Montgomery multiply of field_common.cuh. The kernel
// (cyclo_sq.cu) spreads a lane's work over threads; csrc/
// cyclo_sq_host_check.cpp runs the same functions on the host.
//
// An Fq12 element is 12 Fq coefficients, the leaves of
// ((z0, z4, z3), (z2, z1, z5)) in order, each z_i an Fq2 (c0, c1): z_i's
// component c is leaf 2 slot(i) + c, slot = (0, 4, 3, 2, 1, 5). The output
// has the same layout.
//
// Operands. For each of the three Fq4 squarings g, (za, zb) = (z_2g,
// z_2g+1), six Fq products (the Karatsuba triples of za zb and of
// (za + zb)(za + u zb), u zb = (-5 zb_1, zb_0)), products 6g .. 6g + 5;
// then the 12 canonicalizations z_i,c x one, products 18 + 2i + c. Every
// operand is one of 12 rows a squaring forms from its four input
// coefficients limb by limb (cyclo_rows: the inputs and eight pre-added
// sums), or the constant one; a product is load_words and mont_mul_words on
// two rows, the same integer as mont_mul of the composition's pre-added
// tensors.
//
// Combine. Limb k of the output is a fixed int32 combination of limb k of
// the products (cyclo_combine): nothing carries across limbs, so each limb
// is formed on its own. With no int32 overflow (the sums stay within a few
// hundred times 2^16) the combination equals the composition's elementwise
// ops limb for limb, whatever the order of its additions.

#pragma once

#include "field_common.cuh"

namespace celo {

constexpr int kCycloLeaves = 12;    // Fq coefficients of an Fq12, in and out
constexpr int kCycloProducts = 30;  // 18 of the squarings, 12 canonicalizations
constexpr int kCycloRowsPerSq = 12; // operand rows a squaring forms
constexpr int kCycloOne = 3 * kCycloRowsPerSq;  // the row of the constant one
constexpr int kCycloRows = kCycloOne + 1;

// slot of z_i among the six Fq2 leaves of ((z0, z4, z3), (z2, z1, z5))
CELO_HD_CONSTEXPR int cyclo_slot(int i) {
    return i == 0 ? 0 : i == 1 ? 4 : i == 2 ? 3 : i == 3 ? 2 : i == 4 ? 1 : 5;
}

// the input leaves of squaring g: za_0, za_1, zb_0, zb_1
CELO_HD void cyclo_inputs(int g, int (&leaf)[4]) {
    const int a = 2 * cyclo_slot(2 * g), b = 2 * cyclo_slot(2 * g + 1);
    leaf[0] = a;
    leaf[1] = a + 1;
    leaf[2] = b;
    leaf[3] = b + 1;
}

// limb k of squaring g's operand rows 12g .. 12g + 11 from limb k of its
// inputs: the inputs, then the sums the composition forms, x = za + zb and
// y = za + u zb
CELO_HD void cyclo_rows(int32_t a0, int32_t a1, int32_t b0, int32_t b1,
                        int32_t (&v)[kCycloRowsPerSq]) {
    const int32_t x0 = a0 + b0, y0 = a0 + -(b1 * 5), x1 = a1 + b1, y1 = a1 + b0;
    v[0] = a0;
    v[1] = a1;
    v[2] = b0;
    v[3] = b1;
    v[4] = a0 + a1;
    v[5] = b0 + b1;
    v[6] = x0;
    v[7] = y0;
    v[8] = x1;
    v[9] = y1;
    v[10] = x0 + x1;
    v[11] = y0 + y1;
}

// the operand rows of product j: za_0 zb_0, za_1 zb_1, (za_0 + za_1)(zb_0
// + zb_1), x_0 y_0, x_1 y_1, (x_0 + x_1)(y_0 + y_1) of squaring j / 6;
// z_i,c x one for j = 18 + 2i + c
CELO_HD void cyclo_operands(int j, int& ra, int& rb) {
    if (j >= 18) {
        const int i = (j - 18) / 2, c = (j - 18) % 2;
        ra = kCycloRowsPerSq * (i / 2) + (i % 2 == 0 ? 0 : 2) + c;
        rb = kCycloOne;
        return;
    }
    const int g = j / 6, q = j % 6;
    ra = kCycloRowsPerSq * g + (q < 2 ? q : 2 * q);
    rb = kCycloRowsPerSq * g + (q < 2 ? q + 2 : 2 * q + 1);
}

// The operand rows of one lane: limb k of row r at p[(r * N + k) * L]. The
// kernel keeps the rows of its L lanes side by side in shared memory (p at
// the lane); the host check keeps one lane (L = 1).
template <int N, int L>
struct CycloRows {
    const int32_t* p;
    CELO_HD int32_t operator()(int r, int k) const { return p[(r * N + k) * L]; }
};

// product j of one lane: t = mont_mul(a_j, b_j) * 2^16 in W words
template <int N, int L>
CELO_HD void cyclo_product(int j, const CycloRows<N, L>& z, const FieldConsts& c,
                           uint32_t (&t)[words_of(N)]) {
    constexpr int W = words_of(N);
    int ra, rb;
    cyclo_operands(j, ra, rb);
    const CycloRows<N, L> a{z.p + ra * N * L}, b{z.p + rb * N * L};
    int32_t al[N], bl[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
        al[k] = a(0, k);
        bl[k] = b(0, k);
    }
    uint32_t aw[W], bw[W];
    load_words<N>(al, 0, 1, c, aw);
    load_words<N>(bl, 0, 1, c, bw);
    mont_mul_words<W>(aw, bw, c, t);
}

// Limb k of the two outputs of squaring g, from limb k of the products:
// tmp = za zb and s = (za + zb)(za + u zb) by their Karatsuba combines,
// t_a = s - tmp - u tmp and t_b = 2 tmp (times u for g = 2), then
// 3 t_a - 2 z_m and 3 t_b + 2 z_p with the canonical z. out = (m_0, m_1,
// p_0, p_1), to leaves 2 m_slot + c and 2 p_slot + c.
template <class Products>
CELO_HD void cyclo_combine(int g, int k, const Products& r, int32_t (&out)[4],
                           int& m_slot, int& p_slot) {
    const int j = 6 * g;
    const int32_t v0 = r(j, k), v1 = r(j + 1, k), v2 = r(j + 2, k);
    const int32_t tmp0 = v0 - v1 * 5, tmp1 = v2 - (v0 + v1);
    const int32_t w0 = r(j + 3, k), w1 = r(j + 4, k), w2 = r(j + 5, k);
    const int32_t s0 = w0 - w1 * 5, s1 = w2 - (w0 + w1);
    const int32_t ta0 = (s0 - tmp0) + tmp1 * 5, ta1 = (s1 - tmp1) - tmp0;
    int32_t tb0 = tmp0 + tmp0, tb1 = tmp1 + tmp1;
    if (g == 2) {  // u t_5 = (-5 t_5,1, t_5,0)
        const int32_t x = tb0;
        tb0 = -(tb1 * 5);
        tb1 = x;
    }
    // (t_a, z_m) and (t_b, z_p): (t0, z0), (t1, z1); (t2, z4), (t3, z5);
    // (t4, z3), (u t5, z2)
    const int im = g == 0 ? 0 : g == 1 ? 4 : 3;
    const int ip = g == 0 ? 1 : g == 1 ? 5 : 2;
    const int32_t zm0 = r(18 + 2 * im, k), zm1 = r(19 + 2 * im, k);
    const int32_t zp0 = r(18 + 2 * ip, k), zp1 = r(19 + 2 * ip, k);
    const int32_t dm0 = ta0 - zm0, dm1 = ta1 - zm1;
    const int32_t dp0 = tb0 + zp0, dp1 = tb1 + zp1;
    out[0] = (dm0 + dm0) + ta0;
    out[1] = (dm1 + dm1) + ta1;
    out[2] = (dp0 + dp0) + tb0;
    out[3] = (dp1 + dp1) + tb1;
    m_slot = cyclo_slot(im);
    p_slot = cyclo_slot(ip);
}

}  // namespace celo
