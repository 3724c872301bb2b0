// Host build of the Fq12 multiply's per-lane arithmetic (f12_mul.cuh: the
// same functions the kernel of f12_mul.cu runs), for checking it against
// ops/tower.py's composition without a card:
//
//   g++ -std=c++17 -O1 -o f12_mul_host_check f12_mul_host_check.cpp
//   ./f12_mul_host_check < vectors.txt > results.txt
//
// Input, whitespace-separated integers: n B sides depth n0inv32, then n
// limbs of 256p, W = ceil(n / 2) words of p, then the input coefficients
// as [12, n, B] lazy limbs, row-major, of a and (sides = 2) of b. sides = 2
// multiplies a by b once; sides = 1 squares a `depth` times in a row (the
// output of one squaring is the input of the next), as the kernel's square
// does. Output, one line a lane: the 12 x n limbs of the result,
// coefficient by coefficient.

#include <cstdio>
#include <vector>

#include "f12_mul.cuh"

using namespace celo;

// one multiply of one lane in the kernel's phases: each side's operand
// rows, the 54 products, the combination; x, y: [12][N] leaves (y == x for
// a square), the result to x
template <int N>
void multiply(std::vector<int32_t>& x, const std::vector<int32_t>* y, const FieldConsts& c) {
    constexpr int W = words_of(N);
    const int sides = y ? 2 : 1;
    std::vector<int32_t> rows(sides * kF12Products * N);  // [sides][54][N]
    for (int side = 0; side < sides; ++side) {
        const std::vector<int32_t>& z = side ? *y : x;
        for (int k = 0; k < N; ++k) {
            int32_t v[kF12Leaves];
            for (int i = 0; i < kF12Leaves; ++i) v[i] = z[i * N + k];
            for (int j = 0; j < kF12Products; ++j)
                rows[(side * kF12Products + j) * N + k] = f12_row(j, v);
        }
    }
    const int32_t* a = rows.data();
    const int32_t* b = sides == 2 ? a + kF12Products * N : a;
    std::vector<uint32_t> prods(kF12Products * W);
    for (int j = 0; j < kF12Products; ++j) {
        uint32_t t[W];
        f12_product<N, 1>(j, a, b, c, t);
        for (int w = 0; w < W; ++w) prods[j * W + w] = t[w];
    }
    const LaneProducts<N, 1> r{prods.data()};
    for (int k = 0; k < N; ++k) {
        int32_t o[kF12Leaves];
        f12_combine(k, r, o);
        for (int i = 0; i < kF12Leaves; ++i) x[i * N + k] = o[i];
    }
}

template <int N>
int run(int64_t B, int sides, int depth, const FieldConsts& c,
        const std::vector<int32_t>& in) {
    const int64_t coeffs = kF12Leaves * N;
    for (int64_t lane = 0; lane < B; ++lane) {
        std::vector<int32_t> x(coeffs), y(coeffs);  // [12][N]
        for (int64_t e = 0; e < coeffs; ++e) {
            x[e] = in[e * B + lane];
            if (sides == 2) y[e] = in[(coeffs + e) * B + lane];
        }
        for (int d = 0; d < depth; ++d) multiply<N>(x, sides == 2 ? &y : nullptr, c);
        for (int32_t limb : x) std::printf("%d ", limb);
        std::printf("\n");
    }
    return 0;
}

int main() {
    long long n, B, sides, depth, n0inv32, v;
    if (std::scanf("%lld %lld %lld %lld %lld", &n, &B, &sides, &depth, &n0inv32) != 5) return 2;
    if (n != 25 || B < 1 || (sides != 1 && sides != 2) || depth < 0 ||
        (sides == 2 && depth != 1))
        return 2;
    FieldConsts c = {};
    c.n0inv32 = static_cast<uint32_t>(n0inv32);
    for (int k = 0; k < n; ++k) { if (std::scanf("%lld", &v) != 1) return 2; c.offset[k] = static_cast<int32_t>(v); }
    for (int j = 0; j < words_of(n); ++j) { if (std::scanf("%lld", &v) != 1) return 2; c.pw[j] = static_cast<uint32_t>(v); }
    std::vector<int32_t> z(sides * kF12Leaves * n * B);
    for (auto& e : z) { if (std::scanf("%lld", &v) != 1) return 2; e = static_cast<int32_t>(v); }
    return run<25>(B, static_cast<int>(sides), static_cast<int>(depth), c, z);
}
