// Host build of the cyclotomic squaring's per-lane arithmetic
// (cyclo_sq.cuh: the same functions the kernel of cyclo_sq.cu runs), for
// checking it against ops/tower.py's composition without a card:
//
//   g++ -std=c++17 -O1 -o cyclo_sq_host_check cyclo_sq_host_check.cpp
//   ./cyclo_sq_host_check < vectors.txt > results.txt
//
// Input, whitespace-separated integers: n B depth n0inv32, then n limbs of
// 256p, W = ceil(n / 2) words of p, the n limbs of the Montgomery one, then
// the 12 input coefficients as [12, n, B] lazy limbs, row-major. Each lane
// is squared `depth` times in a row (the output of one squaring is the
// input of the next). Output, one line a lane: the 12 x n limbs of the
// result, coefficient by coefficient.

#include <cstdio>
#include <vector>

#include "cyclo_sq.cuh"

using namespace celo;

// one squaring of one lane, in the kernel's phases: the operand rows, the
// 30 products, the combination; z: [12][N] leaves, one: [N]
template <int N>
void square(std::vector<int32_t>& z, const std::vector<int32_t>& one,
            const FieldConsts& c) {
    constexpr int W = words_of(N);
    std::vector<int32_t> rows(kCycloRows * N);  // [37][N]
    for (int g = 0; g < 3; ++g) {
        int leaf[4];
        cyclo_inputs(g, leaf);
        for (int k = 0; k < N; ++k) {
            int32_t v[kCycloRowsPerSq];
            cyclo_rows(z[leaf[0] * N + k], z[leaf[1] * N + k], z[leaf[2] * N + k],
                       z[leaf[3] * N + k], v);
            for (int r = 0; r < kCycloRowsPerSq; ++r)
                rows[(kCycloRowsPerSq * g + r) * N + k] = v[r];
        }
    }
    for (int k = 0; k < N; ++k) rows[kCycloOne * N + k] = one[k];
    std::vector<uint32_t> prods(kCycloProducts * W);
    for (int j = 0; j < kCycloProducts; ++j) {
        uint32_t t[W];
        cyclo_product<N, 1>(j, CycloRows<N, 1>{rows.data()}, c, t);
        for (int w = 0; w < W; ++w) prods[j * W + w] = t[w];
    }
    const LaneProducts<N, 1> r{prods.data()};
    for (int g = 0; g < 3; ++g)
        for (int k = 0; k < N; ++k) {
            int32_t o[4];
            int ms, ps;
            cyclo_combine(g, k, r, o, ms, ps);
            z[(2 * ms) * N + k] = o[0];
            z[(2 * ms + 1) * N + k] = o[1];
            z[(2 * ps) * N + k] = o[2];
            z[(2 * ps + 1) * N + k] = o[3];
        }
}

template <int N>
int run(int64_t B, int depth, const FieldConsts& c, const std::vector<int32_t>& one,
        const std::vector<int32_t>& in) {
    for (int64_t lane = 0; lane < B; ++lane) {
        std::vector<int32_t> z(kCycloLeaves * N);  // [12][N]
        for (int e = 0; e < kCycloLeaves * N; ++e) z[e] = in[e * B + lane];
        for (int d = 0; d < depth; ++d) square<N>(z, one, c);
        for (int32_t limb : z) std::printf("%d ", limb);
        std::printf("\n");
    }
    return 0;
}

int main() {
    long long n, B, depth, n0inv32, v;
    if (std::scanf("%lld %lld %lld %lld", &n, &B, &depth, &n0inv32) != 4) return 2;
    if (n != 25 || B < 1 || depth < 0) return 2;
    FieldConsts c = {};
    c.n0inv32 = static_cast<uint32_t>(n0inv32);
    for (int k = 0; k < n; ++k) { if (std::scanf("%lld", &v) != 1) return 2; c.offset[k] = static_cast<int32_t>(v); }
    for (int j = 0; j < words_of(n); ++j) { if (std::scanf("%lld", &v) != 1) return 2; c.pw[j] = static_cast<uint32_t>(v); }
    std::vector<int32_t> one(n), z(kCycloLeaves * n * B);
    for (auto* x : {&one, &z})
        for (auto& e : *x) { if (std::scanf("%lld", &v) != 1) return 2; e = static_cast<int32_t>(v); }
    return run<25>(B, static_cast<int>(depth), c, one, z);
}
