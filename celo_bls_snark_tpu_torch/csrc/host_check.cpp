// Host build of the word arithmetic of field_common.cuh, for checking it
// against integers without a card (the .cu sources build only with nvcc):
//
//   g++ -std=c++17 -O1 -o host_check host_check.cpp
//   ./host_check < vectors.txt > results.txt
//
// Input, whitespace-separated integers: n B n0inv32, then n limbs of 256p,
// W = ceil(n / 2) words of p, then a and b as [n, B] lazy limbs, row-major.
// Output, one line a lane: the n limbs of mont_mul_words' product, the W
// digits m_0 .. m_top of its rounds, the 2n limbs of mul_full_words'
// product, then the n limbs of redc_words(a) and the W digits of its rounds.

#include <cstdio>
#include <cstdlib>
#include <vector>

#include "field_common.cuh"

using namespace celo;

template <int N>
int run(int64_t B, const FieldConsts& c, const std::vector<int32_t>& a,
        const std::vector<int32_t>& b) {
    constexpr int W = words_of(N);
    for (int64_t lane = 0; lane < B; ++lane) {
        uint32_t aw[W], bw[W], t[W], full[2 * W];
        load_words<N>(a.data(), lane, B, c, aw);
        load_words<N>(b.data(), lane, B, c, bw);
        uint32_t digits[W];
        mont_mul_words<W>(aw, bw, c, t, digits);
        for (int k = 0; k < N; ++k) std::printf("%u ", limb_of<W>(t, k + 1));
        for (int i = 0; i < W; ++i) std::printf("%u ", digits[i]);
        mul_full_words<W>(aw, bw, full);
        for (int k = 0; k < 2 * N; ++k) std::printf("%u ", limb_of<2 * W>(full, k));
        redc_words<W>(aw, c, t, digits);
        for (int k = 0; k < N; ++k) std::printf("%u ", limb_of<W>(t, k + 1));
        for (int i = 0; i < W; ++i) std::printf("%u ", digits[i]);
        std::printf("\n");
    }
    return 0;
}

int main() {
    long long n, B, n0inv32, v;
    if (std::scanf("%lld %lld %lld", &n, &B, &n0inv32) != 3) return 2;
    if (n < 1 || n > kMaxLimbs || n % 2 == 0 || B < 1) return 2;
    FieldConsts c = {};
    c.n0inv32 = static_cast<uint32_t>(n0inv32);
    for (int k = 0; k < n; ++k) { if (std::scanf("%lld", &v) != 1) return 2; c.offset[k] = static_cast<int32_t>(v); }
    for (int j = 0; j < words_of(n); ++j) { if (std::scanf("%lld", &v) != 1) return 2; c.pw[j] = static_cast<uint32_t>(v); }
    std::vector<int32_t> a(n * B), b(n * B);
    for (auto* x : {&a, &b})
        for (auto& e : *x) { if (std::scanf("%lld", &v) != 1) return 2; e = static_cast<int32_t>(v); }
    switch (n) {
        case 17: return run<17>(B, c, a, b);
        case 25: return run<25>(B, c, a, b);
        case 49: return run<49>(B, c, a, b);
        default: return 2;
    }
}
