// Shared by field.cu and field_tc.cu: the field constants as a kernel
// parameter and the lazy-limb load of ops/field.py's data contract (a field
// batch is a row-major [n, B] int32 array, limb k of lane l at k * B + l;
// inputs are lazy signed limbs, |limb| < 2^26, value in (-256p, 256p)).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace celo {

constexpr uint32_t kMask = 0xFFFFu;
constexpr int kMaxLimbs = 49;

struct FieldConsts {
    uint32_t p[kMaxLimbs];
    int32_t offset[kMaxLimbs];
    uint32_t n0inv;
};

// lazy int32 limbs of one lane -> canonical limbs of (value + 256p)
template <int N>
__device__ __forceinline__ void load_normalized(const int32_t* __restrict__ x,
                                                int64_t lane, int64_t B,
                                                const FieldConsts& c,
                                                uint32_t (&out)[N]) {
    int32_t carry = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        int32_t v = x[k * B + lane] + c.offset[k] + carry;
        carry = v >> 16;  // arithmetic shift: floor division
        out[k] = static_cast<uint32_t>(v - (carry << 16));
    }
    // value + 256p lies in (0, 512p) < R: the carry out is 0
}

inline int fill_consts(int n, const uint32_t* p, const int32_t* offset,
                       uint32_t n0inv, FieldConsts* c) {
    if (n < 1 || n > kMaxLimbs) return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < kMaxLimbs; ++k) {
        c->p[k] = k < n ? p[k] : 0;
        c->offset[k] = k < n ? offset[k] : 0;
    }
    c->n0inv = n0inv;
    return 0;
}

}  // namespace celo
