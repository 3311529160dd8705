// Modular arithmetic on uint32 residues, shared by the kernels of this
// directory.  q < 2^30, so 4q < 2^32.
#pragma once

#include <cstdint>

namespace qt {

struct Mod {
    uint32_t q, r32, r32_sh, one_sh;
};

__device__ __forceinline__ uint32_t csub(uint32_t v, uint32_t b) {
    return v >= b ? v - b : v;
}

// x * w mod q in [0, 2q) for any uint32 x, constant w < q,
// w_sh = floor(w * 2^32 / q).
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w,
                                               uint32_t w_sh, uint32_t q) {
    return x * w - __umulhi(x, w_sh) * q;
}

// x * y mod q, canonical, for any uint32 x, y: the 64-bit product folded as
// hi * (2^32 mod q) + lo.
__device__ __forceinline__ uint32_t mulmod_barrett(uint32_t x, uint32_t y,
                                                   const Mod& m) {
    const uint32_t hi = __umulhi(x, y);
    const uint32_t lo = x * y;
    const uint32_t a = csub(shoup_lazy(hi, m.r32, m.r32_sh, m.q), m.q);
    const uint32_t b = csub(shoup_lazy(lo, 1u, m.one_sh, m.q), m.q);
    return csub(a + b, m.q);
}

}  // namespace qt
