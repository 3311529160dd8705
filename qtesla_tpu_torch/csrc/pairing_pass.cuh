// The five pairings' pass kernel (pass_kernel<FWD, INV, R, P, LOGN,
// kCluster>), shared by ntt_pairings.cu, which instantiates its block forms
// and launches every form, and ntt_pairings_cluster.cu, which instantiates
// its cluster forms (a row across a thread-block cluster, n >= 32768) in a
// compilation unit of their own, so that the two build side by side.  The
// design and arithmetic are described at the top of ntt_pairings.cu.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "pass_stages.cuh"

namespace qt {
namespace pairing {

enum Scheme { kDif, kDit, kStk };

// The (8, n) table, rows: forward stage twiddles (entry h + j of the stage
// of half-width h), their Shoup companions, the inverse stage twiddles, their
// Shoup companions, phi, its Shoup, phi^{-1} n^{-1}, its Shoup.
struct Twiddles {
    const uint32_t *w, *w_sh, *iw, *iw_sh, *phi, *phi_sh, *iphi, *iphi_sh;
};

__device__ __forceinline__ Twiddles twiddles(const uint32_t* tw, int n) {
    return {tw,         tw + n,     tw + 2 * n, tw + 3 * n,
            tw + 4 * n, tw + 5 * n, tw + 6 * n, tw + 7 * n};
}

// Stockham's thread map: the DIF virtual thread whose window [tb - st,
// L - st) holds the Stockham positions t + c 2^tb of stage st, (t >> st) |
// brev_st(t mod 2^st) << (tb - st).
__device__ __forceinline__ int stk_thread(int t, int st, int tb) {
    const int rev =
        st == 0 ? 0
                : static_cast<int>(__brev(static_cast<unsigned>(t)) >>
                                   (32 - st));
    return (t >> st) | (rev << (tb - st));
}

// LOGN > 0: built for n = 2^LOGN in two passes, the planner's schedule
// known at compile time, so every index offset of a thread is a constant.
// Two passes: 128 registers at most, so 16 warps (16 rows at n = 1024) fit
// an SM.  kCluster: a row spans the blocks of a cluster (n >= 32768,
// pass_stages.cuh), 512 threads a block.
template <int FWD, int INV, int R, int P, int LOGN, bool kCluster>
__global__ void __launch_bounds__(P >= 3 ? 512 : 256, P == 2 ? 2 : 1)
    pass_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                uint32_t* __restrict__ z, const uint32_t* __restrict__ tw,
                long long batch, int n_arg, int logn_arg, Mod m, uint32_t q2,
                PassPlan pl) {
    static_assert(LOGN == 0 || P == 2, "one length: two passes");
    static_assert((FWD == kStk) == (INV == kStk), "Stockham both ways");
    constexpr int r = ilog2(R);
    constexpr bool kConst = LOGN > 0;
    constexpr bool kStock = FWD == kStk;
    // Stockham's two passes built for one length are the two halves
    static_assert(!kStock || LOGN == 0 || LOGN == 2 * r, "Stockham: L = 2r");
    static_assert(!kCluster || (LOGN == 0 && P >= 3), "a cluster: P >= 3");
    extern __shared__ uint32_t smem[];
    const int logn = kConst ? LOGN : logn_arg;
    const int n = kConst ? 1 << LOGN : n_arg;
    const int tb = logn - r;  // thread bits: T = 2^tb threads a row
    const qt::RowPlace<kCluster> at(pl, tb, logn);
    const int t = at.t;
    const long long row = at.row;
    // a row past the batch computes on row 0 and stores nothing: its
    // threads still meet every barrier
    const bool live = row < batch;
    const size_t off = live ? static_cast<size_t>(row) * n : 0;
    const bool warp_rows = tb <= 5;
    uint32_t* buf = smem + at.slot * pl.row_stride;
    // words an operand: the row's n indices, or a cluster block's share
    const int stride =
        kCluster ? (1 << at.lbits) + (1 << at.lbits >> 5) : n + (n >> 5);
    const Twiddles w = twiddles(tw, n);
    const uint32_t q = m.q;

    // pass p's stages and window: the plan's, or the planner's two-pass
    // schedule for the length the kernel was built for
    const auto lo = [](bool up, int planned, int p) {
        return kConst ? two_pass_lo(up, p, LOGN) : planned;
    };
    const auto hi = [](bool up, int planned, int p) {
        return kConst ? two_pass_hi(up, p, LOGN) : planned;
    };
    const auto win = [](bool up, int planned, int p) {
        return kConst ? two_pass_b(up, p, LOGN, r) : planned;
    };
    // the thread that takes the window after an exchange: t, or under
    // Stockham's map the one whose window holds positions t + c 2^tb of the
    // stage the pass starts at, L - hi
    const auto next_thread = [&](int pass_hi) {
        return kStock ? stk_thread(t, logn - pass_hi, tb) : t;
    };

    // psi weighting on the way in, [0, 2q); the window [tb, L) reads
    // neighbouring columns with neighbouring threads
    uint32_t v[2][R];
    int b = tb, vt = t;
    {
        const int base = window_base(vt, b, r);
#pragma unroll
        for (int c = 0; c < R; ++c) {
            const int i = base + (c << b);
            const uint32_t p = __ldg(w.phi + i), p_sh = __ldg(w.phi_sh + i);
            v[0][c] = shoup_lazy(x[off + i], p, p_sh, q);
            v[1][c] = shoup_lazy(y[off + i], p, p_sh, q);
        }
    }
    if (FWD == kDit) bit_reverse<R, 2>(v, b, vt, tb);
    constexpr bool kFwdCt = FWD == kDit, kInvCt = INV == kDit;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int p_hi = hi(kFwdCt, pl.fwd_hi[p], p);
        if (p > 0) {
            const int b2 = win(kFwdCt, pl.fwd_b[p], p);
            const int t2 = next_thread(p_hi);
            qt::row_exchange<kCluster, kConst, R, 2>(v, buf, stride, b, vt,
                                                     b2, t2, warp_rows, pl,
                                                     p - 1, at.lbits);
            b = b2;
            vt = t2;
        }
        pass_stages<kFwdCt, R, 2>(v, b, vt, lo(kFwdCt, pl.fwd_lo[p], p), p_hi,
                                  w.w, w.w_sh, q, q2);
    }

    uint32_t u[1][R];
#pragma unroll
    for (int c = 0; c < R; ++c) u[0][c] = mulmod_barrett(v[0][c], v[1][c], m);
    // a DIF or Stockham forward gives rev order in DIF indices, a DIT
    // inverse takes it
    if ((FWD != kDit) != (INV == kDit)) bit_reverse<R, 1>(u, b, vt, tb);
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int p_hi = hi(kInvCt, pl.inv_hi[p], p);
        if (p > 0) {
            const int b2 = win(kInvCt, pl.inv_b[p], p);
            const int t2 = next_thread(p_hi);
            qt::row_exchange<kCluster, kConst, R, 1>(u, buf, stride, b, vt,
                                                     b2, t2, warp_rows, pl,
                                                     P + p - 2, at.lbits);
            b = b2;
            vt = t2;
        }
        pass_stages<kInvCt, R, 1>(u, b, vt, lo(kInvCt, pl.inv_lo[p], p), p_hi,
                                  w.iw, w.iw_sh, q, q2);
    }
    if (INV != kDit) bit_reverse<R, 1>(u, b, vt, tb);

    // phi^{-1} n^{-1} on the way out, canonical
    if (live) {
        const int base = window_base(vt, b, r);
#pragma unroll
        for (int c = 0; c < R; ++c) {
            const int i = base + (c << b);
            z[off + i] = csub(shoup_lazy(u[0][c], __ldg(w.iphi + i),
                                         __ldg(w.iphi_sh + i), q),
                              q);
        }
    }
}

// The cluster forms' kernel for R = 32 in `passes` passes (3: n = 32768; 4:
// n = 65536, 131072), null for any other; defined and instantiated for the
// five pairings in ntt_pairings_cluster.cu.
template <int FWD, int INV>
PassKernel cluster_pass_kernel(int passes);

}  // namespace pairing
}  // namespace qt
