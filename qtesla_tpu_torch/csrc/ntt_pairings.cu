// The five reference pipeline pairings as fused kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _pairing_kernel of
// qtesla_tpu/ops/ntt_pairings_pallas.py (l.160, polymul_pairing_fn l.276),
// one launcher per pairing:
//   qt_polymul_pairing_gs_ct     DIF forward, DIT inverse
//   qt_polymul_pairing_ct_ct     DIT forward, DIT inverse
//   qt_polymul_pairing_gs_gs     DIF forward, DIF inverse
//   qt_polymul_pairing_ct_gs     DIT forward, DIF inverse
//   qt_polymul_pairing_stockham  Stockham forward and inverse
//
// What they compute: z = x * y mod (X^n + 1) mod q through explicit psi
// weighting and cyclic transforms.  Weight both operands by phi[i] = psi^i;
// run the forward scheme on each (DIF: nat -> rev; DIT: bit-reverse, then
// rev -> nat; Stockham: nat -> nat); take the pointwise product; bit-reverse
// when the forward's output order is not the inverse's input order; run the
// inverse scheme with omega^{-1} (a DIF inverse bit-reverses its output);
// weight by phi^{-1} n^{-1}.  A cyclic stage of half-width h uses
// omega^{(j mod h) n / 2h}; Stockham stage st uses
// omega^{((j mod n/2) >> st) << st}.  Outputs are canonical in [0, q).
// Every kernel reads the compact (8, n) table (ops/tables.py
// pairing_packed), which stores the cyclic stage of half-width h at entries
// [h, 2h), so neighbouring butterflies read neighbouring entries.
//
// All five run in register passes (pass_kernel<FWD, INV, R, P, LOGN>; the
// pass machinery, its plan and the launcher's checks are in
// pass_stages.cuh).  The ends are fused into passes: the psi weighting
// into the first load, the phi^{-1} n^{-1} weighting into the last store,
// the pointwise product between the forward's last pass and the inverse's
// first, which share one window, so the product needs no exchange.  At n =
// 1024 (R = 32, one warp a row, 8 rows a block) that is two passes a
// transform, one exchange in the forward and one in the inverse, each
// behind __syncwarp() alone: no block-wide barrier.  Twiddles: a pass reads
// 2^t entries (and their Shoup companions) for its stage on window bit t,
// by __ldg, once for both operands.  n = 1024 (qtesla-iii-speed, -p-i) has
// kernels built for its length (LOGN), whose windows and stages are
// compile-time constants, so every index offset of a thread is an
// immediate of its load or store.
//
// Stockham runs the DIF's butterflies: its stage st pairs positions k and
// k + n/2 under omega^{((k mod n/2) >> st) << st}, and under its position
// map (position p at stage st is DIF index (p >> st) | brev_st(p mod 2^st)
// << (L - st)) that is the pair (j, j + h) of the DIF stage of half-width
// h = n / 2^(st+1), under the same twiddle, entry h + (j mod h).  Its
// windows follow its autosort: at the start of every pass thread t holds
// the Stockham positions t + c 2^tb of the stage the pass starts at (tb =
// L - r), the top r position bits in registers.  In DIF indices that is
// the window whose top is the pass's widest stage (b = hi - r: the last
// pass covers r stages) and the virtual thread stk_thread(t, st, tb).  So
// rows load and store in natural order, thread t at t + c 2^tb; the
// forward ends on positions t + brev_r(c) 2^tb, which the product's bit
// reversal renames to the inverse's first window.
//
// What bounds them on the H100: instruction issue, not device memory, which
// sees one read of each operand and one write of z.  A register butterfly is
// 7 instructions (3 of them IMADs); the passes add the exchanges and the
// twiddle loads.
//
// Arithmetic.  q < 2^30.  DIF stages keep values in [0, 2q), DIT stages
// take and give values below 4q; the pointwise product is exact for any
// uint32 and canonical; the final Shoup weighting takes any uint32.
//
// The launchers are extern "C" with the signature of ntt_fused.cu's
// B2-B4 (raw pointers, batch B, n, log2(n), the set's constants) plus a
// pointer to the pass plan, then a stream.  They launch without
// synchronising and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "pass_stages.cuh"

namespace {

using qt::csub;
using qt::Mod;
using qt::mulmod_barrett;
using qt::shoup_lazy;
using qt::bit_reverse;
using qt::exchange;
using qt::ilog2;
using qt::pass_stages;
using qt::PassKernel;
using qt::PassPlan;
using qt::two_pass_b;
using qt::two_pass_hi;
using qt::two_pass_lo;
using qt::window_base;

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
// an SM.
template <int FWD, int INV, int R, int P, int LOGN>
__global__ void __launch_bounds__(P == 3 ? 512 : 256, P == 2 ? 2 : 1)
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
    extern __shared__ uint32_t smem[];
    const int logn = kConst ? LOGN : logn_arg;
    const int n = kConst ? 1 << LOGN : n_arg;
    const int tb = logn - r;  // thread bits: T = 2^tb threads a row
    const int t = threadIdx.x & ((1 << tb) - 1);
    const int slot = threadIdx.x >> tb;
    const long long row = static_cast<long long>(blockIdx.x) * pl.rows + slot;
    // a row past the batch computes on row 0 and stores nothing: its
    // threads still meet every barrier
    const bool live = row < batch;
    const size_t off = live ? static_cast<size_t>(row) * n : 0;
    const bool warp_rows = tb <= 5;
    uint32_t* buf = smem + slot * pl.row_stride;
    const int stride = n + (n >> 5);
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
            exchange<kConst, R, 2>(v, buf, stride, b, vt, b2, t2, warp_rows);
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
            exchange<kConst, R, 1>(u, buf, stride, b, vt, b2, t2, warp_rows);
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

// The instantiations: R = n for n <= 32 (one pass a transform), R = 32 with
// two passes (n <= 1024) or three (n <= 16384, as the block's threads
// allow), and R = 32 in two passes built for n = 1024 (qtesla-iii-speed,
// qtesla-p-i), whose one schedule the launcher's checks leave is the one
// two_pass_* restate.
template <int FWD, int INV>
PassKernel pass_kernel_for(int radix, int passes, int logn) {
    if (radix == 32 && passes == 2 && logn == 10)
        return pass_kernel<FWD, INV, 32, 2, 10>;
    switch (radix * 4 + passes) {
        case 2 * 4 + 1: return pass_kernel<FWD, INV, 2, 1, 0>;
        case 4 * 4 + 1: return pass_kernel<FWD, INV, 4, 1, 0>;
        case 8 * 4 + 1: return pass_kernel<FWD, INV, 8, 1, 0>;
        case 16 * 4 + 1: return pass_kernel<FWD, INV, 16, 1, 0>;
        case 32 * 4 + 1: return pass_kernel<FWD, INV, 32, 1, 0>;
        case 32 * 4 + 2: return pass_kernel<FWD, INV, 32, 2, 0>;
        case 32 * 4 + 3: return pass_kernel<FWD, INV, 32, 3, 0>;
        default: return nullptr;
    }
}

// A DIT transform runs from the narrowest stage up; DIF and Stockham from
// the widest down.  A bit reversal lies between the two transforms unless
// a DIT inverse takes a DIF forward's rev order or a DIT forward's nat
// order goes into a DIF inverse.
template <int FWD, int INV>
int launch_passes(const void* a, const void* b, void* out, const void* tw,
                  long long batch, int n, int logn, uint32_t q, uint32_t r32,
                  uint32_t r32_sh, uint32_t one_sh, const void* plan,
                  void* stream) {
    if (!plan) return cudaErrorInvalidValue;
    const PassPlan pl = *static_cast<const PassPlan*>(plan);
    const qt::PassOrder order{FWD == kDit, INV == kDit,
                              (FWD != kDit) != (INV == kDit), FWD == kStk};
    return qt::launch_pass_kernel(
        pass_kernel_for<FWD, INV>(pl.radix, pl.passes, logn), pl, order, a,
        b, out, tw, batch, n, logn, q, r32, r32_sh, one_sh, stream);
}

}  // namespace

#define QT_PAIRING_LAUNCHER(name, fwd, inv)                                   \
    extern "C" int name(const void* a, const void* b, void* out,              \
                        const void* tw, long long batch, int n, int logn,     \
                        uint32_t q, uint32_t r32, uint32_t r32_sh,            \
                        uint32_t one_sh, const void* plan, void* stream) {    \
        return launch_passes<fwd, inv>(a, b, out, tw, batch, n, logn, q, r32, \
                                       r32_sh, one_sh, plan, stream);         \
    }

QT_PAIRING_LAUNCHER(qt_polymul_pairing_gs_ct, kDif, kDit)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_ct_ct, kDit, kDit)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_gs_gs, kDif, kDif)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_ct_gs, kDit, kDif)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_stockham, kStk, kStk)
