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
// From n = 32768 to 131072 a row spans a thread-block cluster of 2, 4 or 8
// blocks of 512 threads (pass_kernel<.., true>; pass_stages.cuh), in three
// passes or four, one launch a call.
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
// The kernel template is pass_kernel in pairing_pass.cuh; this file
// instantiates its block forms, ntt_pairings_cluster.cu its cluster forms,
// so that the two compile side by side.
//
// The launchers are extern "C" with the signature of ntt_fused.cu's
// B2-B4 (raw pointers, batch B, n, log2(n), the set's constants) plus a
// pointer to the pass plan, then a stream.  They launch without
// synchronising and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "pairing_pass.cuh"

namespace {

using qt::PassKernel;
using qt::PassPlan;
using qt::pairing::kDif;
using qt::pairing::kDit;
using qt::pairing::kStk;
using qt::pairing::pass_kernel;

// The instantiations: R = n for n <= 32 (one pass a transform), R = 32 with
// two passes (n <= 1024) or three (n <= 16384, as the block's threads
// allow), and R = 32 in two passes built for n = 1024 (qtesla-iii-speed,
// qtesla-p-i), whose one schedule the launcher's checks leave is the one
// two_pass_* restate; in a cluster R = 32 in three passes (n = 32768) or
// four (n = 65536, 131072).
template <int FWD, int INV>
PassKernel pass_kernel_for(int radix, int passes, int logn, int cluster) {
    if (cluster > 1)
        return radix == 32
                   ? qt::pairing::cluster_pass_kernel<FWD, INV>(passes)
                   : nullptr;
    if (radix == 32 && passes == 2 && logn == 10)
        return pass_kernel<FWD, INV, 32, 2, 10, false>;
    switch (radix * 4 + passes) {
        case 2 * 4 + 1: return pass_kernel<FWD, INV, 2, 1, 0, false>;
        case 4 * 4 + 1: return pass_kernel<FWD, INV, 4, 1, 0, false>;
        case 8 * 4 + 1: return pass_kernel<FWD, INV, 8, 1, 0, false>;
        case 16 * 4 + 1: return pass_kernel<FWD, INV, 16, 1, 0, false>;
        case 32 * 4 + 1: return pass_kernel<FWD, INV, 32, 1, 0, false>;
        case 32 * 4 + 2: return pass_kernel<FWD, INV, 32, 2, 0, false>;
        case 32 * 4 + 3: return pass_kernel<FWD, INV, 32, 3, 0, false>;
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
        pass_kernel_for<FWD, INV>(pl.radix, pl.passes, logn, pl.cluster), pl,
        order, a,
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
