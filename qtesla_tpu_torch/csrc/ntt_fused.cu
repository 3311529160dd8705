// Fused merged-psi negacyclic NTT kernels for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of qtesla_tpu/ops/ntt_pallas.py:
//   qt_polymul_fused        <- _polymul_kernel       (l.100, polymul_fused_fn)
//   qt_polymul_fixed_fused  <- _polymul_fixed_kernel (l.112, polymul_fixed_fused_fn)
//   qt_ntt_fused            <- _ntt_kernel           (l.123, ntt_fused_fn)
//   qt_intt_fused           <- _intt_kernel          (l.129, intt_fused_fn)
//
// What they compute: merged-psi Cooley-Tukey forward (natural -> bit-reversed
// order, psi folded into the twiddles), the generic pointwise product, and
// the merged-psi Gentleman-Sande inverse with n^{-1} folded into its last
// stage.  All data are uint32 residues; outputs are canonical in [0, q).
// Every kernel reads the compact n-entry tables (ops/tables.py, packed as 4
// rows: psi_rev, its Shoup companion, psi^{-1}_rev with n^{-1} folded, its
// Shoup companion), which stay resident in L1/L2: forward stage s, block i
// uses entry 2^s + i; the inverse stage with h blocks, block i, entry h + i.
//
// B1 (qt_polymul_fused, polymul_pass_kernel) runs in register passes
// (pass_stages.cuh): a row of n values is held by n / R threads, R values of
// each operand a thread, and a pass runs up to log2(R) stages in registers
// between exchanges through padded shared memory.  Its schedule is gs_ct's
// window sequence (ntt_pairings.cu): the forward's CT butterflies from the
// widest stage down, starting on the window [tb, L) where the load leaves a
// row and ending on [0, r); the inverse's GS butterflies from the narrowest
// stage up, starting where the forward ended, so the pointwise product sits
// between them in registers, with no exchange and no bit reversal.  The
// stage on index bit k reads entry 2^(L-1-k) + (j >> (k+1)), the bits of the
// index above the stage; in the window [0, r) these are the thread's, so
// the threads of a warp read 2^(L-1-k) different entries, each thread its
// own neighbouring ones, which it reads up to four at a time (16-byte
// loads: 0.74x the time of one word a load on an H100, PERF.md).  The inverse's last stage (k = L - 1, always on the
// top register bit of the last window [tb, L)) multiplies the sum branch by
// entry 0 = n^{-1} and the difference branch by entry 1, reduces both to
// canonical and is fused into the store.  No phi weighting: psi is merged
// into the twiddles.  n = 1024 (qtesla-iii-speed, -p-i) has a kernel built
// for its length, whose every index offset is an immediate.  The plan
// (ops/ntt_fused.py fused_pass_plan) is checked by the launcher.  From n =
// 32768 to 131072 a row spans a thread-block cluster of 2, 4 or 8 blocks of
// 512 threads (polymul_pass_kernel<.., true>, pass_stages.cuh), in three
// passes or four.
//
// B4 (qt_polymul_fixed_fused) is B1's kernel with one operand
// (polymul_pass_kernel<..., 1>): x alone is loaded and carried through the
// forward's passes and exchanges, and where the forward ends, on the window
// [0, r), thread t holds positions t R + c, so its R values of the
// constant's spectrum (one n-value row every block shares) are neighbours,
// read in 16-byte loads and multiplied in by Barrett; then B1's inverse and
// store.  Its plan (ops/ntt_fused.py fixed_pass_plan) is B1's with half the
// shared memory a row, one operand's.
//
// B3 (qt_intt_fused, transform_pass_kernel<false, ...>) is B4's inverse
// half with no forward before it: a coalesced load on the window [tb, L),
// one exchange into [0, r), where B4's inverse starts, then its passes, one
// exchange each, the last on [tb, L) with the n^{-1} stage fused into the
// coalesced canonical store.
// Its plan (ops/ntt_fused.py intt_pass_plan) has no forward passes; three
// passes take a row of up to 1024 threads, so it runs every n from 2 to
// 32768 in a block, as its first design did, and from 65536 to 262144 a
// row spans a cluster of 2, 4 or 8 blocks of 1024 threads in four passes
// (transform_pass_kernel<.., true>).  That design (a block a row, min(n/2,
// 512) threads, __syncthreads() after each of the log2(n) stages, about 29
// SASS instructions a butterfly) took 0.3698 ms at qtesla-iii-speed, B =
// 32768, on an H100 80GB HBM3 at 700 W (PERF.md).
//
// B2 (qt_ntt_fused, transform_pass_kernel<true, ...>) is B4's forward half
// with no product and no inverse after it: the coalesced load on [tb, L),
// the CT stages from the widest down, one exchange a pass after the first,
// ending on [0, r); then one more exchange back to [tb, L) and the
// coalesced canonical store.  Its plan (ops/ntt_fused.py ntt_pass_plan) has
// no inverse passes, and it runs every n from 2 to 32768 in a block, as its
// first design did, and to 262144 in a cluster, as B3.  That design (a block a row, min(n/2, 512) threads, the row in
// shared memory, __syncthreads() after each of the log2(n) stages, about 29
// SASS instructions a butterfly) took 0.3591 ms at qtesla-iii-speed, B =
// 32768, on an H100 80GB HBM3 at 700 W (PERF.md).
//
// What bounds them on the H100.  At n = 1024 one polymul moves 12 KB of
// device memory.  The register butterfly is 7 instructions; the passes add
// one exchange each way and the twiddle loads.  B1 and B4 run near their
// issue bound; B2 and B3 do half of B4's butterflies and two exchanges, so
// their issue bound falls under their bytes bound: they are bound by device
// memory.
//
// Arithmetic.  q < 2^30, so 4q < 2^32 and Harvey's lazy ranges fit uint32:
// forward values stay in [0, 4q), inverse values in [0, 2q).  Shoup products
// use the native __umulhi; the pointwise product assembles the 64-bit
// product with __umulhi and a low multiply and folds it as
// hi * (2^32 mod q) + lo, exact for any uint32 operands (no 64-bit %).
//
// Each launcher is extern "C", takes raw pointers, the batch B, n, log2(n),
// the parameter set's constants, a pointer to its pass plan and a stream,
// launches without synchronising and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "pass_stages.cuh"

namespace {

using qt::csub;
using qt::Mod;
using qt::mulmod_barrett;
using qt::shoup_lazy;
using qt::ilog2;
using qt::PassKernels;
using qt::PassOrder;
using qt::PassPlan;
using qt::PlanArg;
using qt::two_pass_b;
using qt::two_pass_hi;
using qt::two_pass_lo;
using qt::window_base;

// ---------------------------------------------------------------------------
// B1 and B4: register passes.
// ---------------------------------------------------------------------------

// vec (1, 2 or 4, at most N) neighbouring twiddles and their Shoup
// companions, from entries aligned to vec, in one load each.
template <int N>
__device__ __forceinline__ void load_twiddles(uint32_t (&tw)[N],
                                              uint32_t (&tw_sh)[N],
                                              const uint32_t* w,
                                              const uint32_t* w_sh, int vec) {
    if (N >= 4 && vec == 4) {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(w));
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(w_sh));
        tw[0] = a.x, tw[1 % N] = a.y, tw[2 % N] = a.z, tw[3 % N] = a.w;
        tw_sh[0] = b.x, tw_sh[1 % N] = b.y, tw_sh[2 % N] = b.z,
        tw_sh[3 % N] = b.w;
    } else if (N >= 2 && vec == 2) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(w));
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(w_sh));
        tw[0] = a.x, tw[1 % N] = a.y;
        tw_sh[0] = b.x, tw_sh[1 % N] = b.y;
    } else {
        tw[0] = __ldg(w);
        tw_sh[0] = __ldg(w_sh);
    }
}

// The merged-psi stages on index bits k in [lo, hi), on the window [b, b + r)
// of virtual thread vt: the forward's CT butterflies from the widest stage
// down (FWD), or the inverse's GS butterflies from the narrowest up.  The
// stage on window bit t (k = b + t) pairs registers c and c + 2^t and reads
// the 2^(r-1-t) twiddles w[2^(L-1-k) + (j >> (k+1))], indexed by the index
// bits above the stage: (vt >> b) << (r-1-t) from the thread's, c >> (t+1)
// from the register's.
template <bool FWD, int R, int NOPS>
__device__ __forceinline__ void merged_stages(uint32_t (&v)[NOPS][R], int b,
                                              int vt, int lo, int hi,
                                              int logn,
                                              const uint32_t* __restrict__ w,
                                              const uint32_t* __restrict__ w_sh,
                                              uint32_t q, uint32_t q2) {
    constexpr int r = ilog2(R);
    const int vhi = vt >> b;
#pragma unroll
    for (int s = 0; s < r; ++s) {
        const int t = FWD ? r - 1 - s : s;
        const int k = b + t;
        if (k < lo || k >= hi) continue;
        const int m = 1 << t;
        const int base = (1 << (logn - 1 - k)) + (vhi << (r - 1 - t));
        // The 2^(r-1-t) twiddles of a thread are neighbours, from an entry
        // aligned to their count: read up to 4 at a time.  In the window [0,
        // r) each thread reads other entries than its neighbours (the
        // thread holds the index bits above every stage), so one word at a
        // time would make as many L1 requests as twiddles.  One loop over
        // the registers: nested loops (a twiddle's registers inside) left
        // both register arrays in local memory at R = 32.
        constexpr int kVec = R / 2 < 4 ? R / 2 : 4;
        const int vec = (R >> (t + 1)) < kVec ? (R >> (t + 1)) : kVec;
        uint32_t tw[kVec], tw_sh[kVec];
#pragma unroll
        for (int c = 0; c < R; ++c) {
            if (c & m) continue;
            const int h = c >> (t + 1);  // the twiddle's number
            if ((c & (m - 1)) == 0 && h % vec == 0)
                load_twiddles<kVec>(tw, tw_sh, w + base + h, w_sh + base + h,
                                    vec);
#pragma unroll
            for (int o = 0; o < NOPS; ++o) {
                if (FWD)
                    qt::ct_butterfly(v[o][c], v[o][c + m], tw[h % vec],
                                     tw_sh[h % vec], q, q2);
                else
                    qt::gs_butterfly(v[o][c], v[o][c + m], tw[h % vec],
                                     tw_sh[h % vec], q, q2);
            }
        }
    }
}

// LOGN > 0: built for n = 2^LOGN in two passes, gs_ct's schedule known at
// compile time, so every index offset of a thread is a constant.  NOPS 2:
// B1, x times y; NOPS 1: B4, x times the spectrum y (n values every row
// shares), one forward.  B4's kernel built for its length takes three
// blocks of 256 threads an SM (80 registers, 16 bytes of spill; 0.9635 of
// its time at two blocks, PERF.md); with run-time windows it would spill
// 60 bytes there, and keeps two.  kCluster: a row spans the blocks of a
// cluster (n >= 32768, pass_stages.cuh), 512 threads a block.
template <int R, int P, int LOGN, int NOPS, bool kCluster>
__global__ void __launch_bounds__(P >= 3 ? 512 : 256,
                                  P == 2 ? (NOPS == 1 && LOGN > 0 ? 3 : 2)
                                         : 1)
    polymul_pass_kernel(const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ y,
                        uint32_t* __restrict__ z,
                        const uint32_t* __restrict__ tw, long long batch,
                        int n_arg, int logn_arg, Mod m, uint32_t q2,
                        typename qt::PlanOf<kCluster>::type pl) {
    static_assert(LOGN == 0 || P == 2, "one length: two passes");
    static_assert(NOPS == 1 || NOPS == 2, "x and y, or x alone");
    static_assert(!kCluster || (LOGN == 0 && P >= 3), "a cluster: P >= 3");
    constexpr int r = ilog2(R);
    constexpr bool kConst = LOGN > 0;
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
    const uint32_t *fw = tw, *fw_sh = tw + n, *iw = tw + 2 * n,
                   *iw_sh = tw + 3 * n;
    const uint32_t q = m.q;

    // pass p's stages and window: the plan's, or gs_ct's two-pass schedule
    // for the length the kernel was built for (the forward from the widest
    // stage down, the inverse from the narrowest up)
    const auto lo = [](bool up, int planned, int p) {
        return kConst ? two_pass_lo(up, p, LOGN) : planned;
    };
    const auto hi = [](bool up, int planned, int p) {
        return kConst ? two_pass_hi(up, p, LOGN) : planned;
    };
    const auto win = [](bool up, int planned, int p) {
        return kConst ? two_pass_b(up, p, LOGN, r) : planned;
    };

    // the window [tb, L) reads neighbouring columns with neighbouring
    // threads; canonical input is below 4q
    uint32_t v[NOPS][R];
    int b = tb;
    {
        const int base = window_base(t, b, r);
#pragma unroll
        for (int c = 0; c < R; ++c) {
            const int i = base + (c << b);
            v[0][c] = x[off + i];
            if constexpr (NOPS == 2) v[1][c] = y[off + i];
        }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        if (p > 0) {
            const int b2 = win(false, pl.fwd_b[p], p);
            qt::row_exchange<kCluster, kConst, R, NOPS>(
                v, buf, stride, b, t, b2, t, warp_rows, pl, p - 1, at.lbits);
            b = b2;
        }
        merged_stages<true, R, NOPS>(v, b, t, lo(false, pl.fwd_lo[p], p),
                                     hi(false, pl.fwd_hi[p], p), logn, fw,
                                     fw_sh, q, q2);
    }

    // the inverse starts on the forward's last window
    uint32_t u[1][R];
    if constexpr (NOPS == 2) {
#pragma unroll
        for (int c = 0; c < R; ++c)
            u[0][c] = mulmod_barrett(v[0][c], v[1][c], m);
    } else {
        // that window is [0, r) (the launcher's checks): thread t holds
        // positions t R + c, R neighbouring values of the spectrum, read
        // 16 bytes at a time (8 at R = 2) from its 16-byte aligned row
        const uint32_t* s = y + (static_cast<size_t>(t) << r);
#pragma unroll
        for (int c = 0; c < R; c += R < 4 ? 2 : 4) {
            uint32_t w[4];
            if constexpr (R < 4) {
                const uint2 a = __ldg(reinterpret_cast<const uint2*>(s + c));
                w[0] = a.x, w[1] = a.y;
            } else {
                const uint4 a = __ldg(reinterpret_cast<const uint4*>(s + c));
                w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
            }
#pragma unroll
            for (int k = 0; k < (R < 4 ? 2 : 4); ++k)
                u[0][c + k] = mulmod_barrett(v[0][c + k], w[k], m);
        }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        if (p > 0) {
            const int b2 = win(true, pl.inv_b[p], p);
            qt::row_exchange<kCluster, kConst, R, 1>(u, buf, stride, b, t, b2,
                                                     t, warp_rows, pl,
                                                     P + p - 2, at.lbits);
            b = b2;
        }
        // the last stage, k = L - 1, goes with the store
        const int p_hi = hi(true, pl.inv_hi[p], p);
        merged_stages<false, R, 1>(u, b, t, lo(true, pl.inv_lo[p], p),
                                   p_hi < logn ? p_hi : logn - 1, logn, iw,
                                   iw_sh, q, q2);
    }

    // The last stage in the last window [tb, L), on register bit r - 1: the
    // sum by n^{-1}, the difference by psi^{-1}_rev[1] n^{-1}, canonical.
    if (live) {
        const uint32_t w0 = __ldg(iw), w0_sh = __ldg(iw_sh);
        const uint32_t w1 = __ldg(iw + 1), w1_sh = __ldg(iw_sh + 1);
        constexpr int h = R / 2;
#pragma unroll
        for (int c = 0; c < h; ++c) {
            const uint32_t a = u[0][c], d = u[0][c + h];
            z[off + t + (c << tb)] = csub(shoup_lazy(a + d, w0, w0_sh, q), q);
            z[off + t + ((c + h) << tb)] =
                csub(shoup_lazy(a + q2 - d, w1, w1_sh, q), q);
        }
    }
    qt::cluster_drain<kCluster>(pl, 2 * P - 3);
}

// R = n for n <= 32 (one pass a transform), R = 32 with two passes (n <=
// 1024) or three (n <= 16384, as the block's threads allow), and R = 32 in
// two passes built for n = 1024, whose one schedule the launcher's checks
// leave is the one two_pass_* restate; in a cluster R = 32 in three passes
// (n = 32768) or four (n = 65536, 131072).
template <int NOPS>
PassKernels polymul_pass_kernel_for(int radix, int passes, int logn,
                                    int cluster) {
    if (cluster > 1) {
        if (radix != 32) return {};
        if (passes == 3)
            return {nullptr, polymul_pass_kernel<32, 3, 0, NOPS, true>};
        if (passes == 4)
            return {nullptr, polymul_pass_kernel<32, 4, 0, NOPS, true>};
        return {};
    }
    if (radix == 32 && passes == 2 && logn == 10)
        return {polymul_pass_kernel<32, 2, 10, NOPS, false>};
    switch (radix * 4 + passes) {
        case 2 * 4 + 1: return {polymul_pass_kernel<2, 1, 0, NOPS, false>};
        case 4 * 4 + 1: return {polymul_pass_kernel<4, 1, 0, NOPS, false>};
        case 8 * 4 + 1: return {polymul_pass_kernel<8, 1, 0, NOPS, false>};
        case 16 * 4 + 1: return {polymul_pass_kernel<16, 1, 0, NOPS, false>};
        case 32 * 4 + 1: return {polymul_pass_kernel<32, 1, 0, NOPS, false>};
        case 32 * 4 + 2: return {polymul_pass_kernel<32, 2, 0, NOPS, false>};
        case 32 * 4 + 3: return {polymul_pass_kernel<32, 3, 0, NOPS, false>};
        default: return {};
    }
}

// B1 (NOPS 2) and B4 (NOPS 1): the forward from the widest stage down, the
// inverse from the narrowest up, no bit reversal between them
template <int NOPS>
int launch_polymul_passes(const void* a, const void* b, void* out,
                          const void* tw, long long batch, int n, int logn,
                          uint32_t q, uint32_t r32, uint32_t r32_sh,
                          uint32_t one_sh, const void* plan, void* stream) {
    if (!plan) return cudaErrorInvalidValue;
    const PlanArg pl = *static_cast<const PlanArg*>(plan);
    return qt::launch_pass_kernel(
        polymul_pass_kernel_for<NOPS>(pl.radix, pl.passes, logn, pl.cluster),
        pl,
        qt::PassOrder{false, true, false, false, NOPS}, a, b, out, tw, batch,
        n, logn, q, r32, r32_sh, one_sh, stream);
}

// ---------------------------------------------------------------------------
// B2 and B3: one transform in register passes.
// ---------------------------------------------------------------------------

// One merged-psi transform of each row in register passes, no product:
// B3's inverse (FWD false) is B4's inverse half with nothing before it, B2's
// forward (FWD true) B4's forward half with nothing after it.  The
// load is coalesced, register c of thread t holding position t + c 2^tb
// (the window [tb, L)); one exchange through padded shared memory takes the
// row to the window [0, r) the GS stages start on, from the narrowest up;
// one exchange a pass after the first (__syncwarp at n <= 1024); the last
// pass on [tb, L), its stage k = L - 1 fused into the coalesced canonical
// store, as B1's and B4's.  Reading each thread's R values in [0, r) as
// neighbours in 16-byte loads, with no first exchange, took 1.1593x the
// time on an H100 (each warp-wide load touches 32 lines of device memory;
// PERF.md).  B2's forward is the mirror: the coalesced load on [tb, L),
// the CT stages from the widest down to [0, r), one exchange a pass after
// the first, then one more back to [tb, L) and the coalesced store,
// canonical (csub twice: CT leaves values below 4q).  Storing each
// thread's R neighbours from [0, r) in 16-byte stores, with no last
// exchange, took 1.65x the time on an H100 (PERF.md).
// Input below 2q (inverse) or 4q
// (forward); one operand's registers leave room for 1024 threads a row in
// three passes (n = 32768).  In one or two passes three 256-thread blocks
// an SM (80 registers, no spill) ran 0.9769x the time of four (64) on an
// H100 (PERF.md).  The forward in two passes with run-time windows spilled
// 264 bytes at 80 registers and takes two (as B4's kernel with run-time
// windows does).  kCluster: a row spans the blocks of a cluster (n >=
// 65536, pass_stages.cuh), 1024 threads a block.
template <bool FWD, int R, int P, int LOGN, bool kCluster>
__global__ void __launch_bounds__(P >= 3 ? 1024 : 256,
                                  P >= 3 ? 1 : FWD && P == 2 && LOGN == 0 ? 2
                                                                          : 3)
    transform_pass_kernel(const uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ /*unused*/,
                          uint32_t* __restrict__ z,
                          const uint32_t* __restrict__ tw, long long batch,
                          int n_arg, int logn_arg, Mod m, uint32_t q2,
                          typename qt::PlanOf<kCluster>::type pl) {
    static_assert(LOGN == 0 || P == 2, "one length: two passes");
    static_assert(!kCluster || (LOGN == 0 && P >= 3), "a cluster: P >= 3");
    constexpr int r = ilog2(R);
    constexpr bool kConst = LOGN > 0;
    constexpr bool up = !FWD;
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
    const uint32_t* w = tw + (FWD ? 0 : 2 * n);
    const uint32_t* w_sh = tw + (FWD ? n : 3 * n);
    const uint32_t q = m.q;

    // the window [tb, L): neighbouring columns, neighbouring threads; the
    // inverse then goes to [0, r)
    uint32_t v[1][R];
    int b = tb;
#pragma unroll
    for (int c = 0; c < R; ++c) v[0][c] = x[off + t + (c << tb)];
    // exchange e: B3's first is 0, so its passes' are p; B2's are p - 1
    if (!FWD && tb > 0) {
        qt::row_exchange<kCluster, kConst, R, 1>(v, buf, stride, tb, t, 0, t,
                                                 warp_rows, pl, 0, at.lbits);
        b = 0;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        if (p > 0) {
            const int b2 = kConst ? two_pass_b(up, p, LOGN, r)
                                  : FWD ? pl.fwd_b[p] : pl.inv_b[p];
            qt::row_exchange<kCluster, kConst, R, 1>(
                v, buf, stride, b, t, b2, t, warp_rows, pl, FWD ? p - 1 : p,
                at.lbits);
            b = b2;
        }
        const int lo = kConst ? two_pass_lo(up, p, LOGN)
                              : FWD ? pl.fwd_lo[p] : pl.inv_lo[p];
        const int hi = kConst ? two_pass_hi(up, p, LOGN)
                              : FWD ? pl.fwd_hi[p] : pl.inv_hi[p];
        // the inverse's last stage, k = L - 1, goes with the store
        merged_stages<FWD, R, 1>(v, b, t, lo, FWD || hi < logn ? hi : logn - 1,
                                 logn, w, w_sh, q, q2);
    }
    // the forward ends on [0, r); one exchange takes it back to [tb, L)
    if (FWD && tb > 0)
        qt::row_exchange<kCluster, kConst, R, 1>(v, buf, stride, b, t, tb, t,
                                                 warp_rows, pl, P - 1,
                                                 at.lbits);
    qt::cluster_drain<kCluster>(pl, P - 1);
    if (!live) return;
    if constexpr (FWD) {
        // [tb, L): neighbouring columns, neighbouring threads; canonical
#pragma unroll
        for (int c = 0; c < R; ++c)
            z[off + t + (c << tb)] = csub(csub(v[0][c], q2), q);
    } else {
        // the last stage in the last window [tb, L), on register bit r - 1:
        // the sum by n^{-1}, the difference by psi^{-1}_rev[1] n^{-1}
        const uint32_t w0 = __ldg(w), w0_sh = __ldg(w_sh);
        const uint32_t w1 = __ldg(w + 1), w1_sh = __ldg(w_sh + 1);
        constexpr int h = R / 2;
#pragma unroll
        for (int c = 0; c < h; ++c) {
            const uint32_t a = v[0][c], d = v[0][c + h];
            z[off + t + (c << tb)] = csub(shoup_lazy(a + d, w0, w0_sh, q), q);
            z[off + t + ((c + h) << tb)] =
                csub(shoup_lazy(a + q2 - d, w1, w1_sh, q), q);
        }
    }
}

// B2's (FWD) and B3's instantiations: R = n for n <= 32, R = 32 in two
// passes (n <= 1024) or three (n <= 32768), and R = 32 in two passes built
// for n = 1024; in a cluster R = 32 in four passes (n = 65536 to 262144).
template <bool FWD>
PassKernels transform_pass_kernel_for(int radix, int passes, int logn,
                                      int cluster) {
    if (cluster > 1)
        return radix == 32 && passes == 4
                   ? PassKernels{nullptr,
                                 transform_pass_kernel<FWD, 32, 4, 0, true>}
                   : PassKernels{};
    if (radix == 32 && passes == 2 && logn == 10)
        return {transform_pass_kernel<FWD, 32, 2, 10, false>};
    switch (radix * 4 + passes) {
        case 2 * 4 + 1: return {transform_pass_kernel<FWD, 2, 1, 0, false>};
        case 4 * 4 + 1: return {transform_pass_kernel<FWD, 4, 1, 0, false>};
        case 8 * 4 + 1: return {transform_pass_kernel<FWD, 8, 1, 0, false>};
        case 16 * 4 + 1: return {transform_pass_kernel<FWD, 16, 1, 0, false>};
        case 32 * 4 + 1: return {transform_pass_kernel<FWD, 32, 1, 0, false>};
        case 32 * 4 + 2: return {transform_pass_kernel<FWD, 32, 2, 0, false>};
        case 32 * 4 + 3: return {transform_pass_kernel<FWD, 32, 3, 0, false>};
        default: return {};
    }
}

}  // namespace

// B1 and B4 take a pointer to their pass plan before the stream; B4's b is
// the constant's spectrum, n values, 16-byte aligned
extern "C" int qt_polymul_fused(const void* a, const void* b, void* out,
                                const void* tw, long long batch, int n,
                                int logn, uint32_t q, uint32_t r32,
                                uint32_t r32_sh, uint32_t one_sh,
                                const void* plan, void* stream) {
    return launch_polymul_passes<2>(a, b, out, tw, batch, n, logn, q, r32,
                                    r32_sh, one_sh, plan, stream);
}

extern "C" int qt_polymul_fixed_fused(const void* a, const void* b,
                                      void* out, const void* tw,
                                      long long batch, int n, int logn,
                                      uint32_t q, uint32_t r32,
                                      uint32_t r32_sh, uint32_t one_sh,
                                      const void* plan, void* stream) {
    return launch_polymul_passes<1>(a, b, out, tw, batch, n, logn, q, r32,
                                    r32_sh, one_sh, plan, stream);
}

// B3: the inverse alone in register passes, plan from
// ops/ntt_fused.py intt_pass_plan
extern "C" int qt_intt_fused(const void* a, const void* b, void* out,
                             const void* tw, long long batch, int n, int logn,
                             uint32_t q, uint32_t r32, uint32_t r32_sh,
                             uint32_t one_sh, const void* plan, void* stream) {
    if (!plan) return cudaErrorInvalidValue;
    const PlanArg pl = *static_cast<const PlanArg*>(plan);
    const PassOrder order{false, true, false, false, 1, false, true};
    return qt::launch_pass_kernel(
        transform_pass_kernel_for<false>(pl.radix, pl.passes, logn,
                                         pl.cluster),
        pl,
        order, a, b, out, tw, batch, n, logn, q, r32, r32_sh, one_sh, stream);
}

// B2: the forward alone in register passes, from the widest stage down,
// plan from ops/ntt_fused.py ntt_pass_plan
extern "C" int qt_ntt_fused(const void* a, const void* b, void* out,
                            const void* tw, long long batch, int n, int logn,
                            uint32_t q, uint32_t r32, uint32_t r32_sh,
                            uint32_t one_sh, const void* plan, void* stream) {
    if (!plan) return cudaErrorInvalidValue;
    const PlanArg pl = *static_cast<const PlanArg*>(plan);
    const PassOrder order{false, false, false, false, 1, true, false};
    return qt::launch_pass_kernel(
        transform_pass_kernel_for<true>(pl.radix, pl.passes, logn,
                                        pl.cluster),
        pl,
        order, a, b, out, tw, batch, n, logn, q, r32, r32_sh, one_sh, stream);
}

extern "C" const char* qt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
