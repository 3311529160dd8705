// Sweep forms of the pass kernels, for rows past a thread-block cluster's
// reach (sm_90a): B1, B4 and the five B10 pairings from n = 2^18, B2 and
// B3 from n = 2^19, up to n = 2^25, the largest ring the registry takes;
// B2 and B3 also over the index bits from `low` up, the wide stages of the
// MXU and SP split forms (ntt_mxu_split.cu, sp_column_split.cu).
//
// Replaces, at those lengths, the Pallas TPU kernels of
// qtesla_tpu/ops/ntt_pallas.py (_polymul_kernel l.100, _polymul_fixed_kernel
// l.112, _ntt_kernel l.123, _intt_kernel l.129) and
// qtesla_tpu/ops/ntt_pairings_pallas.py (_pairing_kernel l.160), whose block
// and cluster forms are ntt_fused.cu and ntt_pairings.cu; one launcher,
// qt_pass_sweep, runs one launch of a call of any of the nine.
//
// What they compute is what the pass kernels compute (see the notes at the
// top of ntt_fused.cu and ntt_pairings.cu): the same butterflies on the same
// twiddles, canonical out, bit for bit.  How: a row stays in device memory
// and a transform runs in sweeps, one launch each.  The plan (ops/passes.py
// sweep_plan) parts the L = log2(n) index bits into two or three windows.
// A launch on the window [lo, hi) of s bits gives each block a tile: the
// 2^s indices of a row that differ only in the window's bits, for 2^c
// neighbouring values of c column bits [cb, cb + c) (so that a warp's loads
// and stores run over 32 contiguous bytes), the other bits fixed by the
// block's number.  The block loads the tile into shared memory (value u =
// v | col << s at u + u/32 + col), runs the window's stages there in
// register passes of up to three (a thread loads a group of 8 values that
// differ in three window bits, runs those stages in registers and stores
// them back; a barrier a pass; as few passes as the window needs, of sizes
// as even as they go) and stores the tile back.
//
// Twiddles.  A stage on index bit k pairs indices j and j + 2^k of its
// transform, all inside the tile.  Its twiddle, an entry of the compact
// tables the pass kernels read ((4, n) merged-psi rows, B1-B4: w[2^(L-1-k)
// + (j >> (k+1))] = psi^brev(..); (8, n) pairing rows: w[2^k + (j mod
// 2^k)] = omega^(..)), is a power whose exponent is a sum of two disjoint
// bit fields of j: the tile's fixed bits and the window's own.  So it is
// the product of two table entries: a base, set by the tile's fixed bits
// and column (one pair a stage and column, read into shared memory once a
// tile), and an in-window power, set by the window's bits alone, from a
// small table (ops/ntt.py sweep_powers: the tables' first 2^14 entries, the
// merged inverse's entries 0 and 1 without n^{-1}) shared by every tile and
// row.  A butterfly multiplies by the two in turn (Shoup by each: below 2q,
// the lazy ranges of one Shoup product), so no table past L2 is read a
// butterfly and no twiddle index is bit-reversed there; a thread reads each
// power once for the butterflies of its group that share it.  Where a
// stage's twiddle depends on few window bits, those above the stage
// (merged and reflected stages, s - 1 - t <= kExactBits; not Stockham,
// whose columns may lie above the window), the block forms the tile's
// twiddles of those stages whole once a tile, with their Shoup companions
// (mul_pair), at most 511 pairs a transform in shared memory, and such a
// stage's butterflies take one Shoup product, the table's own value.  The
// merged
// inverse's stage k = L - 1 takes n^{-1} on the sum (entry 0) and entry 1
// on the difference, canonical, as the pass kernels' store does.
//
// Addresses.  The eight natural-order kinds (all but Stockham) keep a row
// in natural order between launches, so a tile is a strided box: the
// narrowest window is contiguous (plan vec 1: 16 bytes a thread, four
// neighbouring values), an upper window's v holds its 8 columns in 32
// bytes (vec 2: two 16-byte loads a thread); the tile's fixed bits are two
// runs of its number.  Stockham's intermediate rows lie at its autosort's
// positions (index j of the forward after stage st at ((j mod 2^(L-st)) <<
// st) | brev_st(j >> (L - st)), likewise the inverse's bit-reversed index;
// plan fields ld, st and their refl flags); its launches load and store a
// value at a time through that map (vec 0), as does any launch whose
// operands are not 16-byte aligned.
//
// Tiles: the narrowest window carries both operands (up to 2^14 values
// each); an upper window at most 2^14 values an operand (s <= 11 beside c =
// 3 columns), or 2^15 where that saves a window (sweep_plan), its forward
// both operands of B1 and the pairings where they fit 2^14 values in all,
// else each in a block of its own.  A tile of at most 2^14 values runs 512
// threads, so two blocks share an SM and one's loads run while the other's
// stages do; a larger one 1024.  Launches a call: the forward from its
// widest window down, the narrowest window once with the forward's stages,
// the pointwise product and the inverse's stages, then the inverse up: 3
// with two windows, 5 with three (Stockham from 2^24).  B2 and B3 one a
// window.  A launch reads what the one before wrote: the operands, then two
// scratch buffers of the operands' rows in turns, z last.
//
// Where each index lies between launches.  The DIT forwards (ct_ct, ct_gs)
// and the DIF and Stockham inverses (gs_gs, ct_gs, stockham) run on the
// bit-reversed index of the position they touch, as the pass kernels'
// renamings do: their stage on index bit k lies on position bit L - 1 - k,
// and a forward's stages run from position bit L - 1 down, an inverse's
// from bit 0 up, in all nine.
//
// Arithmetic is the pass kernels': q < 2^30; GS butterflies keep [0, 2q),
// CT ones take and give values below 4q, and what a launch stores for the
// next stays there, below 2^32; B2's last launch stores canonical values
// (what the split kernels take), B3 takes values below 2q.  Offsets into a
// batch are 64-bit.
//
// What bounds it on an H100 (80GB HBM3, 700 W; utils/sweep_timing.py,
// utils/ab_timing.py --sweeps): each launch reads and writes every value
// once, the sweep floor (9n words a row for B1 and the pairings with two
// windows, against 3n for one pass: 0.36 ms at 128 MiB an operand, 1.44 at
// 2^25), yet the launches move 330-1130 GB/s: the butterflies' integer
// instructions hold them (the Shoup products, the lazy reductions, slot
// and power indices), the middle window's most at 2^25 (one block an SM).
// B1 takes 1.46 ms at 2^20 and 6.25 at 2^25, 0.53-0.65 of the kernel this
// design replaced; the pairings 0.33-0.65 of theirs.  PERF.md (sections 5
// and 6) has each kind's time beside its one-pass bound and sweep floor.
//
// The launcher is extern "C": (x, y, z, scratch a, scratch b, twiddles, the
// in-window powers, batch B, n, log2(n), the set's constants, &plan, the
// launch's number, a stream); y is B4's spectrum (n values), unused by B2
// and B3.  It checks the whole plan against the one it restates (plan_ok)
// and refuses any other, launches without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "pass_stages.cuh"

namespace {

using qt::csub;
using qt::lower;
using qt::Mod;
using qt::mulmod_barrett;
using qt::shoup_lazy;

constexpr int kMaxWindows = 3;
constexpr int kMaxSweeps = 2 * kMaxWindows - 1;
constexpr int kMaxLogn = 25;
// values a tile holds, all its operands (128 KiB); an upper window's tile
// of at most 2^kUpperBits values runs two blocks an SM; column bits
constexpr int kTileBits = 15;
constexpr int kUpperBits = 14;
constexpr int kCols = 3;
constexpr int kMaxThreads = 1024;
constexpr int kHalfThreads = 512;
// window bits a pass runs in registers, between two barriers
constexpr int kPassBits = 3;
// a thread's scalar loads in flight at once (vec 0); its 16-byte ones
constexpr int kBatch = 8;
constexpr int kVecBatch = 2;
// entries a row of the in-window powers
constexpr int kPowBits = 14;
// a stage whose twiddle depends on at most kExactBits window bits above it
// (merged, reflected) reads it whole from a table of the tile's own; the
// table's pairs a transform
constexpr int kExactBits = 8;
constexpr int kExactWords = (2 << kExactBits) - 1;

// the order of ops/passes.py SWEEP_KINDS
enum Kind { kB1, kB4, kB2, kB3, kGsCt, kCtCt, kGsGs, kCtGs, kStk, kKinds };
enum Scheme { kNone, kMerged, kDif, kDit, kStock };

__host__ __device__ constexpr int fwd_scheme(int kind) {
    return kind == kB3                    ? kNone
           : kind <= kB2                  ? kMerged
           : kind == kGsCt || kind == kGsGs ? kDif
           : kind == kStk                 ? kStock
                                          : kDit;
}

__host__ __device__ constexpr int inv_scheme(int kind) {
    return kind == kB2                    ? kNone
           : kind <= kB3                  ? kMerged
           : kind == kGsCt || kind == kCtCt ? kDit
           : kind == kStk                 ? kStock
                                          : kDif;
}

__host__ __device__ constexpr int operands(int kind) {
    return kind == kB4 || kind == kB2 || kind == kB3 ? 1 : 2;
}

// a transform that runs on the bit-reversed index: a DIT forward, a DIF or
// Stockham inverse
__host__ __device__ constexpr bool reflected(int scheme, bool fwd) {
    return fwd ? scheme == kDit : scheme == kDif || scheme == kStock;
}

// Mirrors ops/passes.py SweepPlan.
struct SweepPlan {
    int kind, logn, sweeps, windows;
    int win_lo[kMaxWindows], win_hi[kMaxWindows];
    int lo[kMaxSweeps], hi[kMaxSweeps], fwd[kMaxSweeps], inv[kMaxSweeps];
    int cb[kMaxSweeps], cols[kMaxSweeps], ops[kMaxSweeps], split[kMaxSweeps];
    int ld[kMaxSweeps], ld_refl[kMaxSweeps], st[kMaxSweeps],
        st_refl[kMaxSweeps];
    int tiles[kMaxSweeps], threads[kMaxSweeps], smem[kMaxSweeps],
        vec[kMaxSweeps];
};

// One launch's fields.
struct Sweep {
    int lo, hi, fwd, inv, cb, cols, ops, split, ld, ld_refl, st, st_refl,
        tiles, vec, first, last;
};

// the bit of an address index bit i lands on (address below)
__host__ __device__ inline int address_bit(int i, int L, int st, int refl) {
    const int j = refl ? L - 1 - i : i;
    return j < L - st ? j + st : L - 1 - j;
}

__device__ __forceinline__ unsigned brev_bits(unsigned v, int bits) {
    return bits == 0 ? 0u : __brev(v) >> (32 - bits);
}

// The address of index m of a row: the Stockham position of stage st of j
// = m (or j = brev_L(m) with refl), ((j mod 2^(L-st)) << st) |
// brev_st(j >> (L - st)); m itself at (0, 0) and (L, 1).
__device__ __forceinline__ unsigned address(unsigned m, int L, int st,
                                            int refl) {
    const unsigned j = refl ? brev_bits(m, L) : m;
    const int low = L - st;
    return ((j & ((1u << low) - 1)) << st) | brev_bits(j >> low, st);
}

// value u = v | col << s of a tile in shared memory
__device__ __forceinline__ int tile_slot(int u, int s) {
    return u + (u >> 5) + (u >> s);
}

// The table entry of the base of the stage on window bit km - lo (index
// bit km of the position) for the position jf, the tile's fixed bits and
// column with the window's bits 0: merged psi^brev(2^(L-1-k) | jf >>
// (k+1)); cyclic omega at 2^k + (j mod 2^k), j = jf or, reflected, brev(jf)
// and k = L - 1 - km.
template <int SCHEME, bool FWD>
__device__ __forceinline__ unsigned base_index(unsigned jf, int km, int L) {
    if (SCHEME == kMerged) return (1u << (L - 1 - km)) + (jf >> (km + 1));
    if (reflected(SCHEME, FWD)) {
        const int k = L - 1 - km;
        return (1u << k) + (brev_bits(jf, L) & ((1u << k) - 1));
    }
    return (1u << km) + (jf & ((1u << km) - 1));
}

// The in-window power's entry for window value v at window bit t of s:
// merged psi^brev(v >> (t+1)) at v >> (t+1); cyclic the stage's own table
// on the window, 2^t + (v mod 2^t), or reflected 2^(s-1-t) + brev(v >>
// (t+1)).
template <int SCHEME, bool FWD>
__device__ __forceinline__ int pow_index(int v, int t, int s) {
    if (SCHEME == kMerged) return v >> (t + 1);
    if (reflected(SCHEME, FWD)) {
        const int mp = s - 1 - t;
        return (1 << mp) + static_cast<int>(brev_bits(v >> (t + 1), mp));
    }
    return (1 << t) + (v & ((1 << t) - 1));
}

// x times the in-window power (p) and the base (b): Shoup by each, below
// 2q for any uint32 x
__device__ __forceinline__ uint32_t mul_factored(uint32_t x, uint32_t p,
                                                 uint32_t p_sh, uint32_t b,
                                                 uint32_t b_sh, uint32_t q) {
    return shoup_lazy(shoup_lazy(x, p, p_sh, q), b, b_sh, q);
}

// One stage's tables as a pass reads them: the bases of the tile in shared
// memory (2^c a window bit), the in-window powers, the table's rows (the
// merged inverse's entries 0 and 1), the tile's whole twiddles of the
// stages near the window's top (null where the kind takes none).
struct StageTables {
    const uint32_t* bw;
    const uint32_t* bw_sh;
    const uint32_t* pw;
    const uint32_t* pw_sh;
    const uint32_t* w;
    const uint32_t* w_sh;
    const uint32_t* ew;
    const uint32_t* ew_sh;
};

// w = p b mod q, canonical, and its Shoup companion floor(w 2^32 / q), from
// the Shoup pairs of p and b: w 2^32 / q = b p_sh + b r / q - k 2^32 with r =
// p 2^32 - p_sh q below q, so the companion is b p_sh + floor(b r / q) mod
// 2^32, the floor a Shoup estimate and one correction.
__device__ __forceinline__ void mul_pair(uint32_t p, uint32_t p_sh,
                                         uint32_t b, uint32_t b_sh,
                                         uint32_t q, uint32_t& w,
                                         uint32_t& w_sh) {
    w = csub(shoup_lazy(p, b, b_sh, q), q);
    const uint32_t r = 0u - p_sh * q;
    uint32_t t = __umulhi(r, b_sh);
    if (b * r - t * q >= q) ++t;
    w_sh = b * p_sh + t;
}

// Window bits [t0, t0 + RB) of the tile in registers: each thread takes
// groups of 2^RB values that differ in those bits (the group's number
// spread over the window's other bits and the columns), loads them from
// shared memory, runs the RB stages there (a forward from the widest, an
// inverse from the narrowest) and stores them back.  The stage on window
// bit t is bit k = lo + t of its transform's index (L - 1 - k where it runs
// reflected); CT for a DIT transform and the merged forward, GS for the
// others; OPS operands share each twiddle.  A stage's in-window powers
// differ only in the group's bits above the stage (merged, reflected) or
// below it (cyclic), so each is read once for the butterflies that share
// it.  LINEAR where t0 >= 5: value r of a group lies r (2^t0 + 2^(t0-5))
// words past value 0.
template <int SCHEME, bool FWD, int RB, int OPS, bool LINEAR>
__device__ __forceinline__ void tile_pass(uint32_t* tile, int stride, int t0,
                                          int s, int c, int lo, int L,
                                          const StageTables& tb_,
                                          uint32_t q, uint32_t q2) {
    constexpr int R = 1 << RB;
    constexpr bool kCt = SCHEME == kDit || (SCHEME == kMerged && FWD);
    constexpr bool kHigh = SCHEME == kMerged || reflected(SCHEME, FWD);
    const int above = s - t0 - RB;  // window bits above the pass
    const int groups = 1 << (s + c - RB);
    const int step = LINEAR ? (1 << t0) + (1 << (t0 - 5)) : 0;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
        const int hi_bits = g >> t0;
        const int vbase = (g & ((1 << t0) - 1)) |
                          ((hi_bits & ((1 << above) - 1)) << (t0 + RB));
        const int col = hi_bits >> above;
        const int ubase = vbase | (col << s);
        const int p0 = tile_slot(ubase, s);
        uint32_t v[OPS][R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int p = LINEAR ? p0 + r * step
                                 : tile_slot(ubase | (r << t0), s);
#pragma unroll
            for (int o = 0; o < OPS; ++o) v[o][r] = tile[o * stride + p];
        }
#pragma unroll
        for (int st = 0; st < RB; ++st) {
            const int tb = FWD ? RB - 1 - st : st;
            const int m = 1 << tb;
            const int t = t0 + tb;
            if (SCHEME == kMerged && !FWD && lo + t == L - 1) {
                const uint32_t w0 = __ldg(tb_.w), w0_sh = __ldg(tb_.w_sh);
                const uint32_t w1 = __ldg(tb_.w + 1),
                               w1_sh = __ldg(tb_.w_sh + 1);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (r & m) continue;
                    const uint32_t a = v[0][r], d = v[0][r + m];
                    v[0][r] = csub(shoup_lazy(a + d, w0, w0_sh, q), q);
                    v[0][r + m] = csub(shoup_lazy(a + q2 - d, w1, w1_sh, q),
                                       q);
                }
                continue;
            }
            if (kHigh && tb_.ew && s - 1 - t <= kExactBits) {
                // whole twiddles: entry 2^(s-1-t) - 1 + (v >> (t+1))
                const int base = (1 << (s - 1 - t)) - 1 + (vbase >> (t + 1));
                const int nd = R >> (tb + 1);
                uint32_t ev[R / 2], ev_sh[R / 2];
#pragma unroll
                for (int d = 0; d < R / 2; ++d) {
                    if (d >= nd) continue;
                    ev[d] = tb_.ew[base + d];
                    ev_sh[d] = tb_.ew_sh[base + d];
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (r & m) continue;
                    const int d = r >> (tb + 1);
#pragma unroll
                    for (int o = 0; o < OPS; ++o) {
                        uint32_t& x = v[o][r];
                        uint32_t& y = v[o][r + m];
                        if (kCt) {
                            const uint32_t u = lower(x, q2);
                            const uint32_t h =
                                shoup_lazy(y, ev[d], ev_sh[d], q);
                            x = u + h;
                            y = u + q2 - h;
                        } else {
                            const uint32_t u = x, dd = y;
                            x = lower(u + dd, q2);
                            y = shoup_lazy(u + q2 - dd, ev[d], ev_sh[d], q);
                        }
                    }
                }
                continue;
            }
            const uint32_t b = tb_.bw[(t << c) | col];
            const uint32_t b_sh = tb_.bw_sh[(t << c) | col];
            // the stage's distinct powers: class d of butterfly r
            const int nd = kHigh ? R >> (tb + 1) : m;
            uint32_t pv[R / 2], pv_sh[R / 2];
#pragma unroll
            for (int d = 0; d < R / 2; ++d) {
                if (d >= nd) continue;
                const int rd = kHigh ? d << (tb + 1) : d;
                const int pi =
                    pow_index<SCHEME, FWD>(vbase | (rd << t0), t, s);
                pv[d] = __ldg(tb_.pw + pi);
                pv_sh[d] = __ldg(tb_.pw_sh + pi);
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (r & m) continue;
                const int d = kHigh ? r >> (tb + 1) : r & (m - 1);
#pragma unroll
                for (int o = 0; o < OPS; ++o) {
                    uint32_t& x = v[o][r];
                    uint32_t& y = v[o][r + m];
                    if (kCt) {
                        const uint32_t u = lower(x, q2);
                        const uint32_t h =
                            mul_factored(y, pv[d], pv_sh[d], b, b_sh, q);
                        x = u + h;
                        y = u + q2 - h;
                    } else {
                        const uint32_t u = x, dd = y;
                        x = lower(u + dd, q2);
                        y = mul_factored(u + q2 - dd, pv[d], pv_sh[d], b,
                                         b_sh, q);
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int p = LINEAR ? p0 + r * step
                                 : tile_slot(ubase | (r << t0), s);
#pragma unroll
            for (int o = 0; o < OPS; ++o) tile[o * stride + p] = v[o][r];
        }
    }
}

template <int SCHEME, bool FWD, int RB, int OPS>
__device__ __forceinline__ void tile_pass_at(uint32_t* tile, int stride,
                                             int t0, int s, int c, int lo,
                                             int L, const StageTables& tb,
                                             uint32_t q, uint32_t q2) {
    if (t0 >= 5)
        tile_pass<SCHEME, FWD, RB, OPS, true>(tile, stride, t0, s, c, lo, L,
                                              tb, q, q2);
    else
        tile_pass<SCHEME, FWD, RB, OPS, false>(tile, stride, t0, s, c, lo, L,
                                               tb, q, q2);
}

// The stages on window bits [t0, t0 + rb), rb in 1..kPassBits, in one pass.
template <int SCHEME, bool FWD, int OPS>
__device__ __forceinline__ void tile_passes(uint32_t* tile, int stride,
                                            int t0, int rb, int s, int c,
                                            int lo, int L,
                                            const StageTables& tb,
                                            uint32_t q, uint32_t q2) {
    if (rb == 3)
        tile_pass_at<SCHEME, FWD, 3, OPS>(tile, stride, t0, s, c, lo, L, tb,
                                          q, q2);
    else if (rb == 2)
        tile_pass_at<SCHEME, FWD, 2, OPS>(tile, stride, t0, s, c, lo, L, tb,
                                          q, q2);
    else
        tile_pass_at<SCHEME, FWD, 1, OPS>(tile, stride, t0, s, c, lo, L, tb,
                                          q, q2);
}

// The tile's bases of one transform: entry (t << c) | col the table pair of
// window bit t and column col.
template <int SCHEME, bool FWD>
__device__ __forceinline__ void tile_bases(uint32_t* bw, uint32_t* bw_sh,
                                           const uint32_t* __restrict__ w,
                                           const uint32_t* __restrict__ w_sh,
                                           unsigned rest, const Sweep& sw,
                                           int L) {
    const int c = sw.cols, nb = (sw.hi - sw.lo) << c;
    for (int e = threadIdx.x; e < nb; e += blockDim.x) {
        const unsigned jf =
            rest | (static_cast<unsigned>(e & ((1 << c) - 1)) << sw.cb);
        const unsigned idx =
            base_index<SCHEME, FWD>(jf, sw.lo + (e >> c), L);
        bw[e] = __ldg(w + idx);
        bw_sh[e] = __ldg(w_sh + idx);
    }
}

// The tile's whole twiddles of one transform's stages on window bits t
// with s - 1 - t <= kExactBits (merged, reflected; the base of column 0):
// entry 2^(s-1-t) - 1 + x for the window bits above t, x = v >> (t+1).
template <int SCHEME, bool FWD>
__device__ __forceinline__ void tile_exact(uint32_t* ew, uint32_t* ew_sh,
                                           const uint32_t* bw,
                                           const uint32_t* bw_sh,
                                           const uint32_t* __restrict__ pw,
                                           const uint32_t* __restrict__ pw_sh,
                                           int s, int c, uint32_t q) {
    const int top = s - 1 < kExactBits ? s - 1 : kExactBits;
    const int count = (2 << top) - 1;
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
        const int a = 31 - __clz(e + 1);  // s - 1 - t
        const int t = s - 1 - a;
        const int x = e + 1 - (1 << a);
        const int pi = pow_index<SCHEME, FWD>(x << (t + 1), t, s);
        mul_pair(__ldg(pw + pi), __ldg(pw_sh + pi), bw[t << c],
                 bw_sh[t << c], q, ew[e], ew_sh[e]);
    }
}

__device__ __forceinline__ uint32_t lane(const uint4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One launch of a call of kind KIND (sweep sw): block (row, group, tile)
// loads operand group + o (o < sw.ops) of its tile from src (operand 1 at
// src1), runs the window's forward stages from the widest, the product,
// the inverse's stages from the narrowest, and stores to dst.  The psi
// weighting goes with a pairing's first load, the phi^{-1} n^{-1}
// weighting with its last store, B2's canonical csubs with its last store.
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
    sweep_kernel(const uint32_t* __restrict__ src0,
                 const uint32_t* __restrict__ src1, long long src_row,
                 uint32_t* __restrict__ dst0, uint32_t* __restrict__ dst1,
                 long long dst_row, const uint32_t* __restrict__ spec,
                 const uint32_t* __restrict__ tw,
                 const uint32_t* __restrict__ pw, int logn, Mod m,
                 uint32_t q2, Sweep sw) {
    constexpr int F = fwd_scheme(KIND), I = inv_scheme(KIND);
    constexpr int FS = F == kStock ? kDif : F, IS = I == kStock ? kDif : I;
    constexpr bool kPairing = KIND >= kGsCt;
    extern __shared__ uint32_t tile[];
    const int L = logn;
    const size_t n = size_t{1} << L;
    const int s = sw.hi - sw.lo, c = sw.cols, S = s + c;
    const int nv = 1 << S;
    const int stride = nv + (nv >> 5) + (1 << c);
    const int smask = (1 << s) - 1, cmask = (1 << c) - 1;
    const uint32_t q = m.q;
    // the block's row, operand group and tile
    const long long bid = blockIdx.x;
    const unsigned tile_no = static_cast<unsigned>(bid % sw.tiles);
    const long long rg = bid / sw.tiles;
    const int group = static_cast<int>(rg % sw.split);
    const long long row = rg / sw.split;
    // the tile number's bits on the bits outside the window and columns:
    // two runs, [c, lo) and [hi, L), where the columns are bits [0, c)
    unsigned rest = 0;
    if (sw.vec) {
        const int gap = sw.lo - c;
        rest = ((tile_no & ((1u << gap) - 1)) << c) |
               ((tile_no >> gap) << sw.hi);
    } else {
        for (int b = 0, k = 0; b < L; ++b) {
            if ((b >= sw.lo && b < sw.hi) || (b >= sw.cb && b < sw.cb + c))
                continue;
            rest |= ((tile_no >> k) & 1u) << b;
            ++k;
        }
    }
    const long long src_base = row * src_row, dst_base = row * dst_row;
    const uint32_t* in0 = group ? src1 : src0;
    uint32_t* out0 = group ? dst1 : dst0;
    // the tile's bases, after the operands: forward, then inverse
    const int nb = s << c;
    uint32_t* bases = tile + sw.ops * stride;
    uint32_t* exact = bases + 4 * nb;
    // the kinds whose high stages take whole twiddles: all but Stockham
    // (its columns lie above the window)
    constexpr bool kExact = KIND != kStk;
    const int pwl = L < kPowBits ? 1 << L : 1 << kPowBits;
    if constexpr (F != kNone) {
        if (sw.fwd)
            tile_bases<FS, true>(bases, bases + nb, tw, tw + n, rest, sw, L);
    }
    if constexpr (I != kNone) {
        if (sw.inv)
            tile_bases<IS, false>(bases + 2 * nb, bases + 3 * nb, tw + 2 * n,
                                  tw + 3 * n, rest, sw, L);
    }

    // the load: vec 1 four neighbouring window values a thread, vec 2 a
    // window value's 2^c columns, vec 0 a value at a time through the
    // address map, window or columns fastest, whichever holds the
    // address's lowest bit
    if (sw.vec == 1) {
        const int quads = nv >> 2;
        for (int e0 = threadIdx.x; e0 < quads; e0 += kVecBatch * blockDim.x) {
            uint4 val[2][kVecBatch];
#pragma unroll
            for (int b = 0; b < kVecBatch; ++b) {
                const int e = e0 + b * blockDim.x;
                if (e >= quads) continue;
                const long long a = rest + 4 * e;
#pragma unroll
                for (int o = 0; o < 2; ++o)
                    if (o < sw.ops)
                        val[o][b] = __ldg(reinterpret_cast<const uint4*>(
                            (o ? src1 : in0) + src_base + a));
            }
#pragma unroll
            for (int b = 0; b < kVecBatch; ++b) {
                const int e = e0 + b * blockDim.x;
                if (e >= quads) continue;
                uint4 wp, wp_sh;
                if (kPairing && sw.first) {
                    wp = __ldg(reinterpret_cast<const uint4*>(
                        tw + 4 * n + rest + 4 * e));
                    wp_sh = __ldg(reinterpret_cast<const uint4*>(
                        tw + 5 * n + rest + 4 * e));
                }
#pragma unroll
                for (int o = 0; o < 2; ++o) {
                    if (o >= sw.ops) continue;
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        uint32_t x = lane(val[o][b], i);
                        if (kPairing && sw.first)
                            x = shoup_lazy(x, lane(wp, i), lane(wp_sh, i), q);
                        tile[o * stride + tile_slot(4 * e + i, s)] = x;
                    }
                }
            }
        }
    } else if (sw.vec == 2) {
        const int nw = 1 << s;
        for (int o = 0; o < sw.ops; ++o)
        for (int v0 = threadIdx.x; v0 < nw; v0 += kVecBatch * blockDim.x) {
            uint4 val[kVecBatch][2];
#pragma unroll
            for (int b = 0; b < kVecBatch; ++b) {
                const int v = v0 + b * blockDim.x;
                if (v >= nw) continue;
                const uint4* ptr = reinterpret_cast<const uint4*>(
                    (o ? src1 : in0) + src_base + rest +
                    (static_cast<long long>(v) << sw.lo));
                val[b][0] = __ldg(ptr);
                val[b][1] = __ldg(ptr + 1);
            }
#pragma unroll
            for (int b = 0; b < kVecBatch; ++b) {
                const int v = v0 + b * blockDim.x;
                if (v >= nw) continue;
                const long long mi =
                    rest + (static_cast<long long>(v) << sw.lo);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    uint4 wp, wp_sh;
                    if (kPairing && sw.first) {
                        wp = __ldg(reinterpret_cast<const uint4*>(
                                       tw + 4 * n + mi) + h);
                        wp_sh = __ldg(reinterpret_cast<const uint4*>(
                                          tw + 5 * n + mi) + h);
                    }
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        uint32_t x = lane(val[b][h], i);
                        if (kPairing && sw.first)
                            x = shoup_lazy(x, lane(wp, i), lane(wp_sh, i), q);
                        tile[o * stride + tile_slot(v | ((4 * h + i) << s),
                                                    s)] = x;
                    }
                }
            }
        }
    } else {
        const bool wfast = address_bit(sw.lo, L, sw.ld, sw.ld_refl) == 0 ||
                           address_bit(sw.hi - 1, L, sw.ld, sw.ld_refl) == 0;
        for (int e0 = threadIdx.x; e0 < nv; e0 += kBatch * blockDim.x) {
            uint32_t val[2][kBatch];
            unsigned mi[kBatch];
            int p[kBatch];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
                const int e = e0 + b * blockDim.x;
                if (e >= nv) continue;
                const int v = wfast ? e & smask : e >> c;
                const int col = wfast ? e >> s : e & cmask;
                mi[b] = rest | (static_cast<unsigned>(v) << sw.lo) |
                        (static_cast<unsigned>(col) << sw.cb);
                const long long a = address(mi[b], L, sw.ld, sw.ld_refl);
                p[b] = tile_slot(v | (col << s), s);
#pragma unroll
                for (int o = 0; o < 2; ++o)
                    if (o < sw.ops)
                        val[o][b] = __ldg((o ? src1 : in0) + src_base + a);
            }
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
                if (e0 + b * blockDim.x >= nv) continue;
#pragma unroll
                for (int o = 0; o < 2; ++o) {
                    if (o >= sw.ops) continue;
                    uint32_t x = val[o][b];
                    if (kPairing && sw.first)
                        x = shoup_lazy(x, __ldg(tw + 4 * n + mi[b]),
                                       __ldg(tw + 5 * n + mi[b]), q);
                    tile[o * stride + p[b]] = x;
                }
            }
        }
    }
    __syncthreads();
    if constexpr (kExact && F != kNone && (FS == kMerged || reflected(FS, true))) {
        if (sw.fwd)
            tile_exact<FS, true>(exact, exact + kExactWords, bases, bases + nb,
                                 pw, pw + pwl, s, c, q);
    }
    if constexpr (kExact && I != kNone &&
                  (IS == kMerged || reflected(IS, false))) {
        if (sw.inv)
            tile_exact<IS, false>(exact + 2 * kExactWords,
                                  exact + 3 * kExactWords, bases + 2 * nb,
                                  bases + 3 * nb, pw + 2 * pwl, pw + 3 * pwl,
                                  s, c, q);
    }
    __syncthreads();
    // the forward's passes from the window's widest bits down, the
    // inverse's from its narrowest up, as few as the pass bits allow, of
    // sizes as even as they go
    if constexpr (F != kNone) {
        if (sw.fwd) {
            constexpr bool kFe =
                kExact && (FS == kMerged || reflected(FS, true));
            const StageTables tb{bases,  bases + nb, pw,
                                 pw + pwl, tw,        tw + n,
                                 kFe ? exact : nullptr,
                                 kFe ? exact + kExactWords : nullptr};
            for (int top = s, left = (s + kPassBits - 1) / kPassBits;
                 top > 0; --left) {
                const int rb = (top + left - 1) / left;
                top -= rb;
                if (operands(KIND) == 2 && sw.ops == 2)
                    tile_passes<FS, true, 2>(tile, stride, top, rb, s, c,
                                             sw.lo, L, tb, q, q2);
                else
                    tile_passes<FS, true, 1>(tile, stride, top, rb, s, c,
                                             sw.lo, L, tb, q, q2);
                __syncthreads();
            }
        }
    }
    if constexpr (F != kNone && I != kNone) {
        if (sw.fwd && sw.inv) {
            for (int u = threadIdx.x; u < nv; u += blockDim.x) {
                const int p = tile_slot(u, s);
                uint32_t other;
                if constexpr (KIND == kB4) {
                    const unsigned mi =
                        rest | (static_cast<unsigned>(u & smask) << sw.lo) |
                        (static_cast<unsigned>(u >> s) << sw.cb);
                    other = __ldg(spec + mi);
                } else {
                    other = tile[stride + p];
                }
                tile[p] = mulmod_barrett(tile[p], other, m);
            }
            __syncthreads();
        }
    }
    if constexpr (I != kNone) {
        if (sw.inv) {
            constexpr bool kIe =
                kExact && (IS == kMerged || reflected(IS, false));
            const StageTables tb{bases + 2 * nb, bases + 3 * nb,
                                 pw + 2 * pwl,   pw + 3 * pwl,
                                 tw + 2 * n,     tw + 3 * n,
                                 kIe ? exact + 2 * kExactWords : nullptr,
                                 kIe ? exact + 3 * kExactWords : nullptr};
            for (int t0 = 0, left = (s + kPassBits - 1) / kPassBits; t0 < s;
                 --left) {
                const int rb = (s - t0 + left - 1) / left;
                tile_passes<IS, false, 1>(tile, stride, t0, rb, s, c,
                                          sw.lo, L, tb, q, q2);
                t0 += rb;
                __syncthreads();
            }
        }
    }
    // the store: a forward alone carries its operands on, else one; the
    // last launch's weighting (a pairing) or canonical csubs (B2)
    const int out_ops = sw.fwd && !sw.inv ? sw.ops : 1;
    auto finish = [&](uint32_t val, uint32_t wv, uint32_t wv_sh) {
        if (sw.last) {
            if constexpr (kPairing)
                val = csub(shoup_lazy(val, wv, wv_sh, q), q);
            else if constexpr (I == kNone)
                val = csub(csub(val, q2), q);
        }
        return val;
    };
    if (sw.vec == 1) {
        const int quads = nv >> 2;
        for (int e = threadIdx.x; e < quads; e += blockDim.x) {
            const long long a = rest + 4 * e;
            uint4 wv{}, wv_sh{};
            if (kPairing && sw.last) {
                wv = __ldg(reinterpret_cast<const uint4*>(tw + 6 * n + a));
                wv_sh = __ldg(reinterpret_cast<const uint4*>(tw + 7 * n + a));
            }
            for (int o = 0; o < out_ops; ++o) {
                uint32_t r[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    r[i] = finish(tile[o * stride + tile_slot(4 * e + i, s)],
                                  lane(wv, i), lane(wv_sh, i));
                *reinterpret_cast<uint4*>((o ? dst1 : out0) + dst_base + a) =
                    make_uint4(r[0], r[1], r[2], r[3]);
            }
        }
    } else if (sw.vec == 2) {
        const int nw = 1 << s;
        for (int o = 0; o < out_ops; ++o)
        for (int v = threadIdx.x; v < nw; v += blockDim.x) {
            const long long a = rest + (static_cast<long long>(v) << sw.lo);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                uint4 wv{}, wv_sh{};
                if (kPairing && sw.last) {
                    wv = __ldg(reinterpret_cast<const uint4*>(tw + 6 * n + a) +
                               h);
                    wv_sh = __ldg(
                        reinterpret_cast<const uint4*>(tw + 7 * n + a) + h);
                }
                uint32_t r[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    r[i] = finish(tile[o * stride +
                                       tile_slot(v | ((4 * h + i) << s), s)],
                                  lane(wv, i), lane(wv_sh, i));
                reinterpret_cast<uint4*>((o ? dst1 : out0) + dst_base + a)[h] =
                    make_uint4(r[0], r[1], r[2], r[3]);
            }
        }
    } else {
        const bool wfast = address_bit(sw.lo, L, sw.st, sw.st_refl) == 0 ||
                           address_bit(sw.hi - 1, L, sw.st, sw.st_refl) == 0;
        for (int e = threadIdx.x; e < nv; e += blockDim.x) {
            const int v = wfast ? e & smask : e >> c;
            const int col = wfast ? e >> s : e & cmask;
            const unsigned mi = rest | (static_cast<unsigned>(v) << sw.lo) |
                                (static_cast<unsigned>(col) << sw.cb);
            const long long a = address(mi, L, sw.st, sw.st_refl);
            const int p = tile_slot(v | (col << s), s);
            uint32_t wv = 0, wv_sh = 0;
            if (kPairing && sw.last) {
                wv = __ldg(tw + 6 * n + mi);
                wv_sh = __ldg(tw + 7 * n + mi);
            }
            for (int o = 0; o < out_ops; ++o)
                (o ? dst1 : out0)[dst_base + a] =
                    finish(tile[o * stride + p], wv, wv_sh);
        }
    }
}

using SweepKernel = void (*)(const uint32_t*, const uint32_t*, long long,
                             uint32_t*, uint32_t*, long long, const uint32_t*,
                             const uint32_t*, const uint32_t*, int, Mod,
                             uint32_t, Sweep);

SweepKernel kernel_for(int kind) {
    switch (kind) {
        case kB1: return sweep_kernel<kB1>;
        case kB4: return sweep_kernel<kB4>;
        case kB2: return sweep_kernel<kB2>;
        case kB3: return sweep_kernel<kB3>;
        case kGsCt: return sweep_kernel<kGsCt>;
        case kCtCt: return sweep_kernel<kCtCt>;
        case kGsGs: return sweep_kernel<kGsGs>;
        case kCtGs: return sweep_kernel<kCtGs>;
        case kStk: return sweep_kernel<kStk>;
        default: return nullptr;
    }
}

// The column bits ops/passes.py _sweep_cols picks: those whose load
// addresses are the address's bits 0, 1, 2, while they lie outside the
// window and side by side.
void expected_cols(int L, int lo, int hi, int ld, int ld_refl, int* cb,
                   int* c) {
    int first = 0, count = 0, prev = -1;
    for (int a = 0; a < kCols; ++a) {
        int i = 0;
        while (i < L && address_bit(i, L, ld, ld_refl) != a) ++i;
        if (i == L || (i >= lo && i < hi) ||
            (count && (i - prev != 1 && prev - i != 1)))
            break;
        first = count ? (i < first ? i : first) : i;
        prev = i;
        ++count;
    }
    *cb = count ? first : 0;
    *c = count;
}

// ops/passes.py sweep_vec: how a launch loads and stores.
int expected_vec(int kind, int lo, int hi, int cb, int c) {
    if (kind == kStk) return 0;
    if (c == kCols && cb == 0) return 2;
    return lo == 0 && c == 0 && hi - lo >= 2 ? 1 : 0;
}

// The plan ops/passes.py sweep_plan makes for its kind at 2^L, restated
// field for field from its windows: two or three windows covering [0, L)
// from the narrowest, each of at least one bit (B2 and B3 also one to three
// covering [low, L), 0 < low < L: sweep_plan's low, the bits below left to
// the split forms' kernels); the launches' order, their windows,
// transforms, Stockham maps, columns, operands, tiles, threads (512 for a
// tile of at most 2^kUpperBits values), shared memory (the tile and its
// bases) and load shape.  Any other plan is refused.
bool plan_ok(const SweepPlan& p, int L) {
    const int low = p.win_lo[0];
    if (p.kind < 0 || p.kind >= kKinds || p.logn != L ||
        p.windows < (low ? 1 : 2) || p.windows > kMaxWindows || low < 0 ||
        low >= L || (low && p.kind != kB2 && p.kind != kB3) ||
        p.win_hi[p.windows - 1] != L)
        return false;
    for (int w = 0; w < p.windows; ++w)
        if (p.win_hi[w] <= p.win_lo[w] ||
            (w > 0 && p.win_lo[w] != p.win_hi[w - 1]))
            return false;
    const int F = fwd_scheme(p.kind), I = inv_scheme(p.kind);
    const int W = p.windows, nops = operands(p.kind);
    const bool both = F != kNone && I != kNone;
    if (p.sweeps != (both ? 2 * W - 1 : W)) return false;
    for (int i = 0; i < p.sweeps; ++i) {
        int w;
        bool fw, iv;
        if (both) {
            w = i < W - 1 ? W - 1 - i : i - (W - 1);
            fw = i <= W - 1;
            iv = i >= W - 1;
        } else if (I == kNone) {
            w = W - 1 - i, fw = true, iv = false;
        } else {
            w = i, fw = false, iv = true;
        }
        const int lo = p.win_lo[w], hi = p.win_hi[w];
        int ld = 0, ld_refl = 0, st = 0, st_refl = 0;
        if (p.kind == kStk) {
            if (fw && iv)
                ld = L - hi, st = hi, st_refl = 1;
            else if (fw)
                ld = L - hi, st = L - lo;
            else
                ld = lo, ld_refl = 1, st = hi, st_refl = 1;
        }
        int cb, c;
        expected_cols(L, lo, hi, ld, ld_refl, &cb, &c);
        const int S = hi - lo + c;
        const bool join = (nops << S) <= (1 << kUpperBits);
        const int ops = fw && (iv || join) ? nops : 1;
        const int split = fw && !iv && !join ? nops : 1;
        if (S > kTileBits || (ops << S) > (1 << kTileBits)) return false;
        const int groups = 1 << (S > kPassBits ? S - kPassBits : 0);
        const int most =
            (ops << S) > (1 << kUpperBits) ? kMaxThreads : kHalfThreads;
        const int threads = groups < 32 ? 32 : (groups > most ? most : groups);
        const int stride = (1 << S) + ((1 << S) >> 5) + (1 << c);
        const int smem =
            4 * (ops * stride + 4 * ((hi - lo) << c) + 4 * kExactWords);
        if (p.lo[i] != lo || p.hi[i] != hi || p.fwd[i] != fw ||
            p.inv[i] != iv || p.cb[i] != cb || p.cols[i] != c ||
            p.ops[i] != ops || p.split[i] != split || p.ld[i] != ld ||
            p.ld_refl[i] != ld_refl || p.st[i] != st ||
            p.st_refl[i] != st_refl || p.tiles[i] != 1 << (L - S) ||
            p.threads[i] != threads || p.smem[i] != smem ||
            p.smem[i] > qt::kMaxSmem ||
            p.vec[i] != expected_vec(p.kind, lo, hi, cb, c))
            return false;
    }
    return true;
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Launch `sweep` of a call under `plan`: it reads x (and y) at launch 0,
// else scratch a or b (launch i - 1's), and writes z at the last, else
// scratch a (even i) or b (odd i); a and b hold the kind's operands' rows
// (2n words a row for B1 and the pairings, n for B2-B4), z and x n.  pw:
// the (4, min(n, 2^14)) in-window powers of the table tw.  A launch whose
// buffers are not 16-byte aligned loads and stores a value at a time.
extern "C" int qt_pass_sweep(const void* x, const void* y, void* z, void* a,
                             void* b, const void* tw, const void* pw,
                             long long batch, int n, int logn, uint32_t q,
                             uint32_t r32, uint32_t r32_sh, uint32_t one_sh,
                             const void* plan, int sweep, void* stream) {
    if (!plan || logn < 2 || logn > kMaxLogn || n != 1 << logn ||
        batch <= 0 || !x || !z || !tw || !pw)
        return cudaErrorInvalidValue;
    const SweepPlan pl = *static_cast<const SweepPlan*>(plan);
    if (!plan_ok(pl, logn) || sweep < 0 || sweep >= pl.sweeps)
        return cudaErrorInvalidValue;
    const int nops = operands(pl.kind);
    if ((nops == 2 || pl.kind == kB4) && !y) return cudaErrorInvalidValue;
    if ((pl.sweeps > 1 && !a) || (pl.sweeps > 2 && !b))
        return cudaErrorInvalidValue;
    const long long scratch_row = static_cast<long long>(nops) * n;
    const uint32_t* src0;
    const uint32_t* src1 = nullptr;
    long long src_row;
    if (sweep == 0) {
        src0 = static_cast<const uint32_t*>(x);
        if (nops == 2) src1 = static_cast<const uint32_t*>(y);
        src_row = n;
    } else {
        src0 = static_cast<const uint32_t*>((sweep - 1) % 2 ? b : a);
        src1 = src0 + n;
        src_row = scratch_row;
    }
    uint32_t* dst0;
    uint32_t* dst1 = nullptr;
    long long dst_row;
    if (sweep == pl.sweeps - 1) {
        dst0 = static_cast<uint32_t*>(z);
        dst_row = n;
    } else {
        dst0 = static_cast<uint32_t*>(sweep % 2 ? b : a);
        dst1 = dst0 + n;
        dst_row = scratch_row;
    }
    const bool aligned = aligned16(src0) && (!src1 || aligned16(src1)) &&
                         aligned16(dst0) && aligned16(tw);
    const Sweep sw{pl.lo[sweep],      pl.hi[sweep],
                   pl.fwd[sweep],     pl.inv[sweep],
                   pl.cb[sweep],      pl.cols[sweep],
                   pl.ops[sweep],     pl.split[sweep],
                   pl.ld[sweep],      pl.ld_refl[sweep],
                   pl.st[sweep],      pl.st_refl[sweep],
                   pl.tiles[sweep],   aligned ? pl.vec[sweep] : 0,
                   sweep == 0,        sweep == pl.sweeps - 1};
    const long long blocks =
        batch * static_cast<long long>(pl.split[sweep]) * pl.tiles[sweep];
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    const SweepKernel kernel = kernel_for(pl.kind);
    const int smem = pl.smem[sweep];
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    const Mod m{q, r32, r32_sh, one_sh};
    kernel<<<dim3(static_cast<unsigned>(blocks)),
             static_cast<unsigned>(pl.threads[sweep]),
             static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        src0, src1, src_row, dst0, dst1, dst_row,
        static_cast<const uint32_t*>(y), static_cast<const uint32_t*>(tw),
        static_cast<const uint32_t*>(pw), logn, m, 2u * q, sw);
    return cudaGetLastError();
}
