"""The register-pass schedule shared by the pass kernels (B10's five
pairings, B1, B4, B2, B3), and a model of those kernels on the CPU.

A row of n = 2^L values is held by T = n / R threads, R values of each
operand a thread; a pass runs up to r = log2(R) stages in registers on the
window [b, b + r) of index bits, and the values go through shared memory
between passes (see ``csrc/pass_stages.cuh``).  ``pass_plan`` makes the
schedule a kernel's launcher takes: R, threads a row, rows a block, each
pass's stages and window, the shared memory a row, and, where one block
cannot hold a row (n >= 32768; B2 and B3 from 65536), the cluster of C
blocks on C SMs that holds it, the virtual thread each exchange hands
thread t (t or brev(t): ``thread_maps``, the pairings' alone) and which
exchanges cross its blocks (``cross_mask``); it refuses what the launcher
refuses.  ``PassModel`` runs a schedule on the CPU with the kernels' index
maps, exchanges through a model of each block's shared memory at the
kernels' padded addresses (a cluster's blocks each holding n / C values
of each operand, each value pushed to the block that reads it) and uint32
lazy arithmetic (asserted), so
that the CPU twins ``ntt_pairings.polymul_pairing_passes_plain``,
``ntt_fused.polymul_fused_passes_plain``,
``ntt_fused.polymul_fixed_fused_passes_plain``,
``ntt_fused.ntt_passes_plain`` and ``ntt_fused.intt_passes_plain`` hold the
schedules themselves against the plain pipelines and JAX.

Past a cluster's reach (``cluster_reach``: B1, B4 and the pairings from
2^18, B2 and B3 from 2^19) the kernels run their sweep form
(``csrc/pass_sweeps.cu``) to 2^25, the largest ring the registry takes:
``sweep_plan`` parts the index bits into two or three windows and gives
each launch its window, transforms, columns, operands, tiles and Stockham
maps; ``kernel_plan`` picks the pass or sweep plan a kernel runs at n;
``SweepModel`` runs a sweep plan's launches through a model of device
memory (the CPU twins' sweep path).

Stockham's windows follow its autosort: in the block form, at the start of
each pass thread t holds the Stockham positions t + c 2^tb (tb = L - r) of
the stage st the pass starts at (a cluster's exchanges hand out the maps
of ``thread_maps`` instead, as the other pairings').  Position p at stage
st is DIF index ``stockham_index(p, st, L)``; in DIF indices a pass's
window then has its top at the pass's widest stage (b = hi - r, so the
last pass covers r stages), and thread t is the virtual thread
``stockham_thread(t, st, tb)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import modmul as MM

__all__ = ["MAX_PASSES", "MAX_CLUSTER", "PASS_SHAPES", "PassPlan",
           "schedule", "pass_plan", "cross_mask", "block_bits",
           "thread_maps", "exchange_layouts",
           "map_thread", "twiddle_lines", "swizzle", "layout_word",
           "OWN", "REFL", "SWAP",
           "describe_pass_plan",
           "brev", "stockham_thread", "stockham_index", "PassModel",
           "SWEEP_KINDS", "MAX_SWEEP_LOGN", "SweepPlan", "cluster_reach",
           "kernel_plan",
           "address_bit", "stockham_address", "sweep_plan", "sweep_threads",
           "sweep_stride", "sweep_smem", "sweep_vec", "sweep_powers_of",
           "describe_sweep_plan", "sweep_launch_bytes", "sweep_reads",
           "SweepModel"]

MAX_PASSES = 4
# (R, passes) the launchers have a kernel for: R = n up to 32 in one pass a
# transform, R = 32 in two passes (n <= 1024), three (n <= 32768) or four
# (n <= 2^20, in a cluster)
PASS_SHAPES = frozenset({(2, 1), (4, 1), (8, 1), (16, 1), (32, 1), (32, 2),
                         (32, 3), (32, 4)})
# threads a block the kernels are built for (__launch_bounds__); the
# kernel of one transform (B2, B3) takes 1024 from three passes
_MAX_THREADS = {1: 256, 2: 256, 3: 512, 4: 512}
_MAX_THREADS_ONE = {1: 256, 2: 256, 3: 1024, 4: 1024}
_BLOCK_THREADS = 256
# blocks a cluster may take without the non-portable size (8 SMs)
MAX_CLUSTER = 8


class PassPlan(ctypes.Structure):
    """The pass kernels' run-time plan; field for field the ``PassPlan``
    struct of ``csrc/pass_stages.cuh``.  Pass p of the forward runs the
    stages of half-width 2^k, k in [fwd_lo[p], fwd_hi[p]), on the register
    window [fwd_b[p], fwd_b[p] + log2(radix)); the inverse's likewise.
    ``row_stride``: words of shared memory a row (0 for one pass), or a
    block of a cluster.  ``cluster``: the blocks that hold one row (1: a
    block holds ``rows`` rows); ``cross``: bit e set when the kernel's e-th
    exchange crosses the cluster's blocks (``cross_mask``); ``refl``: bit
    e set when after the e-th exchange thread t of the row holds the
    virtual thread brev(t), the reflected map, not t (``thread_maps``; 0
    but in a pairing's cluster plan); ``pull``, ``low``: how a cluster's
    exchange that does not stay between own windows in a block lays out
    its buffer (``exchange_layouts``); ``swap``: bit e set when after the
    e-th exchange thread t holds the swapped map (``map_thread``), 0 but
    in a pairing's cluster plan."""

    _fields_ = [(f, ctypes.c_int32) for f in (
        "radix", "threads", "rows", "passes", "row_stride", "cluster",
        "cross")] + [
        (f, ctypes.c_int32 * MAX_PASSES) for f in (
            "fwd_lo", "fwd_hi", "fwd_b", "inv_lo", "inv_hi", "inv_b")] + [
        ("refl", ctypes.c_int32), ("pull", ctypes.c_int32),
        ("low", ctypes.c_int32), ("swap", ctypes.c_int32)]


def _log2(n: int) -> int:
    return n.bit_length() - 1


def schedule(L: int, r: int, sizes: list[int], up: bool,
             stockham: bool = False):
    """(lo, hi, window) of each pass: from the narrowest stage up (``up``)
    or from the widest down; the window [b, b + r) is the highest that
    holds the pass (b = min(lo, L - r)), or under Stockham's rule the one
    whose top is the pass's widest stage (b = hi - r)."""
    out, edge = [], 0 if up else L
    for s in sizes:
        lo, hi = (edge, edge + s) if up else (edge - s, edge)
        out.append((lo, hi, hi - r if stockham else min(lo, L - r)))
        edge = hi if up else lo
    return out


@functools.lru_cache(maxsize=None)
def pass_plan(n: int, fwd_up: bool | None, inv_up: bool | None,
              stockham: bool = False, operands: int = 2) -> PassPlan:
    """The schedule of a pass kernel at row length ``n`` whose forward runs
    from the narrowest stage up (``fwd_up``) or the widest down, likewise
    its inverse: R = min(n, 32) values of each operand a thread, n / R
    threads a row, rows enough for a block of 256 threads (one row when a
    row takes more), ceil(log2(n) / log2(R)) passes a transform, the stages
    split as evenly as they go, larger first; under Stockham's windows the
    last pass takes r stages and the others split the rest so; shared
    memory a row for the ``operands`` its exchanges carry (2, or 1 for
    B4's, whose forward runs on x alone).  ``fwd_up`` None: no forward
    passes (B3, the inverse alone, from the narrowest stage up on one
    operand), the forward's fields 0; ``inv_up`` None: no inverse passes
    (B2, the forward alone, from the widest stage down on one operand), the
    inverse's fields 0; either way a block of up to 1024 threads from three
    passes (512 with both transforms).  A row of more threads than its
    kernel's block takes (n >= 32768 with both transforms, 65536 with one)
    spans a cluster of C = T / most blocks, each holding n / C values of
    each operand in its shared memory (``row_stride`` words a block), one
    row a cluster; ``cross`` marks the exchanges that go between them, a
    pairing's ``refl`` and ``swap`` the virtual thread each exchange hands
    thread t (``thread_maps``), ``pull`` and ``low`` how each lays out its
    buffer (``exchange_layouts``).
    Raises for what the launchers refuse: an n that is not a power of two
    from 2, more than four passes (n > 2^20), a cluster of more than
    ``MAX_CLUSTER`` blocks (n > 131072 with both transforms, 262144 with
    one), an inverse alone that is not on one operand from the narrowest
    stage up, a forward alone that is not on one operand from the widest
    stage down, a plan of neither.  The returned plan is cached: copy it
    before changing a field."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"n={n}: not a power of two from 2")
    if operands not in (1, 2):
        raise ValueError(f"{operands} operands: the kernels carry 1 or 2")
    if fwd_up is None and inv_up is None:
        raise ValueError("a plan runs a forward, an inverse or both")
    if fwd_up is None and (not inv_up or stockham or operands != 1):
        raise ValueError("an inverse alone runs on one operand from the "
                         "narrowest stage up, in cyclic windows")
    if inv_up is None and (fwd_up or stockham or operands != 1):
        raise ValueError("a forward alone runs on one operand from the "
                         "widest stage down, in cyclic windows")
    L = _log2(n)
    R = min(n, 32)
    r = _log2(R)
    P = -(-L // r)
    if (R, P) not in PASS_SHAPES:
        raise ValueError(f"n={n}: {P} passes, no kernel (kernels for "
                         f"(radix, passes) in {sorted(PASS_SHAPES)})")
    T = n // R
    rows = max(1, _BLOCK_THREADS // T)
    one = fwd_up is None or inv_up is None
    most = (_MAX_THREADS_ONE if one else _MAX_THREADS)[P]
    cluster = max(1, T // most)
    if cluster > MAX_CLUSTER:
        raise ValueError(
            f"n={n}: {T} threads a row, a cluster of {cluster} blocks of "
            f"{most}, more than the {MAX_CLUSTER} a cluster takes (n <= "
            f"{MAX_CLUSTER * most * R})")
    stride = 0
    if P > 1:
        # each operand, index i at i + i // 32; rows of fewer than 32
        # threads share a warp, so a row's banks start T past its
        # neighbour's.  A block of at most 512 threads holds at most 16384
        # values an operand (one of 1024, 32768 of one): 135 KB, inside the
        # 227 KB a block may take.
        m = n // cluster
        stride = (-(-operands * (m + m // 32) // 32) * 32
                  + (T if T < 32 else 0))
    if stockham:
        q, rem = divmod(L - r, P - 1) if P > 1 else (0, 0)
        sizes = [q + 1] * rem + [q] * (P - 1 - rem) + [min(L, r)]
    else:
        q, rem = divmod(L, P)
        sizes = [q + 1] * rem + [q] * (P - rem)
    fields = {}
    for side, up in (("fwd", fwd_up), ("inv", inv_up)):
        if up is None:
            continue
        sched = schedule(L, r, sizes, up, stockham)
        for i, f in enumerate(("lo", "hi", "b")):
            fields[f"{side}_{f}"] = (ctypes.c_int32 * MAX_PASSES)(
                *(p[i] for p in sched))
    plan = PassPlan(radix=R, threads=T, rows=rows, passes=P,
                    row_stride=stride, cluster=cluster, **fields)
    if cluster > 1 and fwd_up is not None and inv_up is not None and (
            operands == 2):
        plan.refl, plan.swap = thread_maps(plan, L, fwd_up, inv_up)
    plan.cross = cross_mask(plan, L, fwd_up, inv_up)
    plan.pull, plan.low = exchange_layouts(plan, L, fwd_up, inv_up)
    return plan


# a cluster's virtual thread maps (``map_thread``)
OWN, REFL, SWAP = 0, 1, 2


def map_thread(t, m: int, tb: int, c: int):
    """Thread t's virtual thread in a row of 2^tb threads over 2^c blocks
    (lb = tb - c thread bits a block) under map m: t (own), brev(t)
    (reflected), or the swapped map, the block bits reversed into the
    lowest c bits above the block's own thread bits: ((t mod 2^lb) << c) |
    brev_c(t >> lb) (int or int64 tensor)."""
    if m == OWN:
        return t
    if m == REFL:
        return brev(t, tb)
    lb = tb - c
    return ((t & ((1 << lb) - 1)) << c) | brev(t >> lb, c)


def _vbit(j: int, m: int, tb: int, c: int) -> int:
    """The virtual thread bit that thread bit j lands on under map m."""
    if m == OWN:
        return j
    if m == REFL or j >= tb - c:
        return tb - 1 - j
    return j + c


def _walk(plan: PassPlan, L: int, fwd_up: bool | None, inv_up: bool | None,
          refl: int, swap: int = 0):
    """The states (window b, map) a kernel's rows go through under the
    maps ``refl`` and ``swap`` (bit e: exchange e hands thread t the
    reflected or the swapped map, ``map_thread``; neither: the own map):
    a list of ((b, m), (b2, m2)) a exchange in the order the kernel runs
    them (B3's first one into [0, r), the forward's between passes, B2's
    last one back to [tb, L), the inverse's), the state the store reads
    (after a DIF or Stockham inverse's bit reversal) and the state each
    pass runs on.  The load leaves a row on [tb, L) under the own map; a
    bit reversal renames (b, own) to (tb - b, reflected) and back; it
    takes no swapped map (ValueError), nor does an exchange take both."""
    tb = L - _log2(plan.radix)
    if refl & swap:
        raise ValueError(f"exchanges {refl & swap:#x} take two maps")
    out, passes, state = [], [], (tb, OWN)

    def exchange(b2):
        nonlocal state
        e = len(out)
        to = (b2, REFL if refl >> e & 1 else SWAP if swap >> e & 1 else OWN)
        out.append((state, to))
        state = to

    def reverse():
        nonlocal state
        if state[1] == SWAP:
            raise ValueError("a bit reversal of the swapped map")
        state = (tb - state[0], REFL - state[1])

    def run(windows):
        for p in range(plan.passes):
            if p:
                exchange(windows[p])
            passes.append(state)

    if fwd_up is not None:
        if fwd_up:          # a DIT forward's bit reversal of the load
            reverse()
        run(plan.fwd_b)
        if inv_up is None:
            exchange(tb)
        elif (not fwd_up) != inv_up:
            reverse()
    else:
        exchange(0)
    if inv_up is not None:
        run(plan.inv_b)
        if not inv_up:      # a DIF or Stockham inverse's bit reversal
            reverse()
    return out, state, passes


def block_bits(b: int, m: int, tb: int, r: int, c: int) -> tuple:
    """The index bits that thread bits tb - c .. tb - 1 (the block of a
    cluster of 2^c blocks the thread lies in) hold on the window [b, b + r)
    under map m (``map_thread``): virtual thread bit v is index bit v
    below the window, v + r above."""
    out = []
    for j in range(tb - c, tb):
        v = _vbit(j, m, tb, c)
        out.append(v if v < b else v + r)
    return tuple(out)


def cross_mask(plan: PassPlan, L: int, fwd_up: bool | None,
               inv_up: bool | None) -> int:
    """Bit e set: the kernel's e-th exchange (``_walk``'s order) goes
    between the blocks of ``plan``'s cluster; 0 for a block that holds its
    rows.  Thread t of a row lies in block t >> (tb - c) (C = 2^c), and in
    a cluster its virtual thread is t or, where ``plan.refl`` or
    ``plan.swap`` says so, its reflected or swapped map (``map_thread``;
    Stockham's autosort map is the block form's alone).  An exchange stays
    in its block exactly when the block's thread bits hold the same index
    bits on both sides (``block_bits``): then every value's reader lies in
    the block of its writer.  Raises for maps or layout bits past the
    kernel's exchanges, two maps on one exchange, a bit reversal of the
    swapped map, an exchange that stays in its block but goes to the own
    map from another (the kernels run such an exchange as the block
    form's, own map to own map), or a pull that stays in its block.  The
    launcher (``csrc/pass_stages.cuh`` cross_mask) computes the same bits
    and refuses a plan that differs."""
    if plan.cluster == 1:
        return 0
    r = _log2(plan.radix)
    tb, c = L - r, _log2(plan.cluster)
    mask = 0
    ex = _walk(plan, L, fwd_up, inv_up, plan.refl, plan.swap)[0]
    bits = plan.refl | plan.swap | plan.pull | plan.low
    if bits >> len(ex) or bits < 0:
        raise ValueError(f"maps or layouts {bits:#x} past the kernel's "
                         f"{len(ex)} exchanges")
    for e, ((b, m), (b2, m2)) in enumerate(ex):
        if block_bits(b, m, tb, r, c) != block_bits(b2, m2, tb, r, c):
            mask |= 1 << e
        elif m2 == OWN and m != OWN:
            raise ValueError(f"exchange {e} stays in its block but goes to "
                             f"the own map from another")
    if plan.pull & ~mask:
        raise ValueError(f"pulled exchanges {plan.pull & ~mask:#x} stay in "
                         f"their blocks")
    return mask


def swizzle(a: int) -> int:
    """A word of an exchange's buffer laid out for the threads of one side
    (``exchange_layouts``): address a (below 2^30; int or int64 tensor)
    with its low five bits xored with every five bits above them, so that
    32 lanes whose bits of a fall on five distinct bit positions mod 5
    meet 32 distinct banks."""
    f = 0
    for k in range(5, 31, 5):
        f = f ^ ((a >> k) & 31)
    return a ^ f


def _holder(i: int, b: int, m: int, tb: int, r: int, c: int):
    """(thread, register) that hold index i on the window [b, b + r) under
    map m."""
    vt = (i & ((1 << b) - 1)) | ((i >> (b + r)) << b)
    reg = (i >> b) & ((1 << r) - 1)
    if m == REFL:
        return brev(vt, tb), reg
    if m == SWAP:
        lb = tb - c
        return (brev(vt & ((1 << c) - 1), c) << lb) | (vt >> c), reg
    return vt, reg


def layout_word(t: int, reg: int, lb: int, low: bool) -> int:
    """The word of thread t's register reg in its block's buffer of an
    exchange laid out for its side: l + reg 2^lb (l = t mod 2^lb), or,
    ``low``, 32 l + reg, swizzled."""
    l = t & ((1 << lb) - 1)
    return swizzle((l << 5) | reg if low else l | (reg << lb))


def _exchange_cost(frm, to, tb: int, r: int, c: int, cross: bool,
                   pull: bool, low: bool) -> int:
    """Transactions a warp's store and load of one register take in an
    exchange from state ``frm`` to ``to`` laid out so: distinct 32-word
    lines where the side reaches other blocks, the most lanes on one bank
    where it stays in its own; lanes of block 0, summed over a few
    registers."""
    lb = tb - c
    side = frm if pull else to
    total = 0
    for (b, m), remote in ((frm, cross and not pull), (to, cross and pull)):
        for reg in (0, 1, 17, 31):
            words = []
            for lane in range(32):
                vt = map_thread(lane, m, tb, c)
                i = ((vt & ((1 << b) - 1)) | ((vt >> b) << (b + r))
                     | (reg << b))
                th, rh = _holder(i, *side, tb, r, c)
                words.append((th >> lb, layout_word(th, rh, lb, low)))
            if remote:
                total += len({(k, w >> 5) for k, w in words})
            else:
                banks = [w & 31 for _, w in words]
                total += max(banks.count(x) for x in set(banks))
    return total


def exchange_layouts(plan: PassPlan, L: int, fwd_up: bool | None,
                     inv_up: bool | None) -> tuple[int, int]:
    """(pull, low) of a cluster plan: bit e of each for the kernel's e-th
    exchange (``_walk``'s order) where it does not stay between own
    windows in its block.  Such an exchange lays out each block's buffer
    for the threads of one side (``layout_word``: register c of the
    block's thread l at l + c 2^lb, lb thread bits a block, or, ``low``,
    at 32 l + c, swizzled): the readers' (a push: the writers store each
    value into the block of its reader at the reader's word and the
    readers load their own block's), or, ``pull`` (crossing exchanges
    alone), the writers' (they store in their own block, the readers load
    from the writers' blocks).  Of the four, the one whose accesses take
    the fewest transactions (``_exchange_cost``: neighbouring lanes on
    neighbouring words where a side reaches other blocks, on distinct banks
    where it stays in its own).  0 for a block plan."""
    if plan.cluster == 1:
        return 0, 0
    r = _log2(plan.radix)
    tb, c = L - r, _log2(plan.cluster)
    pull = low = 0
    for e, (frm, to) in enumerate(
            _walk(plan, L, fwd_up, inv_up, plan.refl, plan.swap)[0]):
        cross = bool(plan.cross >> e & 1)
        if not cross and to[1] == OWN:
            continue
        options = [(p_, l_) for p_ in ((False, True) if cross else (False,))
                   for l_ in (False, True)]
        p_, l_ = min(options, key=lambda o: _exchange_cost(
            frm, to, tb, r, c, cross, *o))
        pull |= p_ << e
        low |= l_ << e
    return pull, low


def twiddle_lines(b: int, m: int, tb: int, c: int) -> int:
    """The 32-word lines a warp's cyclic twiddle read touches on the
    window [b, b + r) under map m: entry 2^k + (vt mod 2^b) + ..., the
    lanes' virtual threads below the window."""
    vt = map_thread(torch.arange(32), m, tb, c)
    return int(((vt & ((1 << b) - 1)) >> 5).unique().numel())


def thread_maps(plan: PassPlan, L: int, fwd_up: bool,
                inv_up: bool) -> tuple[int, int]:
    """The maps (``PassPlan.refl``, ``.swap``) a pairing's cluster plan
    takes: of those that leave the store on [tb, L) under the own map
    (neighbouring threads store neighbouring values), the ones whose
    exchanges cross the fewest times, then whose passes' twiddle reads and
    exchanges take the fewest transactions (``twiddle_lines``,
    ``_exchange_cost`` under ``exchange_layouts``' choice), then the
    fewest swapped, then the fewest reflected.  The own map everywhere is
    the merged kernels' (B1-B4), whose schedules it already suits."""
    r = _log2(plan.radix)
    tb, c = L - r, _log2(plan.cluster)
    n_ex = len(_walk(plan, L, fwd_up, inv_up, 0)[0])
    cands = []
    for code in range(3 ** n_ex):
        refl = swap = 0
        for e in range(n_ex):
            code, d = divmod(code, 3)
            refl |= (d == REFL) << e
            swap |= (d == SWAP) << e
        try:
            ex, last, passes = _walk(plan, L, fwd_up, inv_up, refl, swap)
        except ValueError:
            continue
        if last != (tb, OWN):
            continue
        crossings = sum(block_bits(*a, tb, r, c) != block_bits(*z, tb, r, c)
                        for a, z in ex)
        if any(block_bits(*a, tb, r, c) == block_bits(*z, tb, r, c)
               and z[1] == OWN != a[1] for a, z in ex):
            continue
        lines = sum(twiddle_lines(b, m, tb, c) for b, m in passes)
        cands.append((crossings, lines, bin(swap).count("1"),
                      bin(refl).count("1"), refl, swap, ex))
    least = min(k[0] for k in cands)
    best = None
    for crossings, lines, ns, nr, refl, swap, ex in cands:
        if crossings > least:
            continue
        cost = lines
        for e, (a, z) in enumerate(ex):
            cross = block_bits(*a, tb, r, c) != block_bits(*z, tb, r, c)
            if cross or z[1] != OWN:
                cost += min(_exchange_cost(a, z, tb, r, c, cross, p_, l_)
                            for p_ in ((False, True) if cross else (False,))
                            for l_ in (False, True))
        key = (cost, ns, nr, refl, swap)
        best = key if best is None or key < best else best
    return best[3], best[4]


def describe_pass_plan(plan: PassPlan) -> str:
    """One line: R, threads and rows, each transform's passes ("none" for
    a plan with no forward or no inverse)."""
    def passes(side):
        lo, hi, b = (getattr(plan, f"{side}_{f}") for f in ("lo", "hi", "b"))
        if not any(hi[:plan.passes]):
            return "none"
        return " ".join(f"[{lo[p]},{hi[p]})@{b[p]}"
                        for p in range(plan.passes))
    where = ("a row" if plan.cluster == 1 else
             f"a block, a cluster of {plan.cluster} blocks a row (exchanges "
             f"crossing blocks: mask {plan.cross:#x}; reflected maps "
             f"{plan.refl:#x}, swapped {plan.swap:#x}; pulled "
             f"{plan.pull:#x}, registers lowest {plan.low:#x})")
    return (f"R={plan.radix}, threads a row {plan.threads}, rows a block "
            f"{plan.rows}, passes a transform {plan.passes} (stages [lo,hi)@"
            f"window: forward {passes('fwd')}, inverse {passes('inv')}), "
            f"{plan.row_stride * 4} bytes of shared memory {where}")


def brev(v, bits: int):
    """v with its low ``bits`` bits reversed (int or int64 tensor)."""
    out = torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0
    for k in range(bits):
        out |= ((v >> k) & 1) << (bits - 1 - k)
    return out


def stockham_thread(t, st: int, tb: int):
    """The DIF virtual thread whose window [tb - st, L - st) holds the
    Stockham positions t + c 2^tb of stage st."""
    return (t >> st) | (brev(t & ((1 << st) - 1), st) << (tb - st))


def stockham_index(p, st: int, L: int):
    """The DIF index of Stockham position p at stage st: (p >> st) |
    brev_st(p mod 2^st) << (L - st)."""
    return (p >> st) | (brev(p & ((1 << st) - 1), st) << (L - st))


class PassModel:
    """One pass kernel's rows on the CPU: values V of shape (rows,
    operands, T, R) in int64 holding uint32 values, thread t holding R
    registers in the window [b, b + r) of its virtual thread vt, rows
    padded to whole blocks of ``plan.rows`` (a row past the batch computes
    on row 0); a row of a cluster plan spans ``plan.cluster`` blocks,
    thread t in block t >> (tb - c)."""

    def __init__(self, plan: PassPlan, n: int, q: int, batch: int):
        self.plan, self.n, self.q = plan, n, q
        self.L, self.r = _log2(n), _log2(plan.radix)
        self.tb = self.L - self.r
        self.blocks = -(-batch // plan.rows)
        self.t = torch.arange(plan.threads)
        self.c = torch.arange(plan.radix)
        self.exchanges = 0      # the kernel's exchanges so far

    def pad(self, a: torch.Tensor) -> torch.Tensor:
        rows = self.blocks * self.plan.rows
        return torch.cat([a, a[:1].expand(rows - a.shape[0], self.n)])

    def window(self, vt, b):
        """(T, R) indices the threads hold in the window [b, b + r)."""
        assert 0 <= b <= self.tb
        base = (vt & ((1 << b) - 1)) | ((vt >> b) << (b + self.r))
        return base[:, None] | (self.c << b)[None, :]

    def bit_reverse(self, V, b, vt):
        """The kernels' renaming: registers, virtual thread and window."""
        return V[..., brev(self.c, self.r)], self.tb - b, brev(vt, self.tb)

    def exchange(self, V, b, vt, b2, vt2):
        """Through each row's shared memory at the kernels' addresses, from
        the window [b, b + r) of vt to [b2, b2 + r) of vt2.  A block holds
        its rows at index i's padded address i + i / 32.  In a cluster
        (each block m = n / C values of each operand, thread t in block t
        >> lb, lb = tb - log2 C) an exchange that stays between own
        windows in a block is the block form's on the block's own indices,
        i mod m; any other lays the buffer out for the threads of one side
        (``exchange_layouts``, ``layout_word``): the readers' (a push) or,
        ``pull``, the writers'.  An exchange that ``plan.cross`` keeps in
        its block is asserted to send no value to another block."""
        plan, n, C = self.plan, self.n, self.plan.cluster
        m = n // C
        stride = m + m // 32
        rows = self.blocks * plan.rows
        smem = torch.zeros(rows * C * max(plan.row_stride, 1),
                           dtype=torch.int64)
        row_base = torch.arange(rows) * plan.row_stride * C
        ops = torch.arange(V.shape[1])[None, :, None, None] * stride
        e = self.exchanges
        cross = plan.cross >> e & 1
        self.exchanges += 1
        src, dst = self.window(vt, b), self.window(vt2, b2)
        lb = self.tb - _log2(C)
        if C == 1:
            side, block, slot = dst, torch.zeros_like(dst), dst + (dst >> 5)
        else:
            block = (self.t >> lb)[:, None].expand_as(dst)
            local = (self.t & ((1 << lb) - 1))[:, None]
            if not (cross or (plan.refl | plan.swap) >> e & 1):
                # the block form's exchange on the block's indices
                side = dst
                slot = ((local & ((1 << b2) - 1))
                        | ((local >> b2) << (b2 + self.r))
                        | (self.c << b2)[None, :])
                slot = slot + (slot >> 5)
            else:
                side = src if plan.pull >> e & 1 else dst
                if plan.low >> e & 1:
                    slot = swizzle((local << 5) | self.c[None, :])
                else:
                    slot = swizzle(local | (self.c << lb)[None, :])
        assert slot.max() < stride and V.shape[1] * stride <= plan.row_stride
        at = block * plan.row_stride + slot
        assert at.unique().numel() == n
        # each index's address, by the side whose layout holds it
        where = torch.empty(n, dtype=torch.int64)
        where[side] = at
        if C > 1 and not cross:
            reader = torch.empty(n, dtype=torch.int64)
            reader[dst] = (self.t >> lb)[:, None].expand_as(dst)
            assert bool((reader[src] == (self.t >> lb)[:, None]).all())
        smem[row_base[:, None, None, None] + ops + where[src]] = V
        return smem[row_base[:, None, None, None] + ops + where[dst]], b2, vt2

    def cyclic_stages(self, V, b, vt, lo, hi, w, w_sh, ct: bool):
        """The cyclic stages [lo, hi): CT from the narrowest up (below 4q),
        or GS from the widest down ([0, 2q)); the stage on window bit t
        reads w[2^k + (vt mod 2^b) + (c mod 2^t) 2^b]."""
        vlo = vt & ((1 << b) - 1)

        def tw(k, cs, m):
            return (1 << k) + vlo[:, None] + ((cs & (m - 1)) << b)[None, :]
        return self._stages(V, b, lo, hi, w, w_sh, ct, ct, tw)

    def merged_stages(self, V, b, vt, lo, hi, w, w_sh, fwd: bool):
        """B1's and B4's merged-psi stages [lo, hi): the forward's CT
        butterflies from the widest down, or the inverse's GS butterflies
        from the narrowest up; the stage on window bit t reads
        w[2^(L-1-k) + (j >> (k+1))]."""
        L, r = self.L, self.r

        def tw(k, cs, m):
            t = k - b
            return ((1 << (L - 1 - k)) + ((vt >> b) << (r - 1 - t))[:, None]
                    + (cs >> (t + 1))[None, :])
        return self._stages(V, b, lo, hi, w, w_sh, fwd, not fwd, tw)

    def _stages(self, V, b, lo, hi, w, w_sh, ct, up, tw):
        q, q2, R = self.q, 2 * self.q, self.plan.radix
        for k in (range(lo, hi) if up else range(hi - 1, lo - 1, -1)):
            m = 1 << (k - b)
            assert 1 <= m < R
            cs = self.c[(self.c & m) == 0]
            j = tw(k, cs, m)
            U, D = V[..., cs], V[..., cs + m]
            if ct:
                assert bool((V < 4 * q).all())
                u = MM._csub(U, q2)
                h = MM.shoup_mulmod_lazy(D, w[j], w_sh[j], q)
                U, D = u + h, u + q2 - h
            else:
                assert bool((V < q2).all())
                U, D = (MM._csub(U + D, q2),
                        MM.shoup_mulmod_lazy(U + q2 - D, w[j], w_sh[j], q))
            V = V.clone()
            V[..., cs], V[..., cs + m] = U, D
        return V


# ----------------------------------------------------------------------
# Sweeps: rows past a cluster's reach, in device memory.
# ----------------------------------------------------------------------

# kind -> (forward scheme, inverse scheme, operands): "merged" (B1-B4's
# merged-psi CT forward, GS inverse with n^{-1} in its last stage), "dif",
# "dit", "stk" (Stockham: DIF butterflies, its autosort's positions in
# device memory); None: no such transform.  The order is the kernel's
# ``Kind`` (``csrc/pass_sweeps.cuh``).
SWEEP_KINDS = {
    "B1": ("merged", "merged", 2), "B4": ("merged", "merged", 1),
    "B2": ("merged", None, 1), "B3": (None, "merged", 1),
    "gs_ct": ("dif", "dit", 2), "ct_ct": ("dit", "dit", 2),
    "gs_gs": ("dif", "dif", 2), "ct_gs": ("dit", "dif", 2),
    "stockham": ("stk", "stk", 2)}
SWEEP_KIND_NAMES = tuple(SWEEP_KINDS)
MAX_SWEEP_LOGN = 25
MAX_WINDOWS = 3
MAX_SWEEPS = 2 * MAX_WINDOWS - 1
# values a block's tile holds, all its operands (128 KiB); an upper
# window's tile holds at most SWEEP_UPPER_WORDS (64 KiB, so that two blocks
# share an SM) unless that takes a window more
SWEEP_TILE_WORDS = 1 << 15
SWEEP_UPPER_WORDS = 1 << 14
# column bits a sweep gathers beside its window: runs of 32 bytes
SWEEP_COLS = 3
# window bits the kernel runs in registers between two barriers
SWEEP_PASS_BITS = 3
# threads a block, and a block whose tile holds at most SWEEP_UPPER_WORDS
_SWEEP_THREADS = 1024
_SWEEP_THREADS_HALF = 512
# entries a row of the in-window powers (``sweep_powers_of``)
SWEEP_POW_BITS = 14
# a stage whose twiddle depends on at most this many window bits above it
# (merged, reflected; not Stockham) takes it whole from the tile's table
SWEEP_EXACT_BITS = 8


class SweepPlan(ctypes.Structure):
    """The sweep kernels' plan; field for field the ``SweepPlan`` struct of
    ``csrc/pass_sweeps.cuh``.  A transform's n = 2^logn indices are parted
    into ``windows`` windows of index bits [win_lo[w], win_hi[w]), the
    narrowest first.  Launch i of a call (``sweeps`` of them) runs on the
    window [lo[i], hi[i]): the forward's stages there (``fwd``), the
    inverse's (``inv``) or both with the pointwise product between.  A block
    holds a tile of the 2^(hi - lo) indices that differ in the window, for
    the 2^cols values of the column bits [cb, cb + cols) (neighbours in
    device memory), ``ops`` operands of it, with ``split`` operand groups
    in blocks of their own; ``tiles`` blocks a row and group, ``threads``
    threads and ``smem`` bytes of shared memory a block.  Index i of a
    transform lies in device memory at its Stockham position of stage
    ``ld`` (the load) or ``st`` (the store), of the bit-reversed index
    where ``ld_refl`` / ``st_refl`` (``stockham_address``); all 0 but
    Stockham's.  ``vec``: how the launch loads and stores
    (``sweep_vec``)."""

    _fields_ = [(f, ctypes.c_int32) for f in (
        "kind", "logn", "sweeps", "windows")] + [
        (f, ctypes.c_int32 * MAX_WINDOWS) for f in ("win_lo", "win_hi")] + [
        (f, ctypes.c_int32 * MAX_SWEEPS) for f in (
            "lo", "hi", "fwd", "inv", "cb", "cols", "ops", "split", "ld",
            "ld_refl", "st", "st_refl", "tiles", "threads", "smem", "vec")]


def cluster_reach(kind: str) -> int:
    """The largest n the block and cluster forms of ``kind``'s pass kernel
    take: ``MAX_CLUSTER`` blocks of the most threads its block takes, 32
    values of each operand a thread."""
    fwd, inv, _ = SWEEP_KINDS[kind]
    one = fwd is None or inv is None
    return MAX_CLUSTER * (_MAX_THREADS_ONE if one else _MAX_THREADS)[4] * 32


def kernel_plan(n: int, kind: str):
    """The plan ``kind``'s kernel runs at row length ``n``: its block or
    cluster form's (``pass_plan``) up to ``cluster_reach(kind)``, its
    sweep form's (``sweep_plan``) past it; raises past n = 2^25."""
    if kind not in SWEEP_KINDS:
        raise ValueError(f"unknown kind {kind!r}; choose from "
                         f"{list(SWEEP_KINDS)}")
    if n > cluster_reach(kind) and not n & (n - 1):
        return sweep_plan(n, kind)
    fwd, inv, nops = SWEEP_KINDS[kind]
    if fwd == "merged" or inv == "merged":
        return pass_plan(n, None if fwd is None else False,
                         None if inv is None else True, operands=nops)
    return pass_plan(n, fwd == "dit", inv == "dit", kind == "stockham")


def address_bit(i: int, L: int, st: int, refl: bool) -> int:
    """The bit of a device-memory address that index bit i of a transform
    of 2^L lands on under ``stockham_address`` (st, refl)."""
    j = L - 1 - i if refl else i
    return j + st if j < L - st else L - 1 - j


def stockham_address(m, L: int, st: int, refl: bool):
    """The device-memory address of index m (int or int64 tensor): the
    Stockham position of stage st of j = m, or of j = brev_L(m) with
    ``refl``: ((j mod 2^(L-st)) << st) | brev_st(j >> (L - st)).  Stage 0
    of m is m itself, stage L of brev_L(m) too."""
    j = brev(m, L) if refl else m
    return ((j & ((1 << (L - st)) - 1)) << st) | brev(j >> (L - st), st)


def _sweep_maps(kind: str, L: int, lo: int, hi: int, fwd: bool, inv: bool):
    """(ld, ld_refl, st, st_refl) of a launch on the window [lo, hi):
    Stockham's positions of the stage where the load and store fall (the
    forward on [lo, hi) has run the stages above hi before it and ends at
    those above lo; the inverse's stage st' lies on index bit st' of the
    bit-reversed index); the identity for the other kinds."""
    if kind != "stockham":
        return 0, 0, 0, 0
    if fwd and inv:
        return L - hi, 0, hi, 1
    if fwd:
        return L - hi, 0, L - lo, 0
    return lo, 1, hi, 1


def _sweep_cols(L: int, lo: int, hi: int, ld: int, ld_refl: bool):
    """(cb, cols): the index bits beside the window whose load addresses
    are bits 0, 1, 2 of the address, while they are outside the window and
    side by side; (0, 0) when the window holds address bit 0."""
    bits = []
    for a in range(SWEEP_COLS):
        i = next(i for i in range(L) if address_bit(i, L, ld, ld_refl) == a)
        if lo <= i < hi or (bits and abs(i - bits[-1]) != 1):
            break
        bits.append(i)
    return (min(bits), len(bits)) if bits else (0, 0)


def _windows(L: int, s0_max: int, su_max: int, windows: int | None):
    """[lo, hi) of each window, the narrowest first: the fewest windows
    whose sizes the caps take (``windows`` given: that many), sizes as even
    as they go, the narrowest the largest."""
    m = max(1, -(-(L - s0_max) // su_max)) if windows is None else windows - 1
    if m < 1 or m + 1 > MAX_WINDOWS or m + 1 > L:
        raise ValueError(f"2^{L}: {m + 1} windows, the sweep form takes 2 "
                         f"to {MAX_WINDOWS}, each of at least one bit")
    s0 = min(s0_max, -(-L // (m + 1)))
    while -(-(L - s0) // m) > su_max and s0 < s0_max:
        s0 += 1
    q, rem = divmod(L - s0, m)
    sizes = [s0] + [q + 1] * rem + [q] * (m - rem)
    if max(sizes[1:]) > su_max or min(sizes) < 1:
        raise ValueError(f"2^{L}: no {m + 1} windows of at most {s0_max} "
                         f"and {su_max} bits")
    edges = [0]
    for s in sizes:
        edges.append(edges[-1] + s)
    return list(zip(edges, edges[1:]))


def _upper_windows(bits: int, su_max: int):
    """[lo, hi) of the fewest windows of at most su_max bits over [0,
    bits), sizes as even as they go, the lowest the largest."""
    m = -(-bits // su_max)
    q, rem = divmod(bits, m)
    edges = [0]
    for s in [q + 1] * rem + [q] * (m - rem):
        edges.append(edges[-1] + s)
    return list(zip(edges, edges[1:]))


@functools.lru_cache(maxsize=None)
def sweep_plan(n: int, kind: str, windows: int | None = None,
               low: int = 0) -> SweepPlan:
    """The sweep schedule of ``kind``'s kernel (a key of ``SWEEP_KINDS``)
    at row length ``n``: a row stays in device memory and a transform runs
    in one launch a window of index bits, each block on the sub-transforms
    of one tile.  Launches: the forward from the widest window down, the
    narrowest window once with the forward's stages, the pointwise product
    and the inverse's, then the inverse up; B2 and B3 one a window.  The
    launches on upper windows gather SWEEP_COLS column bits (32-byte runs)
    and carry one operand a block (B1's and the pairings' x and y in blocks
    of their own); the narrowest window is contiguous, but Stockham's
    positions there take columns too.  A tile holds at most
    SWEEP_TILE_WORDS values of all its operands, so the narrowest window
    takes up to 14 bits (15 with one operand; Stockham 11); an upper one
    11 (SWEEP_UPPER_WORDS: two blocks an SM), or 12 where 11 would take a
    window more: two windows up to 2^26, Stockham three from 2^24.
    ``windows`` forces that many (a test of the three-window form at small
    n).  ``low`` > 0 (B2 and B3 alone) leaves the index bits below it to
    another kernel: the windows cover [low, L), each as an upper one (11
    or 12 bits beside its columns, as above), one or more of them; B2's stages
    from bit L - 1 down to bit low and B3's from bit low up (the MXU split
    form's wide stages, ``ntt_mxu_split``).  Raises past n = 2^25, the
    largest ring the registry takes.  Cached: copy it before changing a
    field."""
    if kind not in SWEEP_KINDS:
        raise ValueError(f"unknown kind {kind!r}; choose from "
                         f"{list(SWEEP_KINDS)}")
    if n < 4 or n & (n - 1):
        raise ValueError(f"n={n}: not a power of two from 4")
    L = _log2(n)
    if L > MAX_SWEEP_LOGN:
        raise ValueError(f"n={n}: the sweep form takes n <= 2^"
                         f"{MAX_SWEEP_LOGN} = {1 << MAX_SWEEP_LOGN}, the "
                         f"largest ring the registry takes")
    fwd_s, inv_s, nops = SWEEP_KINDS[kind]
    both = fwd_s is not None and inv_s is not None
    tile_bits = _log2(SWEEP_TILE_WORDS)
    stk_cols = SWEEP_COLS if kind == "stockham" else 0
    s0_max = tile_bits - _log2(nops) - stk_cols
    if low and (kind not in ("B2", "B3") or not 0 < low < L or windows):
        raise ValueError(f"{kind} at 2^{L}: the windows start at bit 0 "
                         f"(bits below {low} are left to another kernel "
                         f"for B2 and B3 alone, 0 < low < L)")

    def cover(su_max):
        if low:
            return [(lo + low, hi + low)
                    for lo, hi in _upper_windows(L - low, su_max)]
        return _windows(L, s0_max, su_max, windows)

    # upper windows in tiles of SWEEP_UPPER_WORDS, unless that takes one
    # window more than tiles of SWEEP_TILE_WORDS
    win = cover(tile_bits - SWEEP_COLS)
    try:
        half = cover(_log2(SWEEP_UPPER_WORDS) - SWEEP_COLS)
    except ValueError:
        half = None
    if half is not None and len(half) == len(win):
        win = half
    W = len(win)
    if both:
        runs = ([(w, True, False) for w in range(W - 1, 0, -1)]
                + [(0, True, True)]
                + [(w, False, True) for w in range(1, W)])
    elif inv_s is None:
        runs = [(w, True, False) for w in range(W - 1, -1, -1)]
    else:
        runs = [(w, False, True) for w in range(W)]
    f = {k: [] for k, _ in SweepPlan._fields_[6:]}
    for w, fw, iv in runs:
        lo, hi = win[w]
        ld, ld_refl, st, st_refl = _sweep_maps(kind, L, lo, hi, fw, iv)
        cb, c = _sweep_cols(L, lo, hi, ld, ld_refl)
        S = hi - lo + c
        join = nops << S <= SWEEP_UPPER_WORDS
        ops = nops if fw and (iv or join) else 1
        split = nops if fw and not iv and not join else 1
        if ops << S > SWEEP_TILE_WORDS:
            raise ValueError(f"n={n}: a tile of {ops} x 2^{S} values")
        for k, v in (("lo", lo), ("hi", hi), ("fwd", fw), ("inv", iv),
                     ("cb", cb), ("cols", c), ("ops", ops), ("split", split),
                     ("ld", ld), ("ld_refl", ld_refl), ("st", st),
                     ("st_refl", st_refl), ("tiles", 1 << (L - S)),
                     ("threads", sweep_threads(S, ops)),
                     ("smem", sweep_smem(hi - lo, c, ops)),
                     ("vec", sweep_vec(kind, lo, hi, cb, c))):
            f[k].append(int(v))
    plan = SweepPlan(kind=SWEEP_KIND_NAMES.index(kind), logn=L,
                     sweeps=len(runs), windows=W)
    for w, (lo, hi) in enumerate(win):
        plan.win_lo[w], plan.win_hi[w] = lo, hi
    for k, vals in f.items():
        for i, v in enumerate(vals):
            getattr(plan, k)[i] = v
    return plan


def sweep_threads(S: int, ops: int = 1) -> int:
    """Threads a block of a tile of 2^S values of each of ``ops``
    operands: one a group of 2^SWEEP_PASS_BITS values (the kernel's
    register pass), from 32 to 1024, and to 512 where the tile holds at
    most SWEEP_UPPER_WORDS values (two such blocks share an SM's 64K
    registers)."""
    most = (_SWEEP_THREADS if ops << S > SWEEP_UPPER_WORDS
            else _SWEEP_THREADS_HALF)
    return min(most, max(32, 1 << max(S - SWEEP_PASS_BITS, 0)))


def sweep_stride(S: int, c: int) -> int:
    """Words of shared memory an operand of a tile of 2^S values: value u
    = v | col << s at u + u / 32 + col, so that 32 neighbouring values, or
    the 2^c columns of one v, lie in 32 banks."""
    return (1 << S) + (1 << S >> 5) + (1 << c)


def sweep_smem(s: int, c: int, ops: int) -> int:
    """Bytes of shared memory a block of a window of s bits beside c
    columns: ``ops`` operands of its tile, then the tile's twiddle bases,
    a (w, w_shoup) pair a window bit and column for each transform, then
    each transform's whole twiddles of its top stages (SWEEP_EXACT_BITS)."""
    return 4 * (ops * sweep_stride(s + c, c) + 4 * (s << c)
                + 4 * ((2 << SWEEP_EXACT_BITS) - 1))


def sweep_vec(kind: str, lo: int, hi: int, cb: int, c: int) -> int:
    """How a launch loads and stores a tile: 2 where an upper window's
    value holds its SWEEP_COLS columns as 32 neighbouring bytes (two
    16-byte accesses a thread and operand), 1 where the window is the
    row's lowest bits (four neighbouring values a thread, 16 bytes), 0 a
    value at a time through ``stockham_address`` (Stockham)."""
    if kind == "stockham":
        return 0
    if c == SWEEP_COLS and cb == 0:
        return 2
    return int(lo == 0 and c == 0 and hi - lo >= 2)


def describe_sweep_plan(plan: SweepPlan) -> str:
    """One line: the windows, then each launch's window, transforms,
    columns, operands and blocks a row."""
    wins = " ".join(f"[{plan.win_lo[w]},{plan.win_hi[w]})"
                    for w in range(plan.windows))
    runs = []
    for i in range(plan.sweeps):
        what = "+".join(s for s, on in (("fwd", plan.fwd[i]),
                                         ("inv", plan.inv[i])) if on)
        runs.append(f"[{plan.lo[i]},{plan.hi[i]}) {what} cols "
                    f"[{plan.cb[i]},{plan.cb[i] + plan.cols[i]}) "
                    f"{plan.ops[i]}x{plan.split[i]} op, "
                    f"{plan.tiles[i] * plan.split[i]} blocks of "
                    f"{plan.threads[i]}")
    return (f"{SWEEP_KIND_NAMES[plan.kind]} n=2^{plan.logn}: {plan.sweeps} "
            f"launches a call, windows {wins}; " + "; ".join(runs))


def sweep_launch_bytes(plan: SweepPlan, i: int, batch: int) -> int:
    """The bytes launch i of a call must move at ``batch`` rows: each
    operand row it carries read once and each row it hands on written once
    (a forward alone hands every operand on, the others one row), and the
    tables it reads: a pairing's psi rows (w, w_shoup) at its first launch
    and phi^{-1} n^{-1} rows at its last, B4's spectrum with the product,
    the in-window powers (``sweep_powers_of``) at the first.  Summed over
    a call's launches: the kind's sweep floor."""
    n = 1 << plan.logn
    kind = SWEEP_KIND_NAMES[plan.kind]
    pairing = not kind.startswith("B")
    carried = plan.ops[i] * plan.split[i]
    out = carried if plan.fwd[i] and not plan.inv[i] else 1
    words = batch * n * (carried + out)
    if i == 0:
        words += 4 * min(n, 1 << SWEEP_POW_BITS) + (2 * n if pairing else 0)
    if i == plan.sweeps - 1 and pairing:
        words += 2 * n
    if kind == "B4" and plan.fwd[i] and plan.inv[i]:
        words += n
    return 4 * words


def sweep_reads(plan: SweepPlan, i: int, last: str = "z") -> tuple[str, str]:
    """(source, destination) buffer of launch i: "in" (the operands), "a"
    and "b" (scratch rows of ``ops`` operands) in turns, ``last`` for the
    call's last launch."""
    src = "in" if i == 0 else "ab"[(i - 1) % 2]
    return src, last if i == plan.sweeps - 1 else "ab"[i % 2]


def sweep_powers_of(tw: torch.Tensor, q: int, merged: bool) -> torch.Tensor:
    """The sweep kernels' in-window powers of their table ``tw`` (rows w,
    w_shoup of the forward, then of the inverse): its first min(n,
    2^SWEEP_POW_BITS) entries of rows 0-3, the stage on window bit t
    reading entry v >> (t + 1) (merged psi: psi^brev(x) at x), 2^t + (v mod
    2^t) (cyclic) or 2^(s-1-t) + brev(v >> (t + 1)) (reflected), with the
    merged inverse's entries 0 and 1 freed of the n^{-1} folded there: 1
    and entry 1 over entry 0; int64, on tw's device."""
    P = tw[:4, :min(tw.shape[1], 1 << SWEEP_POW_BITS)].to(torch.int64)
    P = P.clone()
    if merged:
        ninv, w1 = int(tw[2, 0]), int(tw[2, 1])
        w1 = w1 * pow(ninv, -1, q) % q
        P[2, 0], P[3, 0] = 1, (1 << 32) // q
        if P.shape[1] > 1:
            P[2, 1], P[3, 1] = w1, (w1 << 32) // q
    return P


class SweepModel:
    """A sweep kernel's launches on the CPU: device memory as int64
    buffers of (rows, operands, n) uint32 values (``sweep_reads``), each
    launch's tiles gathered from their addresses and scattered back, the
    stages with the kernel's factored twiddles (``stage_twiddles``: a base
    of the tile's fixed bits from ``tw``, an in-window power from
    ``sweep_powers_of``, a Shoup product by each; the stages the kernel
    takes whole twiddles for, ``SWEEP_EXACT_BITS``, one Shoup product by the
    table's entry) and lazy ranges
    (asserted), on the device of ``tw``: the kernel's table, the (4, n)
    merged-psi rows or the (8, n) pairing rows, in int64; ``spec`` B4's
    spectrum (n values)."""

    def __init__(self, plan: SweepPlan, n: int, q: int, tw: torch.Tensor,
                 barrett, spec: torch.Tensor | None = None):
        self.plan, self.n, self.q, self.L = plan, n, q, _log2(n)
        assert plan.logn == self.L
        self.kind = SWEEP_KIND_NAMES[plan.kind]
        self.fwd_s, self.inv_s, self.nops = SWEEP_KINDS[self.kind]
        self.tw, self.barrett, self.spec = tw, barrett, spec
        self.pw = sweep_powers_of(tw, q, "merged" in (self.fwd_s,
                                                      self.inv_s))

    def tile_indices(self, i: int) -> torch.Tensor:
        """(tiles, 2^S) indices of each tile of launch i: value u = v | col
        << s holds index rest | v << lo | col << cb, the tile number's bits
        spread over the bits outside the window and the columns."""
        p, L = self.plan, self.L
        lo, hi, cb, c = p.lo[i], p.hi[i], p.cb[i], p.cols[i]
        s = hi - lo
        free = [b for b in range(L) if not (lo <= b < hi or cb <= b < cb + c)]
        dev = self.tw.device
        tile = torch.arange(p.tiles[i], device=dev)
        rest = torch.zeros_like(tile)
        for k, b in enumerate(free):
            rest |= ((tile >> k) & 1) << b
        u = torch.arange(1 << (s + c), device=dev)
        v, col = u & ((1 << s) - 1), u >> s
        return rest[:, None] | (v << lo)[None] | (col << cb)[None]

    def run(self, inputs: list, trace: list | None = None) -> torch.Tensor:
        """The call on (B, n) int64 operands: every launch in order, each
        reading what the one before wrote; the (B, n) output.  With
        ``trace`` a list, each launch appends (its number, the buffer it
        wrote, a copy of that buffer)."""
        p, n, L = self.plan, self.n, self.L
        B, dev = inputs[0].shape[0], self.tw.device
        mem = {"in": torch.stack(inputs, 1)}
        for k, ops in (("a", self.nops), ("b", self.nops), ("z", 1)):
            mem[k] = torch.zeros((B, ops, n), dtype=torch.int64, device=dev)
        last_st = (0, 0)
        for i in range(p.sweeps):
            src, dst = sweep_reads(p, i)
            assert src != dst
            m = self.tile_indices(i)
            assert m.unique().numel() == n
            ld = stockham_address(m, L, p.ld[i], p.ld_refl[i])
            st = stockham_address(m, L, p.st[i], p.st_refl[i])
            # a launch reads where the one before wrote
            assert (p.ld[i], p.ld_refl[i]) == last_st or i == 0
            assert i > 0 or bool((ld == m).all())
            assert i < p.sweeps - 1 or bool((st == m).all())
            last_st = (p.st[i], p.st_refl[i])
            carried = p.ops[i] * p.split[i]
            V = mem[src][:, :carried][:, :, ld]
            V = self._launch(i, V, m)
            mem[dst][:, :V.shape[1]][:, :, st] = V
            if trace is not None:
                trace.append((i, dst, mem[dst].clone()))
        return mem["z"][:, 0]

    def _launch(self, i, V, m):
        """Launch i on the tiles' values V (rows, operands, tiles, 2^S)."""
        p, q, L, tw = self.plan, self.q, self.L, self.tw
        pairing = self.fwd_s not in ("merged", None) or self.inv_s not in (
            "merged", None)
        first, last = i == 0, i == p.sweeps - 1
        s = p.hi[i] - p.lo[i]
        if first and pairing:
            V = MM.shoup_mulmod_lazy(V, tw[4][m], tw[5][m], q)
        if p.fwd[i]:
            for t in range(s - 1, -1, -1):
                V = self._stage(V, m, i, t, True)
        if p.fwd[i] and p.inv[i]:
            other = V[:, 1] if self.nops == 2 else self.spec[m][None]
            V = self.barrett(V[:, :1], other[:, None])
        if p.inv[i]:
            for t in range(s):
                V = self._stage(V, m, i, t, False)
        if last and pairing:
            V = MM._csub(MM.shoup_mulmod_lazy(V, tw[6][m], tw[7][m], q), q)
        elif last and self.inv_s is None:
            V = MM._csub(MM._csub(V, 2 * q), q)
        if last:
            assert bool((V < q).all())
        return V

    def stage_twiddles(self, m, i: int, t: int, fwd: bool):
        """For the low members m (indices, any shape) of the butterflies of
        the forward's (``fwd``) or the inverse's stage on window bit t of
        launch i: (k, idx, p, b), the stage's bit of the transform's index
        (of the bit-reversed one where the transform runs reflected: a DIT
        forward, a DIF or Stockham inverse), the gathered table entry the
        pass kernels read (merged-psi w[2^(L-1-k) + (j >> (k+1))], cyclic
        w[2^k + (j mod 2^k)]), the in-window power's entry of ``pw`` and the
        base's entry of ``tw``, the index with the window's bits 0 (the
        kernel's ``pow_index`` and ``base_index``)."""
        L, p = self.L, self.plan
        lo, s = p.lo[i], p.hi[i] - p.lo[i]
        scheme = self.fwd_s if fwd else self.inv_s
        refl = scheme == "dit" if fwd else scheme in ("dif", "stk")
        km = lo + t
        k = L - 1 - km if refl else km
        v = (m >> lo) & ((1 << s) - 1)
        jf = m & ~(((1 << s) - 1) << lo)
        if refl:
            j, jfr = brev(m, L), brev(jf, L)
        else:
            j, jfr = m, jf
        assert bool(((j >> k) & 1 == 0).all())
        if scheme == "merged":
            idx = (1 << (L - 1 - k)) + (j >> (k + 1))
            pi = v >> (t + 1)
            bi = (1 << (L - 1 - k)) + (jf >> (k + 1))
        elif refl:
            idx = (1 << k) + (j & ((1 << k) - 1))
            pi = (1 << (s - 1 - t)) + brev(v >> (t + 1), s - 1 - t)
            bi = (1 << k) + (jfr & ((1 << k) - 1))
        else:
            idx = (1 << k) + (j & ((1 << k) - 1))
            pi = (1 << t) + (v & ((1 << t) - 1))
            bi = (1 << k) + (jf & ((1 << k) - 1))
        return k, idx, pi, bi

    def _stage(self, V, m, i, t, fwd: bool):
        """The forward's (``fwd``) or the inverse's stage on index bit lo +
        t of launch i (``stage_twiddles``); CT butterflies for "dit" and the
        merged forward, GS for the others, the difference multiplied by the
        in-window power, then by the base (Shoup each), or, on a merged or
        reflected stage within SWEEP_EXACT_BITS of the window's top (not
        Stockham), by the whole twiddle (the kernel's tile table); the merged
        inverse's stage k = L - 1 takes n^{-1} on the sum (entry 0) and
        entry 1 on the difference, canonical."""
        q, q2, L, tw = self.q, 2 * self.q, self.L, self.tw
        scheme = self.fwd_s if fwd else self.inv_s
        w, w_sh = (tw[0], tw[1]) if fwd else (tw[2], tw[3])
        pw, pw_sh = (self.pw[0], self.pw[1]) if fwd else (self.pw[2],
                                                          self.pw[3])
        u = torch.arange(V.shape[-1], device=V.device)
        ul = u[(u >> t) & 1 == 0]
        uu = ul | (1 << t)
        k, idx, pi, bi = self.stage_twiddles(m[:, ul], i, t, fwd)
        s = self.plan.hi[i] - self.plan.lo[i]
        refl = scheme == "dit" if fwd else scheme in ("dif", "stk")
        exact = (self.kind != "stockham" and (scheme == "merged" or refl)
                 and s - 1 - t <= SWEEP_EXACT_BITS)

        def mul(x):
            if exact:
                return MM.shoup_mulmod_lazy(x, w[idx], w_sh[idx], q)
            x = MM.shoup_mulmod_lazy(x, pw[pi], pw_sh[pi], q)
            return MM.shoup_mulmod_lazy(x, w[bi], w_sh[bi], q)

        a, d = V[..., ul], V[..., uu]
        V = V.clone()
        if scheme == "merged" and not fwd and k == L - 1:
            assert bool((V < q2).all())
            V[..., ul] = MM._csub(MM.shoup_mulmod_lazy(a + d, w[0], w_sh[0],
                                                       q), q)
            V[..., uu] = MM._csub(MM.shoup_mulmod_lazy(a + q2 - d, w[1],
                                                       w_sh[1], q), q)
        elif scheme == "dit" or (scheme == "merged" and fwd):
            assert bool((V < 4 * q).all())
            u2 = MM._csub(a, q2)
            h = mul(d)
            V[..., ul], V[..., uu] = u2 + h, u2 + q2 - h
        else:
            assert bool((V < q2).all())
            V[..., ul] = MM._csub(a + d, q2)
            V[..., uu] = mul(a + q2 - d)
        return V
