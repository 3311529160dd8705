"""The sweep form of the pass kernels, on the CPU: rows past a thread-block
cluster's reach (B1, B4 and the five B10 pairings from n = 2^18, B2 and B3
from 2^19, to 2^25), a row in device memory and each transform in
block-local sweeps (``csrc/pass_sweeps.cu``).

- The sweep plans (``passes.sweep_plan``) of all nine kinds at every n from
  2^18 to 2^25 against the launcher's checks (``plan_ok``, restated): two
  or three windows covering the index bits from the narrowest, each
  launch's window, transforms, Stockham maps, columns, operands, tiles,
  threads and shared memory; every stage of each transform runs once, in
  order (a forward from index bit L - 1 down, an inverse from bit 0 up),
  the product once between; each launch reads where the one before wrote.
  ``kernel_plan`` takes the sweep form exactly past the cluster form's
  reach; n = 2^26 is refused, naming 2^25.
- The sweep twins (``passes.SweepModel``: device memory as buffers, each
  launch's tiles gathered from their addresses, the kernel's twiddle
  indices and lazy ranges asserted) of all nine kinds at n = 4 to 4096
  with two and three windows, against the plain versions; Stockham's
  scratch rows hold its autosort's positions (the plain Stockham stages).
- B2's twin at 2^18 against JAX's ``ntt_fused_fn(interpret=True)``; B1's at
  2^18, q = 1056440321, against the closed form of the all-(q - 1) row,
  z_k = 2k + 2 - n mod q, and 8 coefficients from the definition.
- ``slow``: B1, B4, B2 then B3, and the five pairings against JAX's
  interpret-mode kernels at 2^18 and 2^19; B1 at 2^20.

Tolerance: none (integer equality).  Inputs are made with numpy from a
seed; the sets are registered in both packages' registries for the module
and removed after it."""

import numpy as np
import pytest
import torch

from qtesla_tpu import params as JPARAMS
from qtesla_tpu.ops import ntt_pallas as JK
from qtesla_tpu.ops.ntt_pairings_pallas import polymul_pairing_fn
from qtesla_tpu_torch import params as TPARAMS
from qtesla_tpu_torch.ops import ntt as TN
from qtesla_tpu_torch.ops import ntt_fused as F
from qtesla_tpu_torch.ops import ntt_pairings as P
from qtesla_tpu_torch.ops import passes as Ps
from qtesla_tpu_torch.ops.tables import get_tables

KINDS = list(Ps.SWEEP_KINDS)
# the largest prime the registry takes at each n of the tests
LARGE = {1 << 18: 1056440321, 1 << 19: 1053818881, 1 << 20: 1012924417}
# small rings of the twins' sweep: (n, q), q prime and 1 mod 2n
SMALL = [(4, 17), (8, 17), (16, 97), (32, 193), (64, 257), (128, 257),
         (256, 7681), (512, 12289), (1024, 1073479681), (4096, 40961)]


def _name(n, q):
    return f"sweep-n{n}-q{q}"


@pytest.fixture(scope="module", autouse=True)
def registered():
    """The sets of this module in both registries."""
    entries = [(_name(n, q), n, q) for n, q in [*LARGE.items(), *SMALL]]
    for reg in (JPARAMS, TPARAMS):
        for entry in entries:
            reg.register_param_set(*entry)
    yield
    for reg in (JPARAMS, TPARAMS):
        for name, _, _ in entries:
            del reg.PARAM_SETS[name]
        reg.get_params.cache_clear()


# ----------------------------------------------------------------------
# The plans against the launcher's checks.
# ----------------------------------------------------------------------

def _launcher_accepts(plan, L):
    """``plan_ok`` of ``csrc/pass_sweeps.cu``, restated: the launches the
    kind's order gives its windows, each with the fields its rules give."""
    kind = Ps.SWEEP_KIND_NAMES[plan.kind]
    fwd, inv, nops = Ps.SWEEP_KINDS[kind]
    W = plan.windows
    if (plan.logn != L or not 2 <= W <= 3 or plan.win_lo[0] != 0
            or plan.win_hi[W - 1] != L):
        return False
    for w in range(W):
        if plan.win_hi[w] <= plan.win_lo[w] or (
                w and plan.win_lo[w] != plan.win_hi[w - 1]):
            return False
    both = fwd is not None and inv is not None
    if plan.sweeps != (2 * W - 1 if both else W):
        return False
    for i in range(plan.sweeps):
        if both:
            w = W - 1 - i if i < W - 1 else i - (W - 1)
            fw, iv = i <= W - 1, i >= W - 1
        elif inv is None:
            w, fw, iv = W - 1 - i, True, False
        else:
            w, fw, iv = i, False, True
        lo, hi = plan.win_lo[w], plan.win_hi[w]
        maps = (0, 0, 0, 0)
        if kind == "stockham":
            maps = ((L - hi, 0, hi, 1) if fw and iv else
                    (L - hi, 0, L - lo, 0) if fw else (lo, 1, hi, 1))
        bits = []
        for a in range(3):
            b = [i2 for i2 in range(L)
                 if Ps.address_bit(i2, L, maps[0], maps[1]) == a][0]
            if lo <= b < hi or (bits and abs(b - bits[-1]) != 1):
                break
            bits.append(b)
        cb, c = (min(bits), len(bits)) if bits else (0, 0)
        S = hi - lo + c
        join = nops << S <= 1 << 14
        ops = nops if fw and (iv or join) else 1
        split = nops if fw and not iv and not join else 1
        stride = (1 << S) + (1 << S >> 5) + (1 << c)
        most = 1024 if ops << S > 1 << 14 else 512
        vec = (0 if kind == "stockham" else 2 if c == 3
               else int(lo == 0 and c == 0 and hi - lo >= 2))
        want = dict(lo=lo, hi=hi, fwd=fw, inv=iv, cb=cb, cols=c, ops=ops,
                    split=split, ld=maps[0], ld_refl=maps[1], st=maps[2],
                    st_refl=maps[3], tiles=1 << (L - S),
                    threads=min(most, max(32, 1 << max(S - 3, 0))),
                    smem=4 * (ops * stride + 4 * ((hi - lo) << c) + 4 * 511),
                    vec=vec)
        if (S > 15 or ops << S > 1 << 15 or want["smem"] > 232448
                or any(getattr(plan, f)[i] != v for f, v in want.items())):
            return False
    return True


def _stages(plan):
    """Index bits of each transform's stages in the order the launches run
    them, the launches that take the product, and each launch's window and
    columns as sets of bits."""
    fwd, inv, prod = [], [], []
    for i in range(plan.sweeps):
        lo, hi = plan.lo[i], plan.hi[i]
        if plan.fwd[i]:
            fwd += list(range(hi - 1, lo - 1, -1))
        if plan.fwd[i] and plan.inv[i]:
            prod.append(i)
        if plan.inv[i]:
            inv += list(range(lo, hi))
    return fwd, inv, prod


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_plans_meet_the_launchers_checks(kind):
    """At every n from 2^18 to 2^25 the plan meets the launcher's checks;
    each transform's stages run once, in order, the product once between
    them; a launch's columns lie outside its window; a launch reads at the
    positions the one before stored at, the first from the operands and
    the last into z in natural order; ``kernel_plan`` takes the sweep form
    exactly past ``cluster_reach``."""
    fwd_s, inv_s, _ = Ps.SWEEP_KINDS[kind]
    reach = Ps.cluster_reach(kind)
    assert reach == (262144 if fwd_s is None or inv_s is None else 131072)
    for L in range(18, 26):
        n = 1 << L
        plan = Ps.sweep_plan(n, kind)
        assert _launcher_accepts(plan, L), (kind, L)
        fwd, inv, prod = _stages(plan)
        assert fwd == (list(range(L - 1, -1, -1)) if fwd_s else [])
        assert inv == (list(range(L)) if inv_s else [])
        assert len(prod) == (1 if fwd_s and inv_s else 0)
        for i in range(plan.sweeps):
            win = set(range(plan.lo[i], plan.hi[i]))
            cols = set(range(plan.cb[i], plan.cb[i] + plan.cols[i]))
            assert not win & cols and max(cols | win) < L
            assert plan.tiles[i] << (len(win) + len(cols)) == n
            src, dst = Ps.sweep_reads(plan, i)
            assert src != dst and (src == "in") == (i == 0)
            if i:
                assert (plan.ld[i], plan.ld_refl[i]) == (
                    plan.st[i - 1], plan.st_refl[i - 1])
        assert Ps.stockham_address(12345 % n, L, plan.ld[0],
                                   plan.ld_refl[0]) == 12345 % n
        last = plan.sweeps - 1
        assert Ps.stockham_address(777, L, plan.st[last],
                                   plan.st_refl[last]) == 777
        assert (plan.sweeps == 5) == (kind == "stockham" and L >= 24)
        got = Ps.kernel_plan(n, kind)
        assert isinstance(got, Ps.SweepPlan) == (n > reach)
        assert f"{plan.sweeps} launches a call" in Ps.describe_sweep_plan(
            plan)


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_plans_refuse_past_2pow25(kind):
    """n = 2^26, the first length the registry takes no prime for, is
    refused by the sweep planner and by ``kernel_plan``, naming 2^25; a
    plan the launcher's checks would refuse (a window moved, a column
    changed, one launch too few) is told apart from the planner's."""
    for fn in (Ps.sweep_plan, Ps.kernel_plan):
        with pytest.raises(ValueError, match=r"n <= 2\^25 = 33554432"):
            fn(1 << 26, kind)
    plan = Ps.sweep_plan(1 << 20, kind)
    for field, i, delta in (("hi", 0, -1), ("cb", 0, 1), ("cols", 0, 1),
                            ("tiles", 1, 1), ("smem", 0, 4)):
        bad = Ps.SweepPlan.from_buffer_copy(plan)
        getattr(bad, field)[i] += delta
        assert not _launcher_accepts(bad, 20), (kind, field)
    bad = Ps.SweepPlan.from_buffer_copy(plan)
    bad.sweeps -= 1
    assert not _launcher_accepts(bad, 20)


# ----------------------------------------------------------------------
# The twins.
# ----------------------------------------------------------------------

def _operands(n, q, rows=3, seed=0):
    rng = np.random.default_rng(seed + n)
    x, y = (torch.from_numpy(rng.integers(0, q, (rows, n), dtype=np.uint32))
            for _ in range(2))
    x[0], y[0] = q - 1, q - 1
    lazy = torch.from_numpy(rng.integers(0, 2 * q, (rows, n),
                                         dtype=np.uint32))
    lazy[0] = 2 * q - 1
    return x, y, lazy


def _twin(kind, tbl, x, y, lazy, spec, plan):
    """(the sweep twin's output, its plain version's) for ``kind``."""
    if kind == "B1":
        return (F.polymul_fused_passes_plain(x, y, tbl, plan),
                F.polymul_plain(x, y, tbl))
    if kind == "B4":
        return (F.polymul_fixed_fused_passes_plain(x, spec, tbl, plan),
                F.polymul_fixed_plain(x, spec, tbl))
    if kind == "B2":
        return F.ntt_passes_plain(x, tbl, plan), F.ntt_plain(x, tbl)
    if kind == "B3":
        return F.intt_passes_plain(lazy, tbl, plan), F.intt_plain(lazy, tbl)
    return (P.polymul_pairing_passes_plain(x, y, tbl, kind, plan),
            P.polymul_pairing_plain(x, y, tbl, kind))


@pytest.mark.parametrize("n,q", SMALL)
def test_sweep_twins_match_plain_at_small_n(n, q):
    """Each kind's sweep twin under its two-window plan and a forced
    three-window plan (from n = 8) equals the plain version on 3 rows, one
    all q - 1 (B3: 2q - 1; B4 against a spectrum holding q - 1)."""
    tbl = get_tables(_name(n, q))
    x, y, lazy = _operands(n, q)
    spec = F.ntt_plain(y[1], tbl)
    spec[::5] = q - 1
    for windows in ((None, 3) if n >= 8 else (None,)):
        for kind in KINDS:
            plan = Ps.sweep_plan(n, kind, windows)
            got, want = _twin(kind, tbl, x, y, lazy, spec, plan)
            assert torch.equal(got, want), (kind, n, windows)


def _models(kind, n, q, windows):
    """The sweep model of ``kind`` at (n, q) under its plan with
    ``windows`` windows (None: the planner's), on the kernel's table."""
    tbl = get_tables(_name(n, q))
    pairing = not kind.startswith("B")
    tw = torch.from_numpy((tbl.pairing_packed if pairing else tbl.packed)
                          .astype(np.int64))
    plan = Ps.sweep_plan(n, kind, windows)
    return Ps.SweepModel(plan, n, q, tw, lambda a, b: F._barrett(a, b, tbl))


def _mul_pair(p, p_sh, b, b_sh, q):
    """``mul_pair`` of ``csrc/pass_sweeps.cu`` in uint32 arithmetic on int64
    tensors: w = p b mod q (a Shoup product, canonical) and its companion b
    p_sh + floor(b r / q) mod 2^32, r = -p_sh q mod 2^32, the floor a Shoup
    estimate and one correction."""
    mask = (1 << 32) - 1
    w = (p * b - ((p * b_sh) >> 32) * q) % (1 << 32)
    w = torch.where(w >= q, w - q, w)
    r = (-(p_sh * q)) & mask
    t = (r * b_sh) >> 32
    t = t + (((b * r - t * q) & mask) >= q).to(torch.int64)
    return w, (b * p_sh + t) & mask


def _check_factored(mdl):
    """Every stage of every launch of ``mdl``: the in-window power times
    the base, mod q, is the table entry the pass kernels gather, for every
    butterfly of every tile; each factor's Shoup companion is floor(w 2^32
    / q), and the kernel's whole twiddle and companion formed from the two
    pairs (``_mul_pair``) are the entry's.  The merged inverse's stage on
    bit L - 1 (n^{-1} folded) reads entries 0 and 1 as they are."""
    p, q, L = mdl.plan, mdl.q, mdl.L
    stages = 0
    for i in range(p.sweeps):
        m = mdl.tile_indices(i)
        s = p.hi[i] - p.lo[i]
        for fwd in (True, False):
            if not (p.fwd[i] if fwd else p.inv[i]):
                continue
            row = 0 if fwd else 2
            w, w_sh = mdl.tw[row], mdl.tw[row + 1]
            pw, pw_sh = mdl.pw[row], mdl.pw[row + 1]
            for t in range(s):
                low = m[:, (torch.arange(m.shape[1]) >> t) & 1 == 0]
                k, idx, pi, bi = mdl.stage_twiddles(low, i, t, fwd)
                if mdl.inv_s == "merged" and not fwd and k == L - 1:
                    continue
                assert torch.equal(pw[pi] * w[bi] % q, w[idx]), (i, t, fwd)
                assert torch.equal(pw_sh[pi], (pw[pi] << 32) // q)
                assert torch.equal(w_sh[bi], (w[bi] << 32) // q)
                assert bool((pi < pw.shape[0]).all())
                # the kernel's whole twiddles (mul_pair): the product and
                # its companion from the two Shoup pairs
                got, got_sh = _mul_pair(pw[pi], pw_sh[pi], w[bi], w_sh[bi], q)
                assert torch.equal(got, w[idx]) and torch.equal(got_sh,
                                                                w_sh[idx])
                stages += 1
    return stages


@pytest.mark.parametrize("kind", KINDS)
def test_factored_twiddles_equal_the_gathered_entries(kind):
    """The sweep kernel's twiddles are a base (the tile's fixed bits and
    column) times an in-window power (``sweep_powers_of``), for every kind
    and every stage, reflected ones and Stockham's included: at n = 4096
    under its two-window plan and a forced three-window one, at n = 256
    under three windows, and at n = 64 on the SP ring's table (the n1 =
    16 point table at the rows' heads, B2 and B3 from bit 3 up; the merged
    inverse's entries 0 and 1 freed of n1^{-1})."""
    fwd, inv, _ = Ps.SWEEP_KINDS[kind]
    for n, q, windows in ((4096, 40961, None), (4096, 40961, 3),
                          (256, 7681, 3)):
        L = n.bit_length() - 1
        assert _check_factored(_models(kind, n, q, windows)) == (
            (L if fwd else 0) + (L - (inv == "merged") if inv else 0))
    if kind in ("B2", "B3"):
        n, n1, q = 64, 16, 257
        ring = np.zeros((4, n), dtype=np.int64)
        TPARAMS.register_param_set("sweep-head-n16", n1, q)
        try:
            t1 = get_tables("sweep-head-n16")
            ring[:, :n1] = t1.packed
        finally:
            del TPARAMS.PARAM_SETS["sweep-head-n16"]
            TPARAMS.get_params.cache_clear()
        plan = Ps.sweep_plan(n, kind, low=3)
        mdl = Ps.SweepModel(plan, n, q, torch.from_numpy(ring), None)
        assert _check_factored(mdl) == n.bit_length() - 1 - 3 - (
            kind == "B3")


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_tiles_and_loads(kind):
    """The plan's tiles at every n from 2^18 to 2^25: an upper window's
    tile holds at most 2^14 values an operand unless 2^14 would take a
    window more, with 512 threads (two blocks an SM in registers and shared
    memory) where it holds at most 2^14 in all; an upper forward carries
    both operands of B1 and the pairings where they fit 2^14 values (two
    blocks an SM still), else one a block; the narrowest at most 2^15
    values of all its operands; the
    load shape is
    2 for an upper window's 8 columns of 32 bytes (rest a multiple of 8
    words), 1 for the contiguous narrowest window, 0 for Stockham alone;
    the in-window powers' indices stay below 2^14."""
    for L in range(18, 26):
        n = 1 << L
        plan = Ps.sweep_plan(n, kind)
        narrowest = plan.win_hi[0] - plan.win_lo[0]
        for i in range(plan.sweeps):
            s, c, ops = plan.hi[i] - plan.lo[i], plan.cols[i], plan.ops[i]
            words = ops << (s + c)
            assert words <= Ps.SWEEP_TILE_WORDS
            if plan.lo[i] > 0:
                if 1 << (s + c) > Ps.SWEEP_UPPER_WORDS:
                    fewer = Ps.sweep_plan.__wrapped__(n, kind)
                    assert fewer.windows == plan.windows
                    assert s == Ps._log2(Ps.SWEEP_TILE_WORDS) - c
                if words <= Ps.SWEEP_UPPER_WORDS:
                    assert plan.threads[i] <= 512
                    assert 2 * (plan.smem[i] + 1024) <= 233472
                if plan.fwd[i] and not plan.inv[i]:
                    nops = Ps.SWEEP_KINDS[kind][2]
                    join = nops << (s + c) <= Ps.SWEEP_UPPER_WORDS
                    assert (ops, plan.split[i]) == (
                        (nops, 1) if join else (1, nops))
            assert plan.vec[i] == (0 if kind == "stockham" else
                                   1 if plan.lo[i] == 0 else 2)
            if plan.vec[i] == 2:
                assert (plan.cb[i], c) == (0, 3)
            assert s <= 15 and (s - 1 <= 14 if kind.startswith("B")
                                else s <= 14)
        assert narrowest <= 15 - Ps._log2(Ps.SWEEP_KINDS[kind][2])


def test_sweep_powers_on_the_device_equal_the_model():
    """``ntt.sweep_powers`` (the wrapper's table, cached per device) is the
    model's ``sweep_powers_of`` as uint32, 4 rows of min(n, 2^14): the
    merged rows with entries 0 and 1 of the inverse freed of n^{-1}, the
    pairing rows as they are."""
    n, q = 4096, 40961
    tbl = get_tables(_name(n, q))
    for pairing, src in ((False, tbl.packed), (True, tbl.pairing_packed)):
        got = TN.sweep_powers(tbl, pairing, torch.device("cpu"))
        want = Ps.sweep_powers_of(torch.from_numpy(src.astype(np.int64)), q,
                                  not pairing)
        assert got.dtype == torch.uint32 and got.shape == (4, n)
        assert torch.equal(got.to(torch.int64), want)
        if not pairing:
            assert want[2, 0] == 1 and want[2, 1] * int(src[2, 0]) % q == int(
                src[2, 1])
            assert torch.equal(want[:, 2:], torch.from_numpy(
                src[:4, 2:].astype(np.int64)))


def test_stockham_scratch_rows_hold_its_positions():
    """Stockham's first launch leaves in scratch a each operand's row after
    the forward's stages above the narrowest window, at its autosort's
    positions: the psi-weighted row through that many plain Stockham
    stages (``ntt._stockham``), position for position."""
    n, q = 4096, 40961
    tbl = get_tables(_name(n, q))
    x, y, _ = _operands(n, q)
    for windows in (None, 3):
        plan = Ps.sweep_plan(n, "stockham", windows)
        tw = torch.from_numpy(tbl.pairing_packed.astype(np.int64))
        mdl = Ps.SweepModel(plan, n, q, tw,
                            lambda a, b: F._barrett(a, b, tbl))
        trace = []
        mdl.run([x.to(torch.int64), y.to(torch.int64)], trace)
        i, dst, buf = trace[0]
        assert (i, dst) == (0, "a")
        stages = n.bit_length() - 1 - plan.lo[0]
        for o, v in enumerate((x, y)):
            want = TN._stockham(TN.weight_psi(v.to(torch.int64), tbl),
                                tbl, "stockham_fwd", stages)
            assert torch.equal(buf[:, o] % q, want), windows


def test_b2_sweep_twin_matches_jax_interpret_2pow18():
    """B2's sweep twin at n = 2^18 (where the card runs its cluster form;
    the sweep form from 2^19) equals JAX's ``ntt_fused_fn`` in interpret
    mode on one row of q - 1 and one random."""
    n, q = 1 << 18, LARGE[1 << 18]
    name = _name(n, q)
    tbl = get_tables(name)
    x, _, _ = _operands(n, q, rows=2)
    got = F.ntt_passes_plain(x, tbl, Ps.sweep_plan(n, "B2"))
    want = np.asarray(JK.ntt_fused_fn(name, interpret=True)(x.numpy()))
    np.testing.assert_array_equal(got.numpy(), want)


def _definition(x, y, q, ks):
    """Coefficients ks of x * y mod (X^n + 1) mod q from the definition:
    z_k = sum_{i <= k} x_i y_{k-i} - sum_{i > k} x_i y_{n+k-i}, each
    product reduced mod q, in int64."""
    n = x.shape[0]
    x, y = x.astype(np.int64), y.astype(np.int64)
    out = []
    for k in ks:
        i = np.arange(n)
        yy = np.where(i <= k, y[(k - i) % n], q - y[(k - i) % n])
        out.append(int((x * yy % q).sum() % q))
    return out


def test_b1_sweep_twin_closed_form_and_definition():
    """B1's sweep twin at n = 2^18, q = 1056440321 (2^32 - 4q =
    69,206,012): the all-(q - 1) row gives z_k = 2k + 2 - n mod q, and 8
    coefficients of a random row equal the definition."""
    n, q = 1 << 18, LARGE[1 << 18]
    tbl = get_tables(_name(n, q))
    x, y, _ = _operands(n, q, rows=2)
    plan = Ps.kernel_plan(n, "B1")
    assert isinstance(plan, Ps.SweepPlan)
    z = F.polymul_fused_passes_plain(x, y, tbl).numpy()
    k = np.arange(n, dtype=np.int64)
    np.testing.assert_array_equal(z[0].astype(np.int64), (2 * k + 2 - n) % q)
    ks = [0, 1, 2, 12345, n // 2 - 1, n // 2, n - 2, n - 1]
    assert [int(v) for v in z[1, ks]] == _definition(x[1].numpy(),
                                                     y[1].numpy(), q, ks)


def _jax(kind, name, x, y, spec, lazy):
    if kind == "B1":
        return JK.polymul_fused_fn(name, interpret=True)(x, y)
    if kind == "B4":
        return JK.polymul_fixed_fused_fn(name, interpret=True)(x, spec)
    if kind == "B2":
        return JK.ntt_fused_fn(name, interpret=True)(x)
    if kind == "B3":
        return JK.intt_fused_fn(name, interpret=True)(lazy)
    return polymul_pairing_fn(name, kind, interpret=True)(x, y)


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_twins_match_jax_interpret_small(kind):
    """Each kind's sweep twin under a forced three-window plan at n =
    4096, q = 40961 (the factored twiddles on every stage), equals JAX's
    interpret-mode kernel on a row of q - 1 and a random row (B3: 2q - 1
    and B2's output; B4 against y's spectrum with q - 1 every fifth
    value)."""
    n, q = 4096, 40961
    name = _name(n, q)
    tbl = get_tables(name)
    x, y, lazy = (v[:2] for v in _operands(n, q))
    spec = F.ntt_plain(y[1], tbl)
    spec[::5] = q - 1
    plan = Ps.sweep_plan(n, kind, 3)
    assert plan.windows == 3
    if kind == "B3":
        lazy = F.ntt_passes_plain(x, tbl, Ps.sweep_plan(n, "B2", 3))
    got, _ = _twin(kind, tbl, x, y, lazy, spec, plan)
    want = _jax(kind, name, x.numpy(), y.numpy(), spec.numpy(),
                lazy.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.slow
@pytest.mark.parametrize("n", [1 << 18, 1 << 19])
@pytest.mark.parametrize("kind", KINDS)
def test_sweep_twins_match_jax_interpret(kind, n):
    """Each kind's sweep twin (``sweep_plan``; B2 then B3 at 2^18, where
    the card runs their cluster form, too) equals JAX's interpret-mode
    kernel on one row of q - 1 (B3: 2q - 1): B3 on B2's output, B4
    against y's spectrum with q - 1 every fifth value."""
    q = LARGE[n]
    name = _name(n, q)
    tbl = get_tables(name)
    x, y, lazy = (v[:1] for v in _operands(n, q))
    spec = F.ntt_plain(y[0], tbl)
    spec[::5] = q - 1
    plan = Ps.sweep_plan(n, kind)
    if kind == "B3":
        lazy = F.ntt_passes_plain(x, tbl, Ps.sweep_plan(n, "B2"))
    got, _ = _twin(kind, tbl, x, y, lazy, spec, plan)
    want = _jax(kind, name, x.numpy(), y.numpy(), spec.numpy(),
                lazy.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind == "B3":
        np.testing.assert_array_equal(got.numpy(), x.numpy())


@pytest.mark.slow
def test_b1_sweep_twin_matches_jax_interpret_2pow20():
    """B1's sweep twin at n = 2^20, q = 1012924417, equals JAX's
    interpret-mode ``_polymul_kernel`` on a row of q - 1 and the closed
    form."""
    n, q = 1 << 20, LARGE[1 << 20]
    name = _name(n, q)
    x, y, _ = (v[:1] for v in _operands(n, q))
    got = F.polymul_fused_passes_plain(x, y, get_tables(name)).numpy()
    want = np.asarray(JK.polymul_fused_fn(name, interpret=True)(
        x.numpy(), y.numpy()))
    np.testing.assert_array_equal(got, want)
    k = np.arange(n, dtype=np.int64)
    np.testing.assert_array_equal(got[0].astype(np.int64),
                                  (2 * k + 2 - n) % q)


def test_sweep_timing_needs_a_card():
    """``utils/sweep_timing.py`` refuses a ring with no prime and an
    unknown kind, and without a card exits 1 (it times nothing on the
    CPU)."""
    from qtesla_tpu_torch.utils import sweep_timing as ST

    for argv in (["--rings", "17:4"], ["--kinds", "B9"]):
        with pytest.raises(SystemExit):
            ST.main(argv)
    if not torch.cuda.is_available():
        assert ST.main(["--rings", "18:1", "--kinds", "B1"]) == 1


@pytest.mark.slow
def test_tables_at_2pow25_build_in_seconds():
    """At n = 2^25, q = 469762049 (the only prime the registry takes
    there), the port's tables build in int64 numpy within 60 s on the CPU
    (the object-int loops they replace had not finished after 400 s), and
    sampled entries of every table the kernels read equal their
    definitions: psi_rev (psi^brev(i)), the n^{-1}-folded inverse row,
    phi and n^{-1} psi^{-i}, the cyclic rows omega^(j n / 2h) at h + j,
    each with its Shoup companion floor(w 2^32 / q)."""
    import time

    name, n, q = "sweep-tables-n33554432", 1 << 25, 469762049
    TPARAMS.register_param_set(name, n, q)
    try:
        start = time.perf_counter()
        tbl = get_tables(name)
        packed, pairing = tbl.packed, tbl.pairing_packed
        assert time.perf_counter() - start < 60
        ps = tbl.ps
        L = ps.logn
        rng = np.random.default_rng(25)
        for i in [2, 3, n // 2, n - 1, *rng.integers(2, n, 40).tolist()]:
            br = int(format(i, f"0{L}b")[::-1], 2)
            want = {0: pow(ps.psi, br, q), 2: pow(ps.psi_inv, br, q),
                    4: pow(ps.psi, i, q),
                    6: pow(ps.psi_inv, i, q) * ps.n_inv % q}
            for row, w in want.items():
                table = packed if row < 4 else pairing
                assert int(table[row % 4 if row < 4 else row, i]) == w
                assert int(table[(row % 4 if row < 4 else row) + 1, i]) == (
                    w << 32) // q
            h = 1 << (i.bit_length() - 1)
            w = pow(ps.omega, (i - h) * (n // (2 * h)), q)
            assert int(pairing[0, i]) == w
            assert int(pairing[1, i]) == (w << 32) // q
        assert int(packed[2, 0]) == ps.n_inv
        assert int(packed[2, 1]) == pow(ps.psi_inv, 1 << (L - 1),
                                        q) * ps.n_inv % q
    finally:
        del TPARAMS.PARAM_SETS[name]
        TPARAMS.get_params.cache_clear()
        get_tables.cache_clear()
