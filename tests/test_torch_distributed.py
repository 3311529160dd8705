"""The port's sharded paths across processes (``qtesla_tpu_torch/parallel/
distributed.py`` and the rank forms of ``sharded.py``, ``sharded_mxu.py``,
``sharded_classes.py``, ``ulysses.py``) against the JAX package's mesh
functions on the 8-device CPU mesh (``tests/conftest.py``).

- Ranks are real processes of ``python -m
  qtesla_tpu_torch.parallel.dist_check`` joined through gloo
  (``init_method=file://``, so that test workers cannot race for a port),
  each waited on at most 120 s and killed in any case.  This process makes
  the inputs with numpy from a seed, computes JAX's results on a mesh of
  the same shape, assembles the ranks' shards and compares them bit for
  bit (tolerance none: every value is an exact residue), and the rows
  ``local_shard`` gathered on each rank with the rows it holds.
- One 2-rank run (model 2; its DP forms on data 2): DP, fixed DP, the SP
  path at chunks 1 and 2, the fixed and folded SP pairs (the fixed pair's
  spectrum row and its product against JAX's spectrum row too), the class
  path, Ulysses, fixed Ulysses, the plain-torch four-step and
  ``polymul_sp_fn`` at both of its strategies.
- The fault pair: one rank leaves after joining; the survivor's
  ``barrier(timeout_s=5)`` raises within 20 s naming rank 1 and
  ``live_processes()`` is [0].
- Without processes: the hosts-major rank layout against JAX's
  ``make_global_mesh``, the exchange's send and receive placements against
  the one-card permutations shard for shard, ``global_batch`` against the
  shard indices of JAX's ``NamedSharding``, ``make_mesh(data=2)`` outside a
  group, ``chunks`` in {1, 2, 3} on the stacked form against JAX's, the fold
  tables of one shard's spectrum row.
- ``slow``: 4 ranks as data 2 x model 2 (JAX's DP x SP layout), Ulysses at
  4 ranks on 6 rows (padded to 8, as JAX pads), and the 2-rank run at
  qtesla-i.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP_

from qtesla_tpu import parallel as JPAR
from qtesla_tpu.parallel import distributed as JD
from qtesla_tpu.parallel import sharded_mxu as JS
from qtesla_tpu_torch import get_params
from qtesla_tpu_torch.parallel import dist_check as DC
from qtesla_tpu_torch.parallel import distributed as D
from qtesla_tpu_torch.parallel import sharded as TSH
from qtesla_tpu_torch.parallel import sharded_classes as C
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel import sharded_mxu_tables as ST
from qtesla_tpu_torch.parallel import ulysses as TU
from qtesla_tpu_torch.parallel.mesh import Mesh, make_mesh

BATCH = 8
SP_FN = ("sp_fn:8", "sp_fn:1")          # Ulysses, then the four-step
PATHS = DC.PATHS_OF_TEST + SP_FN
WAIT_S = 120


def _inputs(name, seed, batch):
    ps = get_params(name)
    rng = np.random.default_rng(seed)
    x, y = rng.integers(0, ps.q, (2, batch, ps.n), dtype=np.uint32)
    a = rng.integers(0, ps.q, ps.n, dtype=np.uint32)
    x[0], y[0], a[:4] = ps.q - 1, ps.q - 1, ps.q - 1
    return x, y, a


def _jax_spectrum(name, data, model, a):
    """JAX's fixed SP spectrum (n,) of a on a (data, model) mesh."""
    mesh = JPAR.make_mesh(data=data, model=model)
    prep, _ = JS.polymul_fixed_fourstep_mxu_fn(name, mesh, interpret=True)
    return np.asarray(prep(a))


def _jax_results(name, data, model, x, y, a, jspec, paths):
    """JAX's output of each path on a (data, model) mesh of the CPU devices
    (the DP ones on data * model x 1)."""
    mesh = JPAR.make_mesh(data=data, model=model)
    dp = JPAR.make_mesh(data=data * model, model=1)

    def fixed(pair):
        prep, mul = pair
        return mul(x, prep(a))

    def folded():
        prep, mul = JS.polymul_fixed_folded_fourstep_mxu_fn(name, mesh,
                                                            interpret=True)
        return mul(x, *prep(a))

    run = {
        "dp:merged": lambda: JPAR.polymul_dp_fn(name, dp, "merged")(x, y),
        "fixed_dp:merged": lambda: fixed(JPAR.polymul_fixed_dp_fn(
            name, dp, "merged")),
        "fixed_sp": lambda: JS.polymul_fixed_fourstep_mxu_fn(
            name, mesh, interpret=True)[1](x, jspec),
        "folded_sp": folded,
        "classes": lambda: JS.polymul_fourstep_mxu_classes_fn(
            name, mesh, interpret=True)(x, y),
        "ulysses": lambda: JPAR.polymul_ulysses_fn(name, mesh)(x, y),
        "fixed_ulysses": lambda: fixed(JPAR.polymul_fixed_ulysses_fn(
            name, mesh)),
        "fourstep_jnp": lambda: JPAR.polymul_fourstep_sharded_fn(
            name, mesh, local="jnp")(x, y)}
    out = {}
    for p in paths:
        kind, _, arg = p.partition(":")
        if kind == "sp":
            z = JS.polymul_fourstep_mxu_fn(name, mesh, interpret=True,
                                           chunks=int(arg))(x, y)
        elif kind == "sp_fn":
            z = JPAR.polymul_sp_fn(name, mesh, batch_hint=int(arg))(x, y)
        else:
            z = run[p]()
        out[p] = np.asarray(z)
    return out


def _rank_mesh(r, data, model):
    """Rank r's mesh as the rank sees it, without its groups."""
    return Mesh(data, model, torch.device("cpu"), None, None,
                *D.rank_coords(r, model))


def _run(name, world, model, paths, tmp, extra=(), batch=BATCH):
    """Launch the ranks of every path, JAX's results computed meanwhile
    (the fixed SP spectrum first: the ranks read it)."""
    x, y, a = _inputs(name, 7 + world + model, batch)
    data = world // model
    jspec = (_jax_spectrum(name, data, model, a) if "fixed_sp" in paths
             else np.zeros_like(a))
    np.savez(tmp / "in.npz", name=name, x=x, y=y, a=a, jspec=jspec)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        outs = pool.submit(DC.launch, world, tmp / "in.npz", tmp,
                           f"file://{tmp}/rendezvous",
                           ["--device", "cpu", "--model", model, "--gather",
                            "--paths", *paths, *extra], timeout=WAIT_S)
        jres = _jax_results(name, data, model, x, y, a, jspec, paths)
        outs = outs.result()
    return dict(name=name, world=world, model=model, jres=jres, jspec=jspec,
                outs=outs, xy=(x, y))


def _check_path(run, path):
    world, model, jres, outs = (run[k] for k in ("world", "model", "jres",
                                                 "outs"))
    data = world // model
    layout = DC.layout_of(path, data, model)
    dm = world if layout == "dp" and not path.startswith("sp_fn") else data
    got = DC.assemble([o[f"z:{path}"] for o in outs], layout, dm, world // dm)
    np.testing.assert_array_equal(got, jres[path], err_msg=path)
    for r, o in enumerate(outs):
        rows = D.process_rows(_rank_mesh(r, dm, world // dm), len(got),
                              layout)
        np.testing.assert_array_equal(o[f"rows:{path}"], jres[path][rows],
                                      err_msg=f"{path} rank {r}")
    if path == "fixed_sp":
        # each rank's spectrum row is JAX's (lazy there, canonical here),
        # and JAX's row carries across
        plans = ST.fourstep_mxu_plans(run["name"], _n1(run["name"]), model)
        for r, o in enumerate(outs):
            want = ST.rank_spectrum(run["jspec"], plans, r % model) % plans.q
            np.testing.assert_array_equal(o["prep:fixed_sp"], want)
            np.testing.assert_array_equal(o["zj:fixed_sp"], o["z:fixed_sp"])


def _n1(name):
    return 1 << ((get_params(name).n.bit_length() - 1) // 2)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _run("smallprime", 2, 2, PATHS, tmp_path_factory.mktemp("two"),
                ("exchange",))


@pytest.mark.parametrize("path", PATHS)
def test_two_ranks_match_jax_mesh(two_ranks, path):
    _check_path(two_ranks, path)


def test_exchange_across_ranks_matches_all_to_all(two_ranks):
    """The SP path's forward exchange alone: each rank's result is its
    shard of JAX's lax.all_to_all(split_axis=1, concat_axis=2) on the
    (1, 2) mesh."""
    x, _ = two_ranks["xy"]
    B, n = x.shape
    n1 = _n1("smallprime")
    mesh = JPAR.make_mesh(data=1, model=2)
    fwd = jax.jit(jax.shard_map(
        lambda v: lax.all_to_all(v, "model", split_axis=1, concat_axis=2,
                                 tiled=True),
        mesh=mesh, in_specs=JP_("data", None, "model"),
        out_specs=JP_("data", "model", None)))
    want = np.asarray(fwd(x.reshape(B, n1, n // n1)))
    for d, o in enumerate(two_ranks["outs"]):
        rows = want[:, d * n1 // 2:(d + 1) * n1 // 2]
        np.testing.assert_array_equal(o["z:exchange"], rows.reshape(B, -1))


def test_dead_rank_is_detected(tmp_path):
    """Rank 1 leaves after joining; the survivor's barrier (5 s timeout)
    raises within 20 s, names rank 1, and live_processes() is [0]."""
    outs = DC.launch(2, tmp_path / "none.npz", tmp_path,
                     f"file://{tmp_path}/rendezvous",
                     ["--device", "cpu", "--timeout", 5],
                     modes=["detect", "die"], timeout=WAIT_S)
    assert "rank 1 leaves" in outs[1]["log"], outs[1]["log"]
    survivor = outs[0]
    assert int(survivor["detected"]) == 1, survivor["log"]
    assert float(survivor["seconds"]) < 20
    assert survivor["missing"].tolist() == [1]
    assert survivor["live"].tolist() == [0]


# ----------------------------------------------------------------------
# Without processes.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("model", [1, 2, 4, 8])
def test_hosts_major_layout_matches_jax(model):
    jmesh = JD.make_global_mesh(model=model)
    ids = np.vectorize(lambda dev: dev.id)(jmesh.devices)
    for r in range(8):
        assert ids[D.rank_coords(r, model)] == r
    model_groups, data_groups = D.mesh_groups(8, model)
    assert model_groups == ids.tolist()
    assert data_groups == ids.T.tolist()


def _exchange_across(v, local_shape, split, concat):
    """What the ranks of a model group hold after ``all_to_all``: each
    shard of the stacked v (k, ...) as ``local_shape``, its send blocks,
    block d of every rank received by rank d in rank order, placed."""
    k = v.shape[0]
    sends = [D.send_blocks(t.reshape(local_shape), k, split) for t in v]
    return torch.stack([D.recv_blocks(torch.stack([s[d] for s in sends]),
                                      concat) for d in range(k)])


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind", ["sp_fwd", "sp_inv", "classes_fwd",
                                  "ulysses_rows", "ulysses_positions",
                                  "fourstep_fwd", "fourstep_inv"])
def test_rank_exchange_matches_one_card(kind, k):
    """The send and receive placements around all_to_all_single, shard for
    shard, against the one-card permutations of the same exchange."""
    plans = ST.fourstep_mxu_plans("qtesla-iii-speed", 32, k)
    n1, n2, n1k, n2k, nloc = (plans.n1, plans.n2, plans.n1k, plans.n2k,
                              plans.nloc)
    B, Dout = 8, 3
    rng = np.random.default_rng(k)

    def draw(*shape):
        return torch.from_numpy(rng.integers(0, 1 << 32, shape,
                                             dtype=np.uint32))

    if kind == "sp_fwd":
        v = draw(k, B, nloc)
        want, got = S.a2a_fwd(v, plans), _exchange_across(v, (B, n1, n2k),
                                                          1, 2)
    elif kind == "sp_inv":
        v = draw(k, B, nloc)
        want, got = S.a2a_inv(v, plans), _exchange_across(v, (B, n1k, n2),
                                                          2, 1)
    elif kind == "classes_fwd":
        v = draw(k, B, Dout * nloc)
        want = C.a2a_fwd_classes(v, plans, Dout)
        got = _exchange_across(v, (B, Dout, n1, n2k), 2, 3)
    elif kind == "ulysses_rows":
        v = draw(k, B, nloc)
        want, got = TU._a2a_to_rows(v), _exchange_across(v, (B, nloc), 0, 1)
    elif kind == "ulysses_positions":
        v = draw(k, B // k, plans.n)
        want = TU._a2a_to_positions(v)
        got = _exchange_across(v, (B // k, plans.n), 1, 0)
    elif kind == "fourstep_fwd":
        v = draw(k, B, n1, n2k)
        want, got = TSH._a2a_fwd(v), _exchange_across(v, (B, n1, n2k), 1, 2)
    else:
        v = draw(k, B, n1k, n2)
        want, got = TSH._a2a_inv(v), _exchange_across(v, (B, n1k, n2), 2, 1)
    assert got.dtype == torch.int32
    assert torch.equal(got.view(torch.uint32).reshape(want.shape), want)


@pytest.mark.parametrize("layout", D.LAYOUTS)
def test_global_batch_matches_named_sharding(layout):
    """Each rank's shard of its process's rows is the shard JAX's
    NamedSharding gives device r of the (data 2, model 4) mesh."""
    data, model, B = 2, 4, 8
    n = get_params("smallprime").n
    n1 = _n1("smallprime")
    jmesh = JPAR.make_mesh(data=data, model=model)
    shape, spec = {
        "dp": ((B, n), JP_(("data", "model"))),
        "sp": ((B, n1, n // n1), JP_("data", None, "model")),
        "ulysses": ((B, model, n // model), JP_("data", "model", None))}[
            layout]
    index = NamedSharding(jmesh, spec).devices_indices_map(shape)
    x = np.random.default_rng(3).integers(0, 1 << 32, (B, n),
                                          dtype=np.uint32)
    for r in range(data * model):
        mesh = _rank_mesh(r, data, model)
        rows = D.process_rows(mesh, B, layout)
        got = D.global_batch(mesh, torch.from_numpy(x[rows]), layout)
        want = x.reshape(shape)[index[jax.devices()[r]]]
        np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))
        assert got.is_contiguous()
    with pytest.raises(ValueError, match="unknown layout"):
        D.global_batch(mesh, torch.from_numpy(x), "rows")
    with pytest.raises(ValueError, match="unknown layout"):
        D.local_shard(torch.from_numpy(x), mesh, "rows")


def test_outside_a_group():
    with pytest.raises(ValueError, match="init_distributed"):
        make_mesh(data=2, device="cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        D.make_global_mesh(2)
    D.barrier("alone", timeout_s=1)          # nothing to wait for
    assert D.live_processes() == [0]
    assert not make_mesh(model=2, device="cpu").across_ranks


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_chunks_on_the_stacked_form_match_jax(two_ranks, chunks):
    """chunks on one device only splits the batch: bit for bit JAX's
    chunks path on the (1, 2) mesh; B = 8 does not split in 3, so 3 is one
    chunk."""
    x, y = two_ranks["xy"]
    fn = S.polymul_fourstep_mxu_fn("smallprime", make_mesh(model=2,
                                                           device="cpu"),
                                   chunks=chunks)
    got = fn(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = (two_ranks["jres"][f"sp:{chunks}"] if chunks < 3 else
            np.asarray(JS.polymul_fourstep_mxu_fn(
                "smallprime", JPAR.make_mesh(data=1, model=2),
                interpret=True, chunks=3)(x, y)))
    np.testing.assert_array_equal(got, want)
    assert S.chunk_count(BATCH, chunks) == (1 if chunks == 3 else chunks)


@pytest.mark.parametrize("name,k", [("smallprime", 2), ("qtesla-i", 4)])
def test_fold_tables_of_one_shard(name, k):
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    spec = np.random.default_rng(k).integers(0, plans.q, plans.n,
                                             dtype=np.uint32)
    W, c = ST.fourstep_fold_tables(plans, spec)
    for d in range(k):
        row = ST.rank_spectrum(spec, plans, d)
        assert row.shape == (1, plans.nloc)
        Wd, cd = ST.fourstep_fold_tables(plans, row, first=d)
        np.testing.assert_array_equal(Wd, W[d:d + 1])
        np.testing.assert_array_equal(cd, c[d:d + 1])
    with pytest.raises(ValueError, match="within the model axis"):
        ST.fourstep_fold_tables(plans, row, first=k)
    with pytest.raises(ValueError, match="a shard in"):
        ST.rank_spectrum(spec, plans, k)


# ----------------------------------------------------------------------
# slow: more ranks, a larger set.
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _run("smallprime", 4, 2, PATHS, tmp_path_factory.mktemp("four"))


@pytest.mark.slow
@pytest.mark.parametrize("path", PATHS)
def test_four_ranks_data_by_model_match_jax_mesh(four_ranks, path):
    _check_path(four_ranks, path)


ULYSSES = ("ulysses", "fixed_ulysses", "sp_fn:8")


@pytest.fixture(scope="module")
def ulysses_four(tmp_path_factory):
    """6 rows on a model axis of 4: each rank pads its rows to 8."""
    return _run("smallprime", 4, 4, ULYSSES, tmp_path_factory.mktemp("uly"),
                batch=6)


@pytest.mark.slow
@pytest.mark.parametrize("path", ULYSSES)
def test_ulysses_at_four_ranks_matches_jax_mesh(ulysses_four, path):
    _check_path(ulysses_four, path)


@pytest.fixture(scope="module")
def two_ranks_qtesla_i(tmp_path_factory):
    return _run("qtesla-i", 2, 2, PATHS, tmp_path_factory.mktemp("p1"))


@pytest.mark.slow
@pytest.mark.parametrize("path", PATHS)
def test_two_ranks_qtesla_i_match_jax_mesh(two_ranks_qtesla_i, path):
    _check_path(two_ranks_qtesla_i, path)
