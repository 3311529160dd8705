"""The port's CLI (``python -m qtesla_tpu_torch.cli``) against the JAX
package's (``qtesla_tpu.cli``), both in process on the CPU, on the same
arguments and seed.

- ``info``: the banner of each of the five registered sets equals JAX's.
- ``correctness``: on smallprime, ramp and ``--random``, every line (the
  banner and, for every plain pipeline and ``nussbaumer``, the oracle and
  all-ones lines) equals JAX's, and both exit 0; a wrong product exits 1
  with ``INCORRECT RESULT``.
- ``_algos``: the list of every algo equals JAX's, ``all`` on the CPU
  equals JAX's CPU list, a kernel algo on the CPU and an unknown algo raise
  ``SystemExit``; without a card and without ``--device cpu`` the CLI exits
  naming ``--device``.
- ``speed``: the plain, ``--fixed``, ``--streamed`` and ``--fixed
  --streamed`` JSON rows have JAX's keys plus ``device`` and ``clock``
  (``"host"`` here) and JAX's ``algo`` tags.
- ``sweep`` prints one row a batch, ``microbench`` one row an op.
- ``scaling`` in one process: JAX's row keys plus the label, JAX's skip
  message at ``--model 2``, ``overhead_eff`` 1.0 at d = 1; across 2 gloo
  ranks on the CPU (``--init-method file://``, each rank waited on at most
  120 s and killed in any case): DP rows at d = 1, 2, the four-step SP and
  Ulysses rows, every row with the caveat.
- ``--register``: a registered set runs ``speed``; a malformed spec is
  refused with JAX's message.
- ``make_global_mesh(model, ranks)``, the mesh over the first d ranks that
  ``scaling`` times DP on, in a group of one rank: its refusals.

Times are checked for their form only; every residue is exact."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from qtesla_tpu import cli as JCLI
from qtesla_tpu.models import ALGORITHMS as J_ALGORITHMS
from qtesla_tpu.ops.ntt_pairings_pallas import PAIRINGS as J_PAIRINGS
from qtesla_tpu_torch import cli
from qtesla_tpu_torch import params as TPARAMS
from qtesla_tpu_torch.models import polymul as TP

REPO = Path(__file__).resolve().parents[1]
SETS = ("qtesla-i", "qtesla-iii-speed", "qtesla-p-i", "qtesla-p-iii",
        "smallprime")
CPU = ["--device", "cpu"]
WAIT_S = 120


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _port(argv, capsys):
    return _run(cli.main, CPU + argv, capsys)


def _jax_every():
    kernels = ["fused", "mxu"] + [p + "_kernel" for p in sorted(J_PAIRINGS)]
    return sorted(J_ALGORITHMS) + ["nussbaumer"] + kernels


def test_info_banners_equal_jax(capsys):
    rc_j, out_j = _run(JCLI.main, ["info"], capsys)
    rc_t, out_t = _port(["info"], capsys)
    assert rc_j == rc_t == 0
    assert out_t.splitlines()[0].startswith("device: cpu")

    def banners(out):
        return {line.split(":")[0]: line for line in out.splitlines()
                if line.split(":")[0] in SETS}

    assert banners(out_t) == banners(out_j)
    assert len(banners(out_t)) == len(SETS)


@pytest.mark.parametrize("fixture", [[], ["--random", "-r", "7"]],
                         ids=["ramp", "random"])
def test_correctness_lines_equal_jax(capsys, fixture):
    plain = ",".join(a for a in _jax_every()
                     if a not in ("fused", "mxu") and "_kernel" not in a)
    argv = ["correctness", "--param-set", "smallprime", "--algo", plain,
            *fixture]
    rc_j, out_j = _run(JCLI.main, argv, capsys)
    rc_t, out_t = _port(argv, capsys)
    assert rc_j == rc_t == 0
    assert out_t.splitlines() == out_j.splitlines()
    assert out_t.count("Identical.") == 2 * len(plain.split(","))


def test_correctness_wrong_product_exits_1(capsys, monkeypatch):
    def wrong(name, algo="merged"):
        return lambda x, y: torch.zeros_like(x)

    monkeypatch.setattr(TP, "polymul_fn", wrong)
    rc, out = _port(["correctness", "--param-set", "smallprime"], capsys)
    assert rc == 1
    assert "INCORRECT RESULT" in out


def test_algos_equal_jax():
    assert cli._algos("all", "cuda") == _jax_every()
    assert cli._algos("all", "cpu") == JCLI._algos("all")
    assert cli._algos("merged,stockham", "cpu") == ["merged", "stockham"]
    assert cli._algos("fused,gs_ct_kernel", "cuda") == ["fused",
                                                        "gs_ct_kernel"]


@pytest.mark.parametrize("argv", [
    ["speed", "--algo", "fused"],
    ["speed", "--algo", "merged,stockham_kernel"],
    ["correctness", "--algo", "mxu"],
    ["speed", "--fixed", "--algo", "mxu-folded"],
    ["scaling", "--algo", "fused"],
    ["speed", "--algo", "nope"],
], ids=["fused", "pairing-kernel", "mxu", "mxu-folded", "scaling", "unknown"])
def test_kernel_or_unknown_algo_refused_on_cpu(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(CPU + argv + ["--param-set", "smallprime"])
    assert "unknown algo" in str(e.value) or "CUDA kernels" in str(e.value)


def test_no_card_exits_naming_device_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["correctness", "--param-set", "smallprime"])
    assert "--device" in str(e.value)


@pytest.mark.parametrize("mode,tag", [
    ([], "merged"), (["--fixed"], "fixed/merged"),
    (["--streamed"], "streamed/merged"),
    (["--fixed", "--streamed"], "fixed_streamed/merged"),
], ids=["plain", "fixed", "streamed", "fixed-streamed"])
def test_speed_rows_have_jax_keys(capsys, mode, tag):
    argv = ["speed", "--param-set", "smallprime", "--algo", "merged",
            "--batch", "64", "--iters", "2", "--json", *mode]
    rc_j, out_j = _run(JCLI.main, argv, capsys)
    rc_t, out_t = _port(argv, capsys)
    assert rc_j == rc_t == 0
    (row_j,) = json.loads(out_j.strip().splitlines()[-1])
    (row_t,) = json.loads(out_t.strip().splitlines()[-1])
    assert set(row_t) == set(row_j) | {"device", "clock"}
    assert row_t["algo"] == row_j["algo"] == tag
    assert (row_t["device"], row_t["clock"]) == ("cpu", "host")
    assert row_t["batch"] == 64 and row_t["min_ms_per_iter"] > 0
    assert row_t["polymuls_per_s"] > 0


def test_speed_fixed_skips_and_folds_like_jax(capsys):
    """--fixed on 'all' skips the algos with no fixed pair, as JAX does."""
    argv = ["speed", "--param-set", "smallprime", "--algo", "all",
            "--batch", "8", "--iters", "2", "--fixed", "--json"]
    rc_j, out_j = _run(JCLI.main, argv, capsys)
    rc_t, out_t = _port(argv, capsys)
    assert rc_j == rc_t == 0
    skips = [ln for ln in out_t.splitlines() if "SKIP" in ln]
    assert skips == [ln for ln in out_j.splitlines() if "SKIP" in ln]
    assert [r["algo"] for r in json.loads(out_t.splitlines()[-1])] == [
        "fixed/merged"]


def test_sweep_one_row_a_batch(capsys):
    rc, out = _port(["sweep", "--param-set", "smallprime", "--batches",
                     "8,16,32", "--iters", "2"], capsys)
    assert rc == 0
    rows = [ln for ln in out.splitlines() if ln.startswith("  polymul[")]
    assert [r.split("B=")[1].split("]")[0] for r in rows] == ["8", "16", "32"]
    assert all(r.endswith("[cpu, host]") for r in rows)


def test_microbench_one_row_an_op(capsys):
    rc, out = _port(["microbench", "--param-set", "smallprime", "--size",
                     "4096", "--iters", "3"], capsys)
    assert rc == 0
    rows = out.splitlines()[1:]
    assert [r.split(":")[0].strip() for r in rows] == ["addmod", "mulhi",
                                                       "shoup", "barrett"]
    assert all("(torch elementwise, int64) [cpu, host]" in r for r in rows)


def test_scaling_one_process(capsys):
    argv = ["scaling", "--param-set", "smallprime", "--global-batch", "64",
            "--iters", "2", "--json"]
    rc_j, out_j = _run(JCLI.main, argv, capsys)
    rc_t, out_t = _port(argv + ["--model", "2"], capsys)
    assert rc_j == rc_t == 0
    rows_j = json.loads(out_j.strip().splitlines()[-1])
    (row,) = json.loads(out_t.strip().splitlines()[-1])
    assert set(row) == set(rows_j[0]) | {"device", "clock"}
    assert row["mode"] == "dp" and row["devices"] == 1
    assert row["batch"] == 64 and row["overhead_eff"] == 1.0
    assert row["virtual_devices"] is True and "NVLink" in row["caveat"]
    skip = ("  fourstep SP skipped: model=2 needs a divisible device count, "
            "have 1")
    assert skip in out_t.splitlines()


def test_scaling_distributed_two_ranks(tmp_path):
    env = dict(os.environ, WORLD_SIZE="2",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    procs = []
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "qtesla_tpu_torch.cli", "--device",
                 "cpu", "--distributed", "--backend", "gloo",
                 "--init-method", f"file://{tmp_path}/rendezvous", "scaling",
                 "--param-set", "smallprime", "--global-batch", "8",
                 "--iters", "2", "--model", "2", "--json"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
        logs = [p.communicate(timeout=WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    rows = json.loads(logs[0].strip().splitlines()[-1])
    assert [(r["mode"], r["devices"]) for r in rows] == [
        ("dp", 1), ("dp", 2), ("fourstep_sp", 2), ("ulysses_sp", 2)]
    assert all(r["virtual_devices"] and "gloo" in r["caveat"] for r in rows)
    assert rows[0]["overhead_eff"] == 1.0
    assert logs[1].strip().splitlines() == [
        "rank 1 of 2: done; rank 0 prints the rows"]


def test_register_runs_speed(capsys):
    name = "port-cli-64"
    try:
        rc, out = _port(["--register", f"{name}:64:65537", "speed",
                         "--param-set", name, "--batch", "8", "--iters",
                         "2"], capsys)
    finally:
        TPARAMS.PARAM_SETS.pop(name, None)
        TPARAMS.get_params.cache_clear()
    assert rc == 0
    assert f"polymul[{name},merged,B=8]" in out


def test_register_malformed_refused_as_jax():
    spec = "oops:notanint:3"
    with pytest.raises(SystemExit, match="--register") as ej:
        JCLI.main(["--register", spec, "info"])
    with pytest.raises(SystemExit, match="--register") as et:
        cli.main(CPU + ["--register", spec, "info"])
    assert str(et.value) == str(ej.value)


_SUB_MESH = """
import sys
import pytest
from qtesla_tpu_torch.parallel import distributed as D
D.init_distributed(sys.argv[1], world_size=1, rank=0, device="cpu")
mesh = D.make_global_mesh(1, ranks=[0])
assert (mesh.data, mesh.model, mesh.data_index) == (1, 1, 0), mesh
assert D.make_global_mesh(1, ranks=range(1)) is mesh
for ranks, model, match in (([0], 2, "must divide"), ([0, 0], 1, "distinct"),
                            ([1], 1, "distinct"), ([], 1, "distinct")):
    with pytest.raises(ValueError, match=match):
        D.make_global_mesh(model, ranks=ranks)
assert D.slowest([1.5, 2.5]) == [1.5, 2.5]
print("ok")
"""


def test_global_mesh_over_a_rank_list(tmp_path):
    """``make_global_mesh(model, ranks)``, the mesh of ``scaling``'s DP rows
    over the first d ranks, refuses a rank list that ``model`` does not
    divide or that names a rank twice or outside the group."""
    proc = subprocess.run(
        [sys.executable, "-c", _SUB_MESH, f"file://{tmp_path}/rendezvous"],
        capture_output=True, text=True, cwd=REPO, timeout=WAIT_S)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
