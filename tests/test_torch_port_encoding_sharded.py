"""The encoding eval's row-sharded route (``evals._eval_encoding`` under a
mesh: ``parallel.shard.RowBlocks`` and the row-block ridge of
``ops/ridge.py``) on gloo ranks on the CPU, against the JAX package's
``_eval_encoding`` on the conftest's 8-device virtual CPU mesh
(``make_mesh(data=k, devices=jax.devices()[:k])``) and unsharded.

Each rank count (2 and 4) is one spawned group that joins through a file
store in ``tmp_path`` with a 120 s collective timeout and runs every case
(the test process computes the JAX references meanwhile). The cases are
two subjects × two regions and three taps of two widths (selection stacks
by width): one on the Woodbury route, one on the per-fold-eigh route with
``reconstruct_from_pcs``; each has subjects whose train and test row
counts the axis divides (row-sharded) or not (whole on every rank, the
JAX rule). The 4-rank group also runs the Woodbury case on a 2 × 2 mesh
('model' replicas), the 2-rank group ``python -m visreps_tpu_torch.run``
under torchrun's variables, and a process of its own the same CLI alone.

Tolerances are ``tests/test_torch_port_encoding.py``'s: selection scores,
point scores, CIs and bootstrap scores within 1e-4, layers equal unless
the reference's top two selection scores are within 1e-4. The eigh-route
case runs on the alphas ≥ 1 in both packages (below, that route's CV
scores are f32 roundoff; that file's docstring). Every rank's results are
bit-identical.
"""
import os
import socket
import sqlite3
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 300
RTOL = 1e-4
N_BOOT = 16
REGIONS = ["early visual stream", "ventral visual stream"]
ALPHAS = np.logspace(-10, 10, 20)
DETERMINED = ALPHAS[ALPHAS >= 1]
# name → (tap widths, per subject (n_train, n_test, tap the responses read),
# alphas ≥ 1 only, reconstruct_from_pcs). Both subjects read a tap of the
# same width: the grouped refits stack their Grams (both packages).
CASES = {
    "woodbury": ((16, 24, 24), [(120, 42, 2), (121, 42, 1)], False, False),
    "eigh_pca": ((48, 64, 64), [(40, 22, 2), (42, 22, 1)], True, True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine); the ranks set it themselves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _world(seed, widths, subjects):
    """Raw taps of every stimulus, their ids, and both regions' responses
    (8 and 5 voxels) per subject, each subject on its own stimuli."""
    rng = np.random.RandomState(seed)
    names = [f"tap{i + 1}" for i in range(len(widths))]
    n_all = sum(n_tr + n_te for n_tr, n_te, _ in subjects)
    acts = {l: rng.randn(n_all, d).astype(np.float32) for l, d in zip(names, widths)}
    ids = [f"stim{i}" for i in range(n_all)]
    neural = {r: {} for r in REGIONS}
    start = 0
    for s, (n_tr, n_te, tap) in enumerate(subjects):
        rows = slice(start, start + n_tr + n_te)
        for region, v in zip(REGIONS, (8, 5)):
            w = rng.randn(widths[tap], v).astype(np.float32) / np.sqrt(widths[tap])
            y = acts[names[tap]][rows] @ w + 0.5 * rng.randn(n_tr + n_te, v).astype(np.float32)
            neural[region][s] = {"train": dict(zip(ids[rows][:n_tr], y[:n_tr])),
                                 "test": dict(zip(ids[rows][n_tr:], y[n_tr:]))}
        start += n_tr + n_te
    return acts, ids, {"neural": neural}


def _cfg(pca: bool) -> dict:
    return {"analysis": "encoding_score", "bootstrap": True, "n_bootstrap": N_BOOT,
            "encoding_cv_precision": "high", "log_expdata": False,
            "reconstruct_from_pcs": pca, "pca_k": 5}


# ── rank side: runs in the spawned processes (torch and the port only) ──

def _run_case(case, world, model=1):
    """The port's ``_eval_encoding`` on a (world / model) × model mesh,
    with every ridge Gram's input (dims, rows) recorded."""
    from visreps_tpu_torch import evals
    from visreps_tpu_torch.analysis import encoding
    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.ops import ridge
    from visreps_tpu_torch.parallel import make_mesh

    widths, subjects, determined, pca = case
    acts, ids, all_data = _world(0, widths, subjects)
    grams, gram, alphas = [], ridge._gram, ridge.default_alphas

    def probe(x):
        grams.append((x.dim(), x.shape[-2]))
        return gram(x)

    ridge._gram = probe
    if determined:
        ridge.default_alphas = encoding.default_alphas = lambda n=20: DETERMINED.copy()
    try:
        results = evals._eval_encoding(Config(_cfg(pca)), acts, ids, all_data,
                                       list(range(len(subjects))), REGIONS, False,
                                       torch.device("cpu"),
                                       make_mesh(data=world // model, model=model))
    finally:
        ridge._gram, ridge.default_alphas, encoding.default_alphas = gram, alphas, alphas
    return {"results": results, "grams": grams}


def _blocks(world):
    """RowBlocks on a 12-row array (rows i·[1, 2]): the contiguous
    layout, ``sum``, ``take`` of a permutation, ``gather`` in an index
    list's order and ``cat``; a 10-row array on 4 ranks stays whole."""
    from visreps_tpu_torch.parallel import make_mesh
    from visreps_tpu_torch.parallel.shard import RowBlocks

    mesh = make_mesh(data=world)
    n = 12
    x = torch.arange(n, dtype=torch.float32)[:, None] * torch.tensor([1.0, 2.0])
    rows = RowBlocks.of(n, mesh)
    mine = x[rows.block()]
    perm = np.random.RandomState(3).permutation(n)[:9]
    loc, sub = rows.take(perm)
    picked = mine[loc]
    return {"block": mine, "count": rows.count, "sum": rows.sum(mine.sum(0)),
            "taken": picked, "taken_whole": sub.cat(picked), "perm": perm,
            "gather": rows.gather(mine, torch.tensor([7, 0, 11, 3])), "cat": rows.cat(mine),
            "odd": RowBlocks.of(10, mesh) if world == 4 else "n/a"}


def _run_cli(inp, world):
    """``run.main`` outside the spawned group (it leaves it first, so this
    comes last): under torchrun's environment on ``world`` > 1 ranks (the
    group is made by ``run.init_distributed``), else alone; recording the
    mesh the encoding functions were given."""
    from visreps_tpu_torch import run as trun
    from visreps_tpu_torch.analysis import encoding
    from visreps_tpu_torch.core import db
    from visreps_tpu_torch.parallel.mesh import axis_size, rank

    me = rank()
    dist.destroy_process_group()
    if world > 1:
        os.environ.update({"WORLD_SIZE": str(world), "RANK": str(me), "LOCAL_RANK": str(me),
                           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(inp["port"])})
    os.environ.update(inp["env"])
    db.RESULTS_DB_PATH = Path(inp["env"]["VISREPS_RESULTS_DB"])
    meshes, subjects_fn = [], encoding.compute_encoding_scores_subjects

    def probe(*args, mesh=None, **kwargs):
        meshes.append(axis_size(mesh))
        return subjects_fn(*args, mesh=mesh, **kwargs)

    encoding.compute_encoding_scores_subjects = probe
    try:
        results = trun.main(inp["argv"])
    finally:
        encoding.compute_encoding_scores_subjects = subjects_fn
    return {"results": results, "meshes": meshes}


def _task(inp, world):
    out = {"cases": {name: _run_case(case, world) for name, case in inp["cases"].items()},
           "blocks": _blocks(world)} if world > 1 else {}
    if world == 4:
        out["replicas"] = _run_case(inp["cases"]["woodbury"], world, model=2)
    if inp.get("run"):
        out["run"] = _run_cli(inp["run"], world)
    return out


def _rank_main(rank, world, tmp):
    """One rank: join the group, run ``_task``, save its result (or its
    traceback) under ``tmp``."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        inp = torch.load(tmp / "inputs.pt", weights_only=False)
        torch.save({"ok": _task(inp, world)}, tmp / f"rank{rank}.pt")
    except Exception:
        torch.save({"error": traceback.format_exc()}, tmp / f"rank{rank}.pt")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _start(tmp: Path, world: int, inputs: dict):
    """``world`` spawned ranks running ``_task`` on ``inputs``, under ``tmp``."""
    tmp.mkdir()
    torch.save(inputs, tmp / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(tmp))) for r in range(world)]
    for p in procs:
        p.start()
    return tmp, procs


def _join(tmp: Path, procs, deadline: float) -> list:
    """Every rank's result; fails on a rank's error, exit code or a rank
    still running at ``deadline`` (``time.monotonic``)."""
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{len(alive)} ranks still running after {RANK_TIMEOUT_S} s"
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]
    for r, o in enumerate(outs):
        assert "ok" in o, f"rank {r}:\n{o.get('error')}"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return [o["ok"] for o in outs]


# ── test side ──

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_argv(srp_k: int) -> list:
    return ["--mode", "eval", "--device", "cpu", "--config",
            str(REPO / "configs/eval/base.json"), "--override", "neural_dataset=nsd",
            "subject_idx=[0,1]", "region=[early visual stream,ventral visual stream]",
            "analysis=encoding_score", "bootstrap=true", f"n_bootstrap={N_BOOT}",
            "batchsize=16", "num_workers=2", "load_model_from=torchvision",
            "model_name=AlexNet", "pretrained_dataset=none", "extract_pre_and_post=true",
            f"srp_k={srp_k}", "uint8_transfer=true", "log_expdata=true", "seed=1"]


def _jax_eval(case, mesh):
    import visreps_tpu.evals as jevals
    from visreps_tpu.analysis import encoding as jenc
    from visreps_tpu.core.config import Config as JaxConfig
    from visreps_tpu.ops import ridge as jridge

    widths, subjects, determined, pca = case
    acts, ids, all_data = _world(0, widths, subjects)
    with pytest.MonkeyPatch.context() as m:
        if determined:
            for mod in (jridge, jenc):
                m.setattr(mod, "default_alphas", lambda n=20: DETERMINED.copy())
        return jevals._eval_encoding(JaxConfig(_cfg(pca)), acts, ids, all_data,
                                     list(range(len(subjects))), REGIONS, False, mesh=mesh)


def _port_eval(case):
    from visreps_tpu_torch import evals
    from visreps_tpu_torch.analysis import encoding
    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.ops import ridge

    widths, subjects, determined, pca = case
    acts, ids, all_data = _world(0, widths, subjects)
    with pytest.MonkeyPatch.context() as m:
        if determined:
            for mod in (ridge, encoding):
                m.setattr(mod, "default_alphas", lambda n=20: DETERMINED.copy())
        return evals._eval_encoding(Config(_cfg(pca)), acts, ids, all_data,
                                    list(range(len(subjects))), REGIONS, False,
                                    torch.device("cpu"))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both rank groups' outputs and the single-process CLI run's (a
    process of its own: it runs meanwhile), the JAX package's references
    (unsharded and on 2- and 4-device meshes) and the port's
    single-process results."""
    import jax

    from visreps_tpu.parallel.mesh import make_mesh
    from visreps_tpu_torch.benchmarks import fixture as tfixture

    tmp = tmp_path_factory.mktemp("enc_sharded")
    meta = tfixture.ensure_fixture(tmp / "fx", n_shared=30, n_unique=40, n_subjects=2,
                                   n_regions=2, n_voxels=8, img_size=64)
    env = {"NSD_DATA_DIR": str(Path(meta["pickle"]).parent), "NSD_STIMULI_HDF5": meta["stimuli"],
           "VISREPS_RESULTS_DB": str(tmp / "ranks.db")}
    run = {"argv": _run_argv(16), "env": env, "port": _free_port()}
    single = {**run, "env": {**env, "VISREPS_RESULTS_DB": str(tmp / "single.db")}}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    procs = {k: _start(tmp / f"ranks{k}", k, {"cases": CASES, "run": run if k == 2 else None})
             for k in (2, 4)}
    procs[1] = _start(tmp / "single", 1, {"run": single})  # no group: leaves its own
    try:
        jax_refs = {name: {k: _jax_eval(case, None if k == 1 else make_mesh(
            data=k, devices=jax.devices()[:k])) for k in (1, 2, 4)}
            for name, case in CASES.items()}
        port = {name: _port_eval(case) for name, case in CASES.items()}
    finally:
        outs = {k: _join(*started, deadline) for k, started in procs.items()}
    return {"outs": outs, "jax": jax_refs, "port": port, "single": outs.pop(1)[0]["run"],
            "tmp": tmp}


def _top_two_gap(result) -> float:
    top2 = sorted(e["score"] for e in result["layer_selection_scores"])[-2:]
    return top2[1] - top2[0]


def _same_result(got, ref, tol=RTOL):
    """One result dict against another: selection scores, layer, point
    score, CIs and bootstrap scores within ``tol``."""
    assert [e["layer"] for e in got["layer_selection_scores"]] == [
        e["layer"] for e in ref["layer_selection_scores"]]
    np.testing.assert_allclose([e["score"] for e in got["layer_selection_scores"]],
                               [e["score"] for e in ref["layer_selection_scores"]], atol=tol)
    if got["layer"] != ref["layer"]:
        assert _top_two_gap(ref) <= tol
        return
    for key in ("score", "ci_low", "ci_high"):
        assert got[key] == pytest.approx(ref[key], abs=tol), key
    assert len(got["bootstrap_scores"]) == len(ref["bootstrap_scores"]) == N_BOOT
    np.testing.assert_allclose(got["bootstrap_scores"], ref["bootstrap_scores"], atol=tol)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_ranks_match_the_jax_package(groups, case, world):
    """Every rank's results are bit-identical, and equal the JAX
    package's on a ``world``-device mesh and on one device, and the port's
    single-process results, within 1e-4 (subject-major, one result per
    (subject, region))."""
    outs = [o["cases"][case]["results"] for o in groups["outs"][world]]
    assert all(o == outs[0] for o in outs[1:])
    got = outs[0]
    assert len(got) == 4 and [r["analysis"] for r in got] == ["encoding_score"] * 4
    for ref in (groups["jax"][case][world], groups["jax"][case][1], groups["port"][case]):
        assert len(ref) == len(got)
        for g, r in zip(got, ref):
            _same_result(g, r)
    # the planted taps are found: subject 0 reads tap3, subject 1 tap2
    assert [r["layer"] for r in got] == ["tap3", "tap3", "tap2", "tap2"]


def test_model_axis_holds_replicas(groups):
    """On a 2 × 2 mesh the 'model' axis holds replicas: each 'data' pair
    row-shards over two ranks (refit Grams of 120 / 2 rows), and all four
    ranks' results equal the 2-rank mesh's bit for bit, so the JAX
    package's on 2 devices within 1e-4."""
    outs = [o["replicas"] for o in groups["outs"][4]]
    two = groups["outs"][2][0]["cases"]["woodbury"]["results"]
    for o in outs:
        assert o["results"] == two
        assert {rows for dims, rows in o["grams"] if dims == 2} == {60, 121}
    for g, r in zip(two, groups["jax"]["woodbury"][2]):
        _same_result(g, r)


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_multiplies_its_row_block(groups, world):
    """The Gram probe (Woodbury case): subject 0's 120 train rows divide
    the axis, so its refit Grams read 120 / world rows on each rank and its
    two stacked selection Grams (one per width) this rank's share of the 96
    fit rows; subject 1's 121 rows do not, so every rank's Grams read all
    of them (the JAX package replicates such arrays)."""
    grams = [o["cases"]["woodbury"]["grams"] for o in groups["outs"][world]]
    for g in grams:
        stacked = [rows for dims, rows in g if dims == 3]
        refit = [rows for dims, rows in g if dims == 2]
        assert len(stacked) == 4 and stacked[2:] == [96, 96]
        assert all(r < 96 for r in stacked[:2])
        assert set(refit) == {120 // world, 121}
    for i in range(2):
        assert sum(g[i][1] for g in grams) == 96


@pytest.mark.parametrize("world", [2, 4])
def test_row_blocks(groups, world):
    """``RowBlocks``: contiguous blocks of n / world rows, ``sum`` over the
    ranks, ``take`` of a permutation's rows in its order (gathered whole,
    the permuted array), ``gather`` in an index list's order, ``cat``; no
    layout where the axis does not divide n."""
    n = 12
    x = np.arange(n, dtype=np.float32)[:, None] * np.array([1.0, 2.0], np.float32)
    per = n // world
    for r, o in enumerate(groups["outs"][world]):
        b = o["blocks"]
        np.testing.assert_array_equal(b["block"].numpy(), x[r * per:(r + 1) * per])
        assert b["count"] == per
        np.testing.assert_array_equal(b["sum"].numpy(), x.sum(0))
        mine = [p for p in b["perm"] if r * per <= p < (r + 1) * per]
        np.testing.assert_array_equal(b["taken"].numpy(), x[mine])
        np.testing.assert_array_equal(b["taken_whole"].numpy(), x[b["perm"]])
        np.testing.assert_array_equal(b["gather"].numpy(), x[[7, 0, 11, 3]])
        np.testing.assert_array_equal(b["cat"].numpy(), x)
        assert b["odd"] is None if world == 4 else b["odd"] == "n/a"


def test_run_on_two_ranks_writes_the_single_process_rows_once(groups):
    """``python -m visreps_tpu_torch.run ... analysis=encoding_score`` as two
    gloo ranks (torchrun's environment, ``--device cpu``) on a tiny NSD
    fixture (2 subjects × 2 regions, 40 train and 30 test stimuli each,
    srp_k 16: the Woodbury route): the encoding functions get the 2-rank
    mesh, both ranks return the same rows, results.db holds each once, and
    they are the single process's rows within 1e-3. Not closer: each rank
    extracts half of every batch, whose taps differ from the whole batch's
    by ≈ 1e-7, and the SRP's bf16 input rounding turns a few of those into
    one-ulp steps of the store (``tests/test_torch_port_parallel.py``'s
    run test, for RSA)."""
    outs = [o["run"] for o in groups["outs"][2]]
    assert [o["meshes"] for o in outs] == [[2], [2]] and groups["single"]["meshes"] == [1]
    assert outs[0]["results"] == outs[1]["results"]
    got, want = outs[0]["results"], groups["single"]["results"]
    assert len(got) == len(want) == 4
    assert [r["layer"] for r in got] == [r["layer"] for r in want]
    for g, r in zip(got, want):
        np.testing.assert_allclose([g["score"], g["ci_low"], g["ci_high"]],
                                   [r["score"], r["ci_low"], r["ci_high"]], atol=1e-3)
    with sqlite3.connect(str(groups["tmp"] / "ranks.db")) as conn:
        rows = conn.execute("SELECT run_id, analysis, layer, score FROM results "
                            "ORDER BY rowid").fetchall()
    assert len(rows) == 4 and len({r[0] for r in rows}) == 4
    assert [(r[1], r[2], r[3]) for r in rows] == [
        ("encoding_score", o["layer"], o["score"]) for o in got]
