"""The port's multi-GPU layer (``visreps_tpu_torch/parallel/``) on gloo
ranks on the CPU, against the JAX package's mesh on the conftest's
8-device virtual CPU mesh (``make_mesh(data=k, devices=jax.devices()[:k])``).

Each case spawns 2 or 4 processes that join one gloo group through a
file store in ``tmp_path`` (so concurrent test workers never share a
port) with a 120 s collective timeout, runs the port there and writes
every rank's result; the test process waits at most ``RANK_TIMEOUT_S``
and holds every rank's result against the JAX package's. Tolerances are
``tests/test_sharding.py``'s: RDMs 2e-5, bootstraps 1e-6 (the sharded
iterations are the single-process ones), the data-parallel step's loss
1e-5 relative, gradient norm 1e-3 relative, parameters 3e-3 (AdamW's
first update is ≈ lr · sign(g)) and BatchNorm statistics 1e-5. The DP
step against JAX runs with dropout off (the packages draw masks from
different generators); against the port's own single-process step it
runs with dropout on (the ranks slice the global mask) at 1e-5.
"""
import os
import socket
import sqlite3
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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine); the ranks set it themselves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ── rank side: runs in the spawned processes (torch and the port only) ──

def _task_rdm(inp, world):
    from visreps_tpu_torch.parallel import make_mesh, rdm_sharded

    mesh = make_mesh(data=world // inp["model"], model=inp["model"])
    return [rdm_sharded(x, mesh, correlation=c).numpy() for x, c in inp["cases"]]


def _task_bootstrap(inp, world):
    from visreps_tpu_torch.ops.bootstrap import (
        bootstrap_rdm_correlation,
        grouped_scoring,
        single_pair_scoring,
    )
    from visreps_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=world // inp["model"], model=inp["model"])
    layers = {k: torch.from_numpy(v) for k, v in inp["layers"].items()}
    out = {"grouped": grouped_scoring(layers, inp["pairs"], inp["pair_layer"], inp["idx"],
                                      mesh=mesh)}
    out["per_pair"] = {m: bootstrap_rdm_correlation(inp["a"], inp["b"], indices=inp["idx13"],
                                                    method=m, device="cpu", mesh=mesh)
                       for m in ("spearman", "pearson", "kendall")}
    out["single"] = single_pair_scoring(inp["acts"], inp["neural"], inp["idx13"],
                                        device="cpu", mesh=mesh)
    return out


class _Batches(list):
    """A list of (batch, keys) that the extractor reads as a loader."""

    @property
    def dataset(self):
        return [k for _, keys in self for k in keys]


def _task_extract(inp, world):
    from visreps_tpu_torch.models.convert import srp_from_jax
    from visreps_tpu_torch.models.custom_cnn import TinyCustomCNN
    from visreps_tpu_torch.models.extractor import FeatureExtractor
    from visreps_tpu_torch.parallel import make_mesh
    from visreps_tpu_torch.parallel.shard import mesh_batch_size

    mesh = make_mesh(data=world)
    model = TinyCustomCNN(num_classes=8)
    model.load_state_dict(inp["state"])
    ex = FeatureExtractor(model, ["conv4", "conv5", "fc1"], srp_k=64, device="cpu", mesh=mesh)
    srp_from_jax(ex.srp, inp["srp"])
    acts, ids = ex.get_activations(_Batches(inp["batches"]), store="host")
    single, _ = ex.extract_single_layer(_Batches(inp["batches"]), "fc1_post")
    return {"acts": {k: v.numpy() for k, v in acts.items()}, "ids": ids, "single": single,
            "batch": [mesh_batch_size(b, mesh) for b in (12, 16, 1)]}


def _task_feed(inp, world):
    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.parallel import (
        default_mesh,
        local_batch_size,
        make_mesh,
        process_slice,
        put_global_batch,
    )

    def err(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    mesh = default_mesh()
    x = inp["x"]
    piece = x[process_slice(len(x))]
    return {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "off": default_mesh(Config({"use_mesh": False})),
            "model2": tuple(default_mesh(Config({"mesh_model_axis": 2})).shape),
            "bad_axis": err(lambda: default_mesh(Config({"mesh_model_axis": 3}))),
            "bad_mesh": err(lambda: make_mesh(data=3, model=1)),
            "slices": [process_slice(10, p, world) for p in range(world)],
            "slice": process_slice(10),
            "local": local_batch_size(16, mesh),
            "bad_batch": err(lambda: local_batch_size(10, mesh)),
            "global": put_global_batch(piece, mesh).full_tensor().numpy()}


def _task_train(inp, world):
    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.models.custom_cnn import TinyCustomCNN
    from visreps_tpu_torch.models.layers import sync_batch_norm
    from visreps_tpu_torch.parallel import make_mesh, process_slice
    from visreps_tpu_torch.train.optim import Optimizer
    from visreps_tpu_torch.train.trainer import train_step

    mesh = make_mesh(data=world)
    group = mesh.get_group("data")
    out = {}
    for name, dropout, cfg in (("no_dropout", 0.0, inp["cfg"]), ("dropout", 0.3, inp["sgd"])):
        model = TinyCustomCNN(num_classes=8, dropout=dropout)
        model.load_state_dict(inp["state"])
        sync_batch_norm(model, group)
        opt = Optimizer(model, Config(cfg), 1, model.trainable_mask())
        piece = process_slice(len(inp["y"]))
        x = torch.from_numpy(inp["x"][piece]).permute(0, 3, 1, 2).contiguous()
        gen = torch.Generator().manual_seed(0)
        loss, gn = train_step(model, opt, x, torch.from_numpy(inp["y"][piece]), gen, 0,
                              group=group, rows=(piece.start, len(inp["y"])))
        out[name] = {"loss": float(loss), "grad_norm": float(gn),
                     "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    return out


def _task_run(inp, world):
    """``run.main`` under torchrun's environment (the group is made by
    ``run.init_distributed``, so this task leaves its own group first)."""
    from visreps_tpu_torch import run as trun
    from visreps_tpu_torch.parallel.mesh import rank

    me = rank()
    dist.destroy_process_group()
    os.environ.update({"WORLD_SIZE": str(world), "RANK": str(me), "LOCAL_RANK": str(me),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(inp["port"]),
                       **inp["env"]})
    results = trun.main(inp["argv"])
    dist.init_process_group("gloo", init_method=inp["store2"], rank=me, world_size=world,
                            timeout=timedelta(seconds=120))
    return [{k: r[k] for k in ("layer", "score", "ci_low", "ci_high")} for r in results]


def _task_tp(inp, world):
    from visreps_tpu_torch.models.custom_cnn import CustomCNN
    from visreps_tpu_torch.parallel import make_mesh, shard_params_tp

    mesh = make_mesh(data=world // 2, model=2)
    model = CustomCNN(num_classes=16)
    model.load_state_dict(inp["state"])
    shard_params_tp(model.eval(), mesh)
    sharded = sorted(n for n, p in model.named_parameters() if hasattr(p, "placements"))
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(inp["x"]).permute(0, 3, 1, 2).contiguous())
    local = {n: tuple(p.to_local().shape) for n, p in model.named_parameters() if n in sharded}
    return {"logits": logits.numpy(), "sharded": sharded, "local": local}


def _task_curriculum(inp, world):
    """curriculum_finetuning's CLI under torchrun's environment."""
    from visreps_tpu_torch.experiments.coarse_grain_benefits import curriculum_finetuning as tcur
    from visreps_tpu_torch.parallel.mesh import rank

    me = rank()
    dist.destroy_process_group()
    os.environ.update({"WORLD_SIZE": str(world), "RANK": str(me), "LOCAL_RANK": str(me),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(inp["port"]),
                       **inp["env"]})
    results = tcur.main(inp["argv"])
    dist.init_process_group("gloo", init_method=inp["store2"], rank=me, world_size=world,
                            timeout=timedelta(seconds=120))
    return results


TASKS = {"curriculum": _task_curriculum, "tp": _task_tp, "rdm": _task_rdm, "bootstrap": _task_bootstrap, "extract": _task_extract,
         "feed": _task_feed, "train": _task_train, "run": _task_run}


def _rank_main(rank, world, task, tmp):
    """One rank: join the group, run ``task``, save its result (or its
    traceback) under ``tmp``."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        inp = torch.load(tmp / "inputs.pt", weights_only=False)
        inp["store2"] = f"file://{tmp / 'store2'}"
        torch.save({"ok": TASKS[task](inp, world)}, tmp / f"rank{rank}.pt")
    except Exception:
        torch.save({"error": traceback.format_exc()}, tmp / f"rank{rank}.pt")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(tmp_path: Path, world: int, task: str, inputs: dict) -> list:
    """Every rank's result of ``task`` on ``inputs`` over ``world`` gloo
    ranks; fails on a rank's error, exit code or timeout."""
    tmp = tmp_path / f"{task}{world}"
    tmp.mkdir()
    torch.save(inputs, tmp / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, task, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{len(alive)} ranks still running after {RANK_TIMEOUT_S} s"
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
    for r, o in enumerate(outs):
        assert "ok" in o, f"rank {r}:\n{o.get('error')}"
    assert [p.exitcode for p in procs] == [0] * world
    return [o["ok"] for o in outs]


# ── test side: the JAX package on the virtual mesh ──

def jax_mesh(k: int, model: int = 1):
    import jax

    from visreps_tpu.parallel.mesh import make_mesh

    return make_mesh(data=k // model, model=model, devices=jax.devices()[:k])


@pytest.mark.parametrize("world,model", [(2, 1), (4, 1), (4, 2)])
def test_rdm_sharded(tmp_path, world, model):
    """Pearson at n = 64 and the n = 100 pad path, Spearman at n = 64:
    every rank's RDM equals the JAX ring's on the same mesh shape, and
    the single-device ``compute_rdm``, within 2e-5."""
    from visreps_tpu.ops.rdm import compute_rdm
    from visreps_tpu.parallel.shard import rdm_sharded as jrdm

    rng = np.random.RandomState(0)
    cases = [(rng.randn(64, 256).astype(np.float32), "pearson"),
             (rng.randn(100, 256).astype(np.float32), "pearson"),
             (rng.randn(64, 128).astype(np.float32), "spearman")]
    outs = run_ranks(tmp_path, world, "rdm", {"cases": cases, "model": model})
    mesh = jax_mesh(world, model)
    for i, (x, corr) in enumerate(cases):
        want = np.asarray(jrdm(x, mesh, correlation=corr))
        np.testing.assert_allclose(want, np.asarray(compute_rdm(x, correlation=corr)), atol=2e-5)
        for out in outs:
            assert out[i].shape == want.shape
            np.testing.assert_allclose(out[i], want, atol=2e-5)
            assert np.all(np.diag(out[i]) == 0)


@pytest.mark.parametrize("world,model", [(2, 1), (4, 2)])
def test_sharded_bootstraps(tmp_path, world, model):
    """Grouped scoring (16 iterations, 4 pairs over 3 layers), the per-pair
    bootstrap (13 iterations: a count no axis size divides) by Spearman,
    Pearson and Kendall, and single-pair scoring, on the sharded
    iterations, against the JAX package's mesh routes at 1e-6."""
    from visreps_tpu.ops.bootstrap import (
        bootstrap_indices,
        bootstrap_rdm_correlation,
        grouped_scoring,
        single_pair_scoring,
    )
    from visreps_tpu.ops.rdm import compute_rdm

    rng = np.random.RandomState(1)
    n = 40
    layers = {f"tap{i}": np.asarray(compute_rdm(rng.randn(n, 64).astype(np.float32)))
              for i in range(3)}
    pairs = {("r0", s): rng.randn(n, 8 + 4 * s).astype(np.float32) for s in range(4)}
    pair_layer = {k: f"tap{i % 3}" for i, k in enumerate(pairs)}
    a = np.asarray(compute_rdm(rng.randn(30, 16).astype(np.float32)))
    b = np.asarray(compute_rdm(rng.randn(30, 8).astype(np.float32)))
    acts, neural = rng.randn(30, 24).astype(np.float32), rng.randn(30, 6).astype(np.float32)
    inp = {"layers": layers, "pairs": pairs, "pair_layer": pair_layer, "model": model,
           "idx": bootstrap_indices(n, 16, seed=42), "idx13": bootstrap_indices(30, 13, seed=42),
           "a": a, "b": b, "acts": acts, "neural": neural}
    outs = run_ranks(tmp_path, world, "bootstrap", inp)

    mesh = jax_mesh(world, model)
    boot_j, point_j = grouped_scoring(layers, pairs, pair_layer, inp["idx"], mesh=mesh)
    per_j = {m: bootstrap_rdm_correlation(a, b, indices=inp["idx13"], method=m, mesh=mesh)
             for m in ("spearman", "pearson", "kendall")}
    single_j = single_pair_scoring(acts, neural, inp["idx13"], mesh=mesh)
    for out in outs:
        boot_t, point_t = out["grouped"]
        assert list(boot_t) == list(boot_j)
        for k in boot_j:
            assert boot_t[k].shape == (16,)
            np.testing.assert_allclose(boot_t[k], boot_j[k], atol=1e-6)
            np.testing.assert_allclose(point_t[k], point_j[k], atol=1e-6)
        for m, want in per_j.items():
            assert out["per_pair"][m].shape == (13,)
            np.testing.assert_allclose(out["per_pair"][m], want, atol=1e-6, err_msg=m)
        np.testing.assert_allclose(out["single"][0], single_j[0], atol=1e-6)
        assert out["single"][1] == pytest.approx(single_j[1], abs=1e-6)


def test_extractor_on_the_mesh(tmp_path):
    """TinyCustomCNN's SRP store of three taps and an exact fc1 tap over
    three batches of 8 on 4 ranks against the JAX package's mesh extractor
    on 4 devices (same weights, the JAX SRP matrices carried across):
    ids equal, SRP rows within 2e-2 (bf16 SRP inputs, as
    ``test_sharding.py``), exact rows within 1e-4; the batch size rounds
    up to the mesh (12 → 12, 16 → 16, 1 → 4 on 4 ranks; the JAX
    package's 12 → 16 on 8 devices is the same rule)."""
    import jax

    from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor
    from visreps_tpu.models.zoo import init_model as jax_init_model
    from visreps_tpu.ops.srp import SRPTransform as JaxSRP
    from visreps_tpu_torch.models.convert import params_from_jax

    state = jax_init_model("TinyCustomCNN", 8, seed=0)
    rng = np.random.RandomState(2)
    batches = [(rng.rand(8, 64, 64, 3).astype(np.float32), [str(8 * b + i) for i in range(8)])
               for b in range(3)]
    jex = JaxExtractor(state, ["conv4", "conv5", "fc1"], srp_k=64, batch_size=8, image_size=64,
                       mesh=jax_mesh(4))
    want, want_ids = jex.get_activations(iter(batches))
    want_single, _ = jex.extract_single_layer(iter(batches), "fc1_post")
    jsrp = JaxSRP(k=64, seed=0)
    dims = {int(np.prod(v.shape[1:])) for v in jax.tree_util.tree_leaves(
        state.module.apply(state.variables, np.zeros((1, 64, 64, 3), np.float32), train=False,
                           capture=tuple(jex.points))[1])}
    inp = {"state": params_from_jax(state.params, state.batch_stats), "batches": batches,
           "srp": {d: tuple(np.asarray(c, np.float32) for c in jsrp.matrix_chunks(d))
                   for d in dims}}
    for out in run_ranks(tmp_path, 4, "extract", inp):
        assert out["ids"] == list(want_ids)
        assert set(out["acts"]) == set(want)
        for k in want:
            np.testing.assert_allclose(out["acts"][k], np.asarray(want[k]), atol=2e-2, err_msg=k)
        np.testing.assert_allclose(out["single"], want_single, atol=1e-4)
        assert out["batch"] == [12, 16, 4]
    assert JaxExtractor(state, ["fc1"], srp_k=64, batch_size=12, image_size=64,
                        mesh=jax_mesh(8)).batch_size == 16


def test_default_mesh_and_feed(tmp_path):
    """On 4 ranks: ``default_mesh`` spans all of them as 4 × 1, is None
    with ``use_mesh=false``, carves 2 × 2 from ``mesh_model_axis=2`` and
    raises the JAX package's errors (mesh_model_axis=3, a 3 × 1 mesh);
    ``process_slice`` gives the remainder to the last rank, as the JAX
    function; ``local_batch_size`` divides or raises its text;
    ``put_global_batch`` assembles the global batch from the pieces. In
    one process ``default_mesh`` is None, as the JAX package's on one
    device."""
    from visreps_tpu.core.config import Config as JaxConfig
    from visreps_tpu.parallel.auto import default_mesh as jdefault
    from visreps_tpu.parallel.feed import process_slice as jslice
    from visreps_tpu_torch.parallel import default_mesh

    x = np.arange(48, dtype=np.float32).reshape(16, 3)
    outs = run_ranks(tmp_path, 4, "feed", {"x": x})
    with pytest.raises(ValueError) as jerr:
        jdefault(JaxConfig({"mesh_model_axis": 3}))
    for r, out in enumerate(outs):
        assert out["shape"] == (4, 1) and out["names"] == ("data", "model")
        assert out["off"] is None and out["model2"] == (2, 2)
        assert out["bad_axis"] == str(jerr.value).replace("8 devices", "4 devices")
        assert out["bad_mesh"] == "mesh 3x1 != 4 devices"
        assert out["slices"] == [jslice(10, p, 4) for p in range(4)]
        assert out["slice"] == jslice(10, r, 4)
        assert out["local"] == 4
        assert out["bad_batch"] == "global batch 10 not divisible by 4 processes"
        np.testing.assert_array_equal(out["global"], x)
    assert default_mesh() is None and not dist.is_initialized()


def test_data_parallel_train_step(tmp_path):
    """One AdamW step of TinyCustomCNN on a global batch of 16 (64 px, 8
    classes, clip 1.0) over 4 ranks, with synced BatchNorm, against the
    JAX package's single-device step (dropout off): loss rtol 1e-5,
    gradient norm rtol 1e-3, parameters 3e-3, BatchNorm running
    statistics 1e-5 (``test_sharding.py``'s). With dropout 0.3 the ranks
    apply the single-process mask, so the port's DP step equals its own
    single-process step: loss and gradient norm rtol 1e-5, every tensor
    of the state within 1e-5 (an SGD step, whose update is linear in the
    gradient; AdamW's m/√v amplifies roundoff of near-zero gradients)."""
    import jax
    import jax.numpy as jnp

    from visreps_tpu.core.config import Config as JaxConfig
    from visreps_tpu.models.zoo import init_model as jax_init_model
    from visreps_tpu.train.optim import setup_optimizer
    from visreps_tpu.train.trainer import make_train_step
    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.models.convert import params_from_jax, params_to_jax
    from visreps_tpu_torch.models.custom_cnn import TinyCustomCNN
    from visreps_tpu_torch.train.optim import Optimizer
    from visreps_tpu_torch.train.trainer import train_step

    cfg = {"optimizer": "adamw", "learning_rate": 1e-3, "weight_decay": 1e-3, "grad_clip": 1.0,
           "lr_scheduler": "cosineannealinglr", "num_epochs": 2, "warmup_epochs": 0}
    state = jax_init_model("TinyCustomCNN", 8, seed=0, cache=False,
                           cfg={"arch": {"dropout": 0.0}})
    rng = np.random.RandomState(3)
    x = rng.randn(16, 64, 64, 3).astype(np.float32)
    y = (np.arange(16) % 8).astype(np.int64)
    tx, _ = setup_optimizer(state.params, JaxConfig(cfg), steps_per_epoch=1)
    jp, js, _, jloss, jgn = make_train_step(state.module, tx)(
        *jax.tree_util.tree_map(jnp.array, (state.params, state.batch_stats,
                                            tx.init(state.params))), jnp.asarray(x),
        jnp.asarray(y.astype(np.int32)), jax.random.PRNGKey(0))
    sd = params_from_jax(state.params, state.batch_stats)
    sgd = {**cfg, "optimizer": "sgd", "learning_rate": 0.1}
    outs = run_ranks(tmp_path, 4, "train", {"state": sd, "cfg": cfg, "sgd": sgd, "x": x, "y": y})

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else
                       {prefix + k: np.asarray(v)})
        return out

    ref_p, ref_s = flat(jax.tree_util.tree_map(np.asarray, jp)), flat(
        jax.tree_util.tree_map(np.asarray, js))
    model = TinyCustomCNN(num_classes=8, dropout=0.3)
    model.load_state_dict(sd)
    opt = Optimizer(model, Config(sgd), 1, model.trainable_mask())
    sloss, sgn = train_step(model, opt, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                            torch.from_numpy(y), torch.Generator().manual_seed(0), 0)
    for out in outs:
        dp = out["no_dropout"]
        assert dp["loss"] == pytest.approx(float(jloss), rel=1e-5)
        assert dp["grad_norm"] == pytest.approx(float(jgn), rel=1e-3)
        got_p, got_s = (flat(t) for t in params_to_jax(dp["state"]))
        assert set(got_p) == set(ref_p) and set(got_s) == set(ref_s)
        for k in ref_p:
            np.testing.assert_allclose(got_p[k], ref_p[k], atol=3e-3, err_msg=k)
        for k in ref_s:
            np.testing.assert_allclose(got_s[k], ref_s[k], atol=1e-5, err_msg=k)
        drop = out["dropout"]
        assert drop["loss"] == pytest.approx(float(sloss), rel=1e-5)
        assert drop["grad_norm"] == pytest.approx(float(sgn), rel=1e-5)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(drop["state"][k].numpy(), v.numpy(), atol=1e-5, err_msg=k)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_run_on_two_ranks_writes_the_single_process_rows_once(tmp_path, monkeypatch):
    """``python -m visreps_tpu_torch.run`` as two gloo ranks (torchrun's
    environment, ``--device cpu``) on a tiny NSD fixture (3 subjects × 2
    regions, 30 test stimuli), with ``rdm_shard_threshold`` below the 30
    so phase 2's RDMs take the ring: both ranks return the same rows,
    results.db holds each once, and they are the single process's rows:
    the same layers, scores and CIs within 1e-3. Not closer: each rank's
    dense taps are a half batch's product and the ring sums its Gram in
    another order (RDMs ≈ 1e-7 apart, ``test_rdm_sharded``), and the
    Spearman ranks of the crowded RDMs of a random AlexNet's deep taps
    exchange near-tied entries; one exchange among the 435 entries moves
    a score by up to 12 / (435 · 436) = 6.3e-5, and the run differed by up
    to 3.6e-4 (ROADMAP §3, near-tie sensitivity). ``--procs`` with several
    ranks raises."""
    import visreps_tpu_torch.core.db as tdb
    from visreps_tpu_torch import run as trun
    from visreps_tpu_torch.benchmarks import fixture as tfixture

    meta = tfixture.ensure_fixture(tmp_path / "fx", n_shared=30, n_unique=20, n_subjects=3,
                                   n_regions=2, n_voxels=8, img_size=64)
    env = {"NSD_DATA_DIR": str(Path(meta["pickle"]).parent), "NSD_STIMULI_HDF5": meta["stimuli"],
           "VISREPS_RESULTS_DB": str(tmp_path / "ranks.db")}
    argv = ["--mode", "eval", "--device", "cpu", "--config", str(REPO / "configs/eval/base.json"),
            "--override", "neural_dataset=nsd", "subject_idx=[0,1,2]",
            "region=[early visual stream,ventral visual stream]", "analysis=rsa",
            "compare_method=spearman", "bootstrap=true", "n_bootstrap=8", "n_select=10",
            "batchsize=16", "num_workers=2", "load_model_from=torchvision",
            "model_name=AlexNet", "pretrained_dataset=none", "extract_pre_and_post=true",
            "srp_k=32", "uint8_transfer=true", "log_expdata=true", "seed=1",
            "rdm_shard_threshold=8"]
    outs = run_ranks(tmp_path, 2, "run", {"argv": argv, "env": env, "port": _free_port()})

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tdb, "RESULTS_DB_PATH", tmp_path / "single.db")
    single = trun.main(argv)
    want = [{k: r[k] for k in ("layer", "score", "ci_low", "ci_high")} for r in single]
    assert outs[0] == outs[1]
    assert [r["layer"] for r in outs[0]] == [r["layer"] for r in want]
    for got, ref in zip(outs[0], want):
        np.testing.assert_allclose([got["score"], got["ci_low"], got["ci_high"]],
                                   [ref["score"], ref["ci_low"], ref["ci_high"]], atol=1e-3)
    with sqlite3.connect(str(tmp_path / "ranks.db")) as conn:
        rows = conn.execute("SELECT run_id, layer, score FROM results ORDER BY rowid").fetchall()
    assert len(rows) == len(want) == 6 and len({r[0] for r in rows}) == 6
    assert [(r[1], r[2]) for r in rows] == [(o["layer"], o["score"]) for o in outs[0]]

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--procs 2"):
        trun.main(argv[:1] + ["eval", "--procs", "2"] + argv[2:])


def test_tensor_parallel_forward(tmp_path):
    """``shard_params_tp`` on a 2 × 2 mesh: CustomCNN's fc1 and fc2 weights
    and biases split in half along their outputs on 'model' (everything
    else replicated), and the eval-mode forward's logits equal the JAX
    package's replicated forward within 1e-4, as ``test_sharding.py``'s
    TP forward holds them."""
    import jax.numpy as jnp

    from visreps_tpu.models.zoo import init_model as jax_init_model
    from visreps_tpu_torch.models.convert import params_from_jax

    state = jax_init_model("CustomCNN", 16, seed=0, input_size=64)
    x = np.random.RandomState(5).randn(4, 64, 64, 3).astype(np.float32)
    want, _ = state.module.apply(state.variables, jnp.asarray(x), train=False, capture=())
    outs = run_ranks(tmp_path, 4, "tp", {"state": params_from_jax(state.params, state.batch_stats),
                                        "x": x})
    for out in outs:
        assert out["sharded"] == ["fc1.fc.bias", "fc1.fc.weight", "fc2.fc.bias", "fc2.fc.weight"]
        assert out["local"] == {"fc1.fc.bias": (2048,), "fc1.fc.weight": (2048, 2304),
                                "fc2.fc.bias": (2048,), "fc2.fc.weight": (2048, 4096)}
        np.testing.assert_allclose(out["logits"], np.asarray(want), atol=1e-4)


def test_curriculum_finetuning_on_two_ranks(tmp_path):
    """``curriculum_finetuning``'s CLI as two gloo ranks (64 → 1000,
    late_layers, one epoch) on a small ImageNet layout, the batch size
    one below the train split so the last batch has one row and rank 0's
    piece of it is empty: both ranks report the same losses and
    accuracies (their parameters stay equal: the gradients are averaged),
    and rank 0 alone writes the experiment's files."""
    from visreps_tpu_torch.benchmarks.fixture import write_imagenet_fixture
    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.data.obj_cls import get_obj_cls_loader
    from visreps_tpu_torch.models.custom_cnn import TinyCustomCNN
    from visreps_tpu_torch.train import checkpoint as tckpt

    model = TinyCustomCNN(num_classes=64)
    model.init_weights(torch.Generator().manual_seed(3))
    (tmp_path / "ckpts" / "cfg64a").mkdir(parents=True)
    tckpt.save_checkpoint(str(tmp_path / "ckpts" / "cfg64a"), 20, model, {}, {"seed": 1})
    data = write_imagenet_fixture(tmp_path / "imnet", 20, n_classes=4, pca_n_classes=[2])
    env = {"IMAGENET_DATA_DIR": data["dataset_path"],
           "IMAGENET_LOCAL_DIR": str(Path(data["label_file"]).parent)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        _, loaders = get_obj_cls_loader(Config({"dataset": "imagenet", "batchsize": 4,
                                                "num_workers": 1, "pca_labels": False,
                                                "data_augment": False, "seed": 1}))
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    n_train = len(loaders["train"].dataset)
    out = tmp_path / "out"
    argv = ["--checkpoint-dir", str(tmp_path / "ckpts"), "--transfer-mode", "late_layers",
            "--num-epochs", "1", "--warmup-epochs", "0", "--batch-size", str(n_train - 1),
            "--num-workers", "2", "--output-dir", str(out), "--device", "cpu"]
    outs = run_ranks(tmp_path, 2, "curriculum", {"argv": argv, "env": env, "port": _free_port()})
    assert outs[0] == outs[1]
    assert [r["epoch"] for r in outs[0]] == [0, 1] and np.isfinite(outs[0][1]["train_loss"])
    exp = out / "cfg64_to_1000_late_layers_a"
    assert sorted(p.name for p in exp.iterdir()) == [
        "checkpoint_epoch_0.pth", "checkpoint_epoch_1.pth", "config.json", "metrics.csv"]
