"""The NSD RSA eval of one JAX-written CustomCNN checkpoint in both
packages, on the CPU: each loads the same checkpoint file through its
own ``load_model_from=checkpoint`` path and merges the same config.json.
As in ``tests/test_torch_port_e2e.py``, the port draws its own SRP store
(checked at rtol 1e-2) and then selects on the JAX eval's store with the
JAX SRP matrices, so selection, point and bootstrap scores compare at
1e-4; results.db rows must carry the same cfg_id, epoch and run_id."""
import sqlite3
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import visreps_tpu.core.db as jdb
import visreps_tpu.data.neural as jneural
import visreps_tpu.evals as jevals
from visreps_tpu.benchmarks import fixture as jfixture
from visreps_tpu.core.config import Config as JaxConfig
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor
from visreps_tpu.models.zoo import init_model as jax_init_model
from visreps_tpu.ops.srp import SRPTransform as JaxSRP
from visreps_tpu.train import checkpoint as jckpt

import visreps_tpu_torch.core.db as tdb
import visreps_tpu_torch.evals as tevals
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.models.convert import srp_from_jax

TINY = {"N_SHARED": 12, "N_UNIQUE": 20, "N_SUBJECTS": 2, "REGIONS": ["early", "ventral"],
        "N_VOXELS": 8, "N_STIMULI": 12 + 2 * 20, "IMG_SIZE": 64}
SRP_K = 64
ARCH = {"conv_trainable": "11111", "fc_trainable": "111", "pooling_type": "max", "dropout": 0.5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eval_cfg(cls, checkpoint_dir):
    return cls({
        "mode": "eval", "seed": 1, "neural_dataset": "nsd", "subject_idx": [0, 1],
        "shared_test_subjects": [0, 1],
        "region": ["early visual stream", "ventral visual stream"],
        "analysis": "rsa", "compare_method": "spearman", "bootstrap": True,
        "n_bootstrap": 8, "n_select": 10, "batchsize": 16, "num_workers": 2,
        "load_model_from": "checkpoint", "cfg_id": 32, "checkpoint_dir": str(checkpoint_dir),
        "checkpoint_model": "checkpoint_epoch_2.pth",
        "return_nodes": ["conv1", "conv2", "conv3", "conv4", "conv5", "fc1", "fc2"],
        "extract_pre_and_post": True, "srp_k": SRP_K,
        "uint8_transfer": True, "log_expdata": True, "use_mesh": False,
    })


def _block_images(path):
    """4 × 4 colour blocks in place of pixel noise (see
    tests/test_torch_port_e2e.py: noise crowds deep-layer RDMs)."""
    import h5py

    with h5py.File(path, "r+") as f:
        brick = f["imgBrick"]
        n, h, w, _ = brick.shape
        colours = np.random.RandomState(7).randint(0, 256, (n, 4, 4, 3)).astype(np.uint8)
        brick[...] = np.kron(colours, np.ones((1, h // 4, w // 4, 1), np.uint8))


def _write_jax_checkpoint(root: Path) -> Path:
    """A CustomCNN (32 PCA classes) checkpoint written by the JAX
    package, BN statistics moved off their init values; returns the
    eval's checkpoint_dir."""
    state = jax_init_model("CustomCNN", 32, seed=3, cfg={"arch": ARCH}, cache=False)
    rng = np.random.RandomState(9)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    for name in stats:
        f = stats[name]["bn"]["mean"].shape[0]
        stats[name]["bn"]["mean"] = (0.1 * rng.randn(f)).astype(np.float32)
        stats[name]["bn"]["var"] = rng.uniform(0.5, 2.0, f).astype(np.float32)
    state.batch_stats = stats
    train_cfg = JaxConfig({
        "mode": "train", "seed": 1, "dataset": "imagenet", "pca_labels": True,
        "pca_n_classes": 32, "pca_labels_folder": "pca_labels_alexnet",
        "lr_scheduler": "cosineannealinglr", "model_class": "custom_model",
        "model_name": "CustomCNN", "arch": ARCH, "batchsize": 256,
        "checkpoint_dir": str(root / "ckpt")})
    path, cfg_dict = jckpt.setup_checkpoint_dir(train_cfg, state)
    jckpt.save_checkpoint(path, 2, state, {}, cfg_dict)
    return root / "ckpt"


@pytest.fixture(scope="module")
def both_evals(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("ckpt_eval")
    stores = {}
    try:
        mp.setattr(jfixture, "FIXTURE_DIR", tmp / "fx")
        mp.setattr(jfixture, "N_JPEG", 1)
        for k, v in TINY.items():
            mp.setattr(jfixture, k, v)
        meta = jfixture.ensure_fixture()
        _block_images(meta["hdf5"])
        mp.setenv("NSD_DATA_DIR", str(Path(meta["pickle"]).parent))
        mp.setenv("VISREPS_INIT_CACHE", "0")
        checkpoint_dir = _write_jax_checkpoint(tmp)

        mp.setattr(jneural, "NSD_STIMULI_HDF5", meta["hdf5"])
        mp.setattr(jdb, "RESULTS_DB_PATH", tmp / "jax.db")
        mp.setattr(jevals, "RESULTS_DB_PATH", tmp / "jax.db")
        jax_get_activations = JaxExtractor.get_activations

        def keep_jax_store(self, *args, **kwargs):
            acts, ids = jax_get_activations(self, *args, **kwargs)
            stores["jax"] = ({n: np.asarray(a, np.float32) for n, a in acts.items()}, list(ids))
            return acts, ids

        mp.setattr(JaxExtractor, "get_activations", keep_jax_store)
        jax_results = jevals.eval(_eval_cfg(JaxConfig, checkpoint_dir))

        jax_srp = JaxSRP(k=SRP_K, seed=0)
        configure = tevals.configure_feature_extractor

        def configure_with_jax_srp(cfg, model, device=None, verbose=False):
            ext = configure(cfg, model, device=device, verbose=verbose)
            srp_from_jax(ext.srp, {
                d: tuple(np.asarray(c, np.float32) for c in jax_srp.matrix_chunks(d))
                for d in set(ext.tap_dims.values())})
            own_get_activations = ext.get_activations

            def select_on_jax_store(loader, store="device", retain_ids=None):
                acts, ids = own_get_activations(loader, store=store, retain_ids=retain_ids)
                stores["torch"] = ({n: a.float().cpu().numpy() for n, a in acts.items()}, ids)
                jacts, jids = stores["jax"]
                assert [str(i) for i in ids] == [str(i) for i in jids]
                return {n: torch.from_numpy(jacts[n]).to(acts[n].device, acts[n].dtype)
                        for n in acts}, ids

            ext.get_activations = select_on_jax_store
            return ext

        mp.setattr(tevals, "configure_feature_extractor", configure_with_jax_srp)
        mp.setenv("NSD_STIMULI_HDF5", meta["hdf5"])  # the port reads it per call
        mp.setattr(tdb, "RESULTS_DB_PATH", tmp / "torch.db")
        torch_results = tevals.eval(_eval_cfg(Config, checkpoint_dir), device="cpu")
        yield jax_results, torch_results, tmp, stores
    finally:
        mp.undo()


def _rows(path):
    with sqlite3.connect(str(path)) as conn:
        return sorted(conn.execute(
            "SELECT run_id, cfg_id, epoch, model_name, pca_labels, pca_n_classes, region, "
            "subject_idx FROM results").fetchall())


def _top_two_gap(result) -> float:
    top2 = sorted(e["score"] for e in result["layer_selection_scores"])[-2:]
    return top2[1] - top2[0]


class TestCheckpointEvalParity:
    def test_results_db_rows_match(self, both_evals):
        """Four rows in each results.db with cfg_id 32, epoch 2 (from the
        file name), CustomCNN and the PCA fields of the training config,
        and the same run_ids."""
        jax_results, torch_results, tmp, _ = both_evals
        assert len(torch_results) == len(jax_results) == 4
        trows, jrows = _rows(tmp / "torch.db"), _rows(tmp / "jax.db")
        assert trows == jrows and len(trows) == 4
        assert {r[1:6] for r in trows} == {(32, 2, "CustomCNN", 1, 32)}

    def test_srp_store(self, both_evals):
        jacts, jids = both_evals[3]["jax"]
        tacts, tids = both_evals[3]["torch"]
        assert list(tacts) == list(jacts) and len(tacts) == 14
        assert len(tids) == len(jids) == TINY["N_STIMULI"]
        for name, ref in jacts.items():
            np.testing.assert_allclose(tacts[name], ref, rtol=1e-2,
                                       atol=1e-2 * np.abs(ref).max(), err_msg=name)

    def test_selection_scores(self, both_evals):
        jax_results, torch_results, _, _ = both_evals
        for j, t in zip(jax_results, torch_results):
            js = {e["layer"]: e["score"] for e in j["layer_selection_scores"]}
            ts = {e["layer"]: e["score"] for e in t["layer_selection_scores"]}
            assert list(ts) == list(js) and len(ts) == 14
            np.testing.assert_allclose([ts[l] for l in js], list(js.values()), atol=1e-4)
            if _top_two_gap(j) > 1e-4:
                assert t["layer"] == j["layer"]

    def test_point_and_bootstrap_scores(self, both_evals):
        jax_results, torch_results, _, _ = both_evals
        for j, t in zip(jax_results, torch_results):
            if t["layer"] != j["layer"]:
                assert _top_two_gap(j) <= 1e-4
                continue
            assert t["score"] == pytest.approx(j["score"], abs=1e-4)
            assert len(t["bootstrap_scores"]) == len(j["bootstrap_scores"]) == 8
            np.testing.assert_allclose(t["bootstrap_scores"], j["bootstrap_scores"], atol=1e-4)
            assert t["ci_low"] == pytest.approx(j["ci_low"], abs=1e-4)
            assert t["ci_high"] == pytest.approx(j["ci_high"], abs=1e-4)
