"""The PyTorch port's coarse-grain-benefit experiments against the JAX
package's (``experiments/coarse_grain_benefits/``), on the CPU, on seeded
inputs at toy sizes (a TinyCustomCNN checkpoint, 64 px images).

Tolerances: one tap's features 1e-4 of the largest value (convolution
sums in other orders); deterministic corruptions 1e-3 on the 0–255
scale; the ridge probe's and the few-shot episodes' predictions exactly;
class selectivity 1e-6; the logistic probe against sklearn: ≥ 99 % of
predictions equal and coefficients within 1e-3; learning rates 1e-7;
curriculum RSA scores 1e-5 on the same activations (the port's own SRP
store against the JAX one at rtol 1e-2: ~1e-6 tap differences move
bf16-rounded SRP inputs, as in ``test_torch_port_e2e.py``).
"""
import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import visreps_tpu.data.neural as jneural  # noqa: E402
from experiments.coarse_grain_benefits import class_selectivity as jsel  # noqa: E402
from experiments.coarse_grain_benefits import corruptions as jcorr  # noqa: E402
from experiments.coarse_grain_benefits import curriculum_finetuning as jcur  # noqa: E402
from experiments.coarse_grain_benefits import curriculum_nsd_rsa as jrsa  # noqa: E402
from experiments.coarse_grain_benefits import few_shot as jfew  # noqa: E402
from experiments.coarse_grain_benefits import imagenet_c_robustness as jimc  # noqa: E402
from experiments.coarse_grain_benefits import utils as jutils  # noqa: E402
from visreps_tpu.benchmarks import fixture as jfixture  # noqa: E402
from visreps_tpu.core.config import Config as JaxConfig  # noqa: E402
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor  # noqa: E402
from visreps_tpu.ops.ridge import ridge_cv as jax_ridge_cv  # noqa: E402
from visreps_tpu.ops.srp import SRPTransform as JaxSRP  # noqa: E402
from visreps_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from visreps_tpu.train.optim import _trainable_labels, make_schedule  # noqa: E402

import visreps_tpu_torch.models.extractor as textractor  # noqa: E402
from visreps_tpu_torch.benchmarks.fixture import (  # noqa: E402
    write_imagenet_fixture,
    write_tiny_imagenet_fixture,
)
from visreps_tpu_torch.experiments.coarse_grain_benefits import (  # noqa: E402
    augmentation_invariance as taug,
    class_selectivity as tsel,
    corruptions as tcorr,
    curriculum_finetuning as tcur,
    curriculum_nsd_rsa as trsa,
    few_shot as tfew,
    imagenet_c_robustness as timc,
    linear_probe as tlin,
    utils as tutils,
)
from visreps_tpu_torch.models.convert import params_from_jax, srp_from_jax  # noqa: E402
from visreps_tpu_torch.models.custom_cnn import TinyCustomCNN  # noqa: E402
from visreps_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from visreps_tpu_torch.train.trainer import train_step  # noqa: E402

FEAT_TOL = 1e-4
CORRUPT_TOL = 1e-3
SEL_TOL = 1e-6
COEF_TOL = 1e-3
LR_TOL = 1e-7
RSA_TOL = 1e-5
DETERMINISTIC = ["brightness", "contrast", "pixelate", "defocus_blur", "zoom_blur",
                 "jpeg_compression"]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """``cfg64a/checkpoint_epoch_20.pth``: a seeded 64-class TinyCustomCNN
    with non-trivial BatchNorm statistics, in the checkpoint format both
    packages read."""
    root = tmp_path_factory.mktemp("ckpts")
    model = TinyCustomCNN(num_classes=64)
    gen = torch.Generator().manual_seed(3)
    model.init_weights(gen)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=gen)
    (root / "cfg64a").mkdir()
    tckpt.save_checkpoint(str(root / "cfg64a"), 20, model, {}, {"seed": 1})
    return root


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    return write_tiny_imagenet_fixture(tmp_path_factory.mktemp("tiny"), n_classes=4,
                                       n_train=6, n_val=4)


def _clusters(n_per: int, n_classes: int, d: int, seed: int):
    """Class-clustered features and their labels."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(n_classes, d) * 2
    labels = np.repeat(np.arange(n_classes), n_per)
    feats = centres[labels] + rng.randn(len(labels), d)
    return np.abs(feats).astype(np.float32), labels


class TestUtils:
    def test_configs(self):
        assert tutils.get_model_configs([2, 64], [1, 2], True) == jutils.get_model_configs(
            [2, 64], [1, 2], True)
        assert tutils.get_config_name(64, 2) == jutils.get_config_name(64, 2) == "cfg64b"

    def test_load_and_extract(self, ckpt_dir):
        """``load_model_by_config`` finds the checkpoint; one tap's features
        against the JAX module's jitted extraction of the same file."""
        model = tutils.load_model_by_config(64, 1, str(ckpt_dir),
                                            "checkpoint_epoch_20.pth", device="cpu")
        state = jutils.load_model_by_config(64, 1, str(ckpt_dir), "checkpoint_epoch_20.pth")
        x = np.random.RandomState(0).randn(6, 64, 64, 3).astype(np.float32)
        loader = [(x[:4], None), (x[4:], None)]
        for layer, post in (("conv3", True), ("fc1", False)):
            want = jutils.extract_features(state, loader, layer, post)
            got = tutils.extract_features(model, loader, layer, post, device="cpu")
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= FEAT_TOL * np.abs(want).max()


class TestCorruptions:
    @pytest.fixture(scope="class")
    def images(self):
        return np.random.RandomState(1).randint(0, 256, (3, 48, 48, 3)).astype(np.uint8)

    @pytest.mark.parametrize("name", DETERMINISTIC)
    def test_deterministic_equal_jax(self, images, name):
        want = jcorr.corrupt_batch(name, images, severity=3, seed=0)
        got = tcorr.corrupt_batch(name, images, severity=3, seed=0, device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=CORRUPT_TOL)

    @pytest.mark.parametrize("name", sorted(set(tcorr.CORRUPTIONS) - set(DETERMINISTIC)))
    def test_random_shape_range_seeded(self, images, name):
        a = tcorr.corrupt_batch(name, images, severity=3, seed=5, device="cpu")
        b = tcorr.corrupt_batch(name, images, severity=3, seed=5, device="cpu")
        assert a.shape == images.shape and a.dtype == torch.float32
        assert float(a.min()) >= 0.0 and float(a.max()) <= 255.0
        assert torch.equal(a, b)
        assert set(tcorr.CORRUPTIONS) == set(jcorr.CORRUPTIONS)


class TestProbes:
    def test_ridge_probe_predictions(self):
        """The linear probe's readout against the JAX ``ridge_cv`` path."""
        x, y = _clusters(20, 5, 24, seed=0)
        x_te, _ = _clusters(6, 5, 24, seed=1)
        one_hot = np.eye(5, dtype=np.float32)[y]
        want = np.asarray(jax_ridge_cv(jax.numpy.asarray(x), jax.numpy.asarray(one_hot))
                          .predict(jax.numpy.asarray(x_te))).argmax(1)
        got = tlin.ridge_probe(torch.from_numpy(x), y, torch.from_numpy(x_te), 5).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("k", [1, 3])
    def test_few_shot_episodes_equal(self, k):
        x, y = _clusters(8, 6, 16, seed=2)
        y[:3] = 5  # class sizes differ: some classes are skipped at larger k
        want = jfew.few_shot_episodes(x, y, k, n_episodes=5, seed=0)
        got = tfew.few_shot_episodes(torch.from_numpy(x), y, k, n_episodes=5, seed=0)
        assert got == want

    def test_class_selectivity(self):
        x, y = _clusters(10, 4, 32, seed=3)
        x[:, :4] = 0.0  # dead units: the zero-denominator rule
        want = jsel.class_selectivity(x, y)
        got = tsel.class_selectivity(torch.from_numpy(x), y).numpy()
        np.testing.assert_allclose(got, want, atol=SEL_TOL)

    def test_logistic_probe_against_sklearn(self):
        """The JAX module's sklearn pipeline against the torch L-BFGS probe,
        on float32 features as the pipeline gives them."""
        x, y = _clusters(40, 4, 12, seed=4)
        x = x + np.random.RandomState(5).randn(*x.shape).astype(np.float32) * 2
        x_te, y_te = _clusters(15, 4, 12, seed=6)
        scaler, clf = jimc.fit_probe(x, y)
        probe = timc.fit_probe(torch.from_numpy(x), y)
        want = clf.predict(scaler.transform(x_te))
        got = probe.predict(torch.from_numpy(x_te)).numpy()
        assert (got == want).mean() >= 0.99
        np.testing.assert_allclose(probe.coef.numpy(), clf.coef_, atol=COEF_TOL)
        assert probe.score(torch.from_numpy(x_te), y_te) == pytest.approx(
            clf.score(scaler.transform(x_te), y_te))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: under a parallel test run every
    worker's default of one thread per core oversubscribes the machine,
    and the probes' d × d eighs then wait on descheduled threads (two
    linear-probe runs took 2,025 s in each of 6 concurrent processes,
    21 s with one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _linear_probe(common, tmp_path, ckpt_dir, tiny_tree):
    top1 = tlin.main(common)
    assert 0.0 <= top1 <= 100.0


def _few_shot(common, tmp_path, ckpt_dir, tiny_tree):
    shots = tfew.main([*common, "--k-shot", "1", "2", "--episodes", "3"])
    assert set(shots) == {1, 2} and all(np.isfinite(v).all() for v in shots.values())


def _selectivity(common, tmp_path, ckpt_dir, tiny_tree):
    # fc taps only: SRP of a conv tap at 224 px would build a matrix of GBs here
    sel = tsel.main([*common, "--layers", "fc1_post", "fc2_post"])
    assert set(sel) == {"fc1_post", "fc2_post"}
    assert all(((s >= 0) & (s <= 1)).all() for s in sel.values())


def _invariance(common, tmp_path, ckpt_dir, tiny_tree):
    inv = taug.main([*common[:-2], "--batch-size", "4", "--max-batches", "2",
                     "--layers", "fc1", "fc2"])
    assert set(inv) == {"fc1_pre", "fc1_post", "fc2_pre", "fc2_post"}
    assert all(len(v) == 8 and np.isfinite(v).all() for v in inv.values())


def _imagenet_c(common, tmp_path, ckpt_dir, tiny_tree):
    rows = timc.main(["--checkpoints", f"m={ckpt_dir}/cfg64a/checkpoint_epoch_20.pth",
                      "--probe-dataset", f"{tiny_tree}/train", "--n-images", "24",
                      "--image-size", "64", "--corruptions", "gaussian_noise", "pixelate",
                      "--out", str(tmp_path / "c.csv"), "--device", "cpu"])
    assert [r["corruption"] for r in rows] == ["gaussian_noise", "pixelate"]
    assert len((tmp_path / "c.csv").read_text().splitlines()) == 3


class TestCLIs:
    @pytest.mark.parametrize("run", [_linear_probe, _few_shot, _selectivity, _invariance,
                                     _imagenet_c],
                             ids=["linear_probe", "few_shot", "selectivity", "invariance",
                                  "imagenet_c"])
    def test_benefit_mains(self, run, ckpt_dir, tiny_tree, tmp_path):
        """Each benefit CLI of the port end to end on the CPU."""
        common = ["--checkpoint-dir", str(ckpt_dir), "--cfg-id", "64",
                  "--probe-dataset", tiny_tree, "--device", "cpu", "--batch-size", "8"]
        run(common, tmp_path, ckpt_dir, tiny_tree)


class TestCurriculum:
    def test_lr_per_step(self):
        """The warm-up + cosine table read per step, against optax's schedule."""
        args = type("A", (), {"learning_rate": 0.002, "weight_decay": 1e-4,
                              "num_epochs": 3, "warmup_epochs": 1})()
        model = tcur.replace_classifier_head(TinyCustomCNN(num_classes=8), 10, "full", 1)
        optimizer = tcur.finetune_optimizer(model, args, steps_per_epoch=4)
        schedule = make_schedule(JaxConfig({"learning_rate": 0.002, "num_epochs": 3,
                                            "warmup_epochs": 1,
                                            "lr_scheduler": "cosineannealinglr"}), 4)
        for step in range(16):
            assert optimizer.lr_at_step(step) == pytest.approx(float(schedule(step)), abs=LR_TOL)

    @pytest.mark.parametrize("mode", list(jcur.TRANSFER_MODES))
    def test_frozen_parameters(self, ckpt_dir, mode):
        """With the JAX-initialised head carried across, one train step
        changes exactly the parameters the JAX optax mask trains; the
        source's other weights are kept."""
        path = ckpt_dir / "cfg64a" / "checkpoint_epoch_20.pth"
        jstate = jcur.replace_classifier_head(jax_load_checkpoint(str(path))[0], 10, mode, 1)
        labels = _trainable_labels(jstate.params, jstate.module.trainable_mask())
        trained = {name for name, sub in labels.items()
                   if set(jax.tree_util.tree_leaves(sub)) == {"train"}}
        source, _ = tckpt.load_checkpoint(path, device="cpu")
        model = tcur.replace_classifier_head(source, 10, mode, 1)
        head = params_from_jax({"fc3": jax.tree_util.tree_map(np.asarray, jstate.params["fc3"])})
        model.load_state_dict({**model.state_dict(), **head})
        assert torch.equal(model.conv1.conv.weight, source.conv1.conv.weight)
        args = type("A", (), {"learning_rate": 0.01, "weight_decay": 1e-4, "num_epochs": 2,
                              "warmup_epochs": 0})()
        optimizer = tcur.finetune_optimizer(model, args, steps_per_epoch=1)
        before = {k: v.clone() for k, v in model.named_parameters()}
        x = torch.from_numpy(np.random.RandomState(7).randn(4, 3, 64, 64).astype(np.float32))
        train_step(model, optimizer, x, torch.tensor([0, 3, 5, 9]),
                   torch.Generator().manual_seed(0), 0)
        changed = {k.split(".")[0] for k, v in model.named_parameters()
                   if not torch.equal(v, before[k])}
        assert changed == trained

    def test_main(self, ckpt_dir, tmp_path, monkeypatch):
        """64 → 1000 late_layers through the CLI on a small ImageNet layout:
        the experiment's checkpoints, config and metrics CSV."""
        data = write_imagenet_fixture(tmp_path / "imnet", 20, n_classes=4, pca_n_classes=[2])
        monkeypatch.setenv("IMAGENET_DATA_DIR", data["dataset_path"])
        monkeypatch.setenv("IMAGENET_LOCAL_DIR", str(Path(data["label_file"]).parent))
        out = tmp_path / "out"
        results = tcur.main(["--checkpoint-dir", str(ckpt_dir), "--transfer-mode", "late_layers",
                             "--num-epochs", "1", "--warmup-epochs", "0", "--batch-size", "8",
                             "--num-workers", "2", "--output-dir", str(out), "--device", "cpu"])
        exp = out / "cfg64_to_1000_late_layers_a"
        assert [r["epoch"] for r in results] == [0, 1]
        assert all(np.isfinite(r["val_top1"]) for r in results)
        assert np.isfinite(results[1]["train_loss"])
        for f in ("config.json", "metrics.csv", "checkpoint_epoch_0.pth", "checkpoint_epoch_1.pth"):
            assert (exp / f).is_file()
        model, _ = tckpt.load_checkpoint(exp / "checkpoint_epoch_1.pth", device="cpu")
        assert model.num_classes == 1000 and model.conv_trainable == "00001"


TINY_NSD = {"N_SHARED": 12, "N_UNIQUE": 20, "N_SUBJECTS": 2, "REGIONS": ["early", "ventral"],
            "N_VOXELS": 8, "N_STIMULI": 12 + 2 * 20, "IMG_SIZE": 64}
SRP_K = 64


@pytest.fixture(scope="module")
def nsd(tmp_path_factory):
    """The JAX package's tiny HDF5 NSD fixture (as in test_torch_port_e2e),
    its pixels overwritten with 4 × 4 colour blocks so the RDMs spread."""
    import h5py

    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("nsd")
    try:
        mp.setattr(jfixture, "FIXTURE_DIR", tmp / "fx")
        mp.setattr(jfixture, "N_JPEG", 1)
        for k, v in TINY_NSD.items():
            mp.setattr(jfixture, k, v)
        meta = jfixture.ensure_fixture()
        with h5py.File(meta["hdf5"], "r+") as f:
            brick = f["imgBrick"]
            n, h, w, _ = brick.shape
            colours = np.random.RandomState(7).randint(0, 256, (n, 4, 4, 3)).astype(np.uint8)
            brick[...] = np.kron(colours, np.ones((1, h // 4, w // 4, 1), np.uint8))
        mp.setenv("NSD_DATA_DIR", str(Path(meta["pickle"]).parent))
        mp.setenv("NSD_STIMULI_HDF5", meta["hdf5"])
        mp.setattr(jneural, "NSD_STIMULI_HDF5", meta["hdf5"])
        yield meta
    finally:
        mp.undo()


class TestCurriculumRSA:
    def test_scores_against_jax(self, nsd, ckpt_dir, monkeypatch):
        """Per-(region, subject, layer) rows against the JAX module's
        ``score_model`` on one checkpoint: the port's SRP store (the JAX
        SRP matrices carried across) at rtol 1e-2, and the port's scoring
        of the JAX store within 1e-5."""
        path = str(ckpt_dir / "cfg64a" / "checkpoint_epoch_20.pth")
        stores = {"jax": [], "torch": []}
        jax_get = JaxExtractor.get_activations

        def keep_jax(self, *args, **kwargs):
            acts, ids = jax_get(self, *args, **kwargs)
            stores["jax"].append(({n: np.asarray(a, np.float32) for n, a in acts.items()},
                                  list(ids)))
            return acts, ids

        class WithJaxSRP(textractor.FeatureExtractor):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                jsrp = JaxSRP(k=SRP_K, seed=0)
                srp_from_jax(self.srp, {d: tuple(np.asarray(c, np.float32)
                                                 for c in jsrp.matrix_chunks(d))
                                        for d in set(self.tap_dims.values())})

            def get_activations(self, *args, **kwargs):
                acts, ids = super().get_activations(*args, **kwargs)
                stores["torch"].append((acts, ids))
                return acts, ids

        monkeypatch.setattr(JaxExtractor, "get_activations", keep_jax)
        monkeypatch.setattr(textractor, "FeatureExtractor", WithJaxSRP)
        want = jrsa.score_model(path, [0, 1], "spearman", 20, 2, SRP_K)
        got = trsa.score_model(path, [0, 1], "spearman", 20, 2, SRP_K, device="cpu")
        key = [(r["region"], r["subject_idx"], r["layer"]) for r in want]
        assert [(r["region"], r["subject_idx"], r["layer"]) for r in got] == key
        assert len(key) == 2 * 2 * len(trsa.LAYERS)
        assert all(np.isfinite(r["score"]) for r in got)
        rescored = []
        for subject, ((jacts, jids), (tacts, tids)) in enumerate(zip(stores["jax"],
                                                                     stores["torch"])):
            assert [str(i) for i in tids] == [str(i) for i in jids] and len(jids) == 20
            for name, ref in jacts.items():
                np.testing.assert_allclose(tacts[name].numpy(), ref, rtol=1e-2,
                                           atol=1e-2 * np.abs(ref).max(), err_msg=name)
            rescored += trsa.score_layers({n: torch.from_numpy(a) for n, a in jacts.items()},
                                          jids, subject, "spearman")
        np.testing.assert_allclose([r["score"] for r in rescored], [r["score"] for r in want],
                                   atol=RSA_TOL)

    def test_main_csv(self, nsd, ckpt_dir, tmp_path):
        path = ckpt_dir / "cfg64a" / "checkpoint_epoch_20.pth"
        rows = trsa.main(["--checkpoints", f"a={path}", "--subjects", "1",
                          "--srp-k", str(SRP_K), "--batch-size", "8", "--num-workers", "2",
                          "--out-dir", str(tmp_path), "--device", "cpu"])
        with open(tmp_path / "curriculum_nsd_rsa.csv") as f:
            written = list(csv.DictReader(f))
        assert len(rows) == len(written) == 2 * len(trsa.LAYERS)
        assert {r["model_name"] for r in written} == {"a"}
