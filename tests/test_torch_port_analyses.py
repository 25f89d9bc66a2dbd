"""The PyTorch port's offline representation analyses against the JAX
package, on the CPU, on numpy-seeded inputs:

  * ``ops/metrics``: all seven functions, with ties, batch dims, both
    output forms and both corrections (1e-5);
  * ``models/pooling.adaptive_avg_pool`` against the JAX one and
    ``nn.AdaptiveAvgPool2d`` (1e-6), and the pooled extractor;
  * ``extract_representations``' three variants on AlexNet with the JAX
    weights and SRP matrices carried across: exact and pooled taps within
    1e-4 of each tap's largest |value|, SRP rows within 1e-2 of it (the
    SRP rounds its input to bf16, and a tap the packages compute ~1e-6
    apart can round to the neighbouring bf16 value); its CLI on an
    ImageNet-layout fixture;
  * eigenspectra (eigenvalues within 1e-5 of the largest), Two-NN
    (ratios 1e-5, IDs 1e-4 relative) and PLSSVD cross-decomposition with
    the JAX Gaussian projections carried across (1e-4).
"""
import csv

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visreps_tpu.analysis import compute_eigenspectra as jeig
from visreps_tpu.analysis import compute_twonn_id as jtwonn
from visreps_tpu.analysis import cross_decomposition as jxdec
from visreps_tpu.analysis.extract_representations import (
    extract_representations as jax_extract,
)
from visreps_tpu.data.loader import make_stimuli_loader as jax_loader
from visreps_tpu.data.transforms import get_transform as jax_transform
from visreps_tpu.models import pooling as jpool
from visreps_tpu.models.zoo import init_model as jax_init_model
from visreps_tpu.ops import metrics as jmetrics
from visreps_tpu.ops.srp import SRPTransform as JaxSRP

from visreps_tpu_torch.analysis import compute_eigenspectra as teig
from visreps_tpu_torch.analysis import compute_twonn_id as ttwonn
from visreps_tpu_torch.analysis import cross_decomposition as txdec
from visreps_tpu_torch.analysis import extract_representations as textract
from visreps_tpu_torch.analysis import metrics as analysis_metrics
from visreps_tpu_torch.data.loader import make_stimuli_loader
from visreps_tpu_torch.data.transforms import get_transform
from visreps_tpu_torch.models import pooling as tpool
from visreps_tpu_torch.models import extractor as textractor
from visreps_tpu_torch.models.convert import params_from_jax, srp_from_jax
from visreps_tpu_torch.models.standard import AlexNet
from visreps_tpu_torch.ops import metrics as tmetrics

METRIC_TOL = 1e-5
TAP_TOL = 1e-4
SRP_TOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(case: str):
    rng = np.random.RandomState(0)
    if case == "ties":  # integer values: many ties, ranked in input order
        return (rng.randint(0, 4, (12, 3)).astype(np.float32),
                rng.randint(0, 3, (12, 3)).astype(np.float32))
    if case == "batched":
        return rng.randn(2, 10, 4).astype(np.float32), rng.randn(2, 10, 4).astype(np.float32)
    if case == "vector":
        return rng.randn(15).astype(np.float32), rng.randn(15).astype(np.float32)
    return rng.randn(20, 5).astype(np.float32), rng.randn(20, 5).astype(np.float32)


class TestMetrics:
    @pytest.mark.parametrize("case", ["plain", "ties", "batched", "vector"])
    @pytest.mark.parametrize("name", ["pearson_r", "spearman_r", "covariance"])
    def test_correlations(self, name, case):
        x, y = _inputs(case)
        jfn, tfn = getattr(jmetrics, name), getattr(tmetrics, name)
        for kwargs in ({}, {"return_diagonal": False}, {"correction": 0}):
            want = np.asarray(jfn(x, y, **kwargs))
            got = tfn(x, y, **kwargs).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=METRIC_TOL, rtol=0, err_msg=str(kwargs))
        np.testing.assert_allclose(tfn(x).numpy(), np.asarray(jfn(x)), atol=METRIC_TOL)

    def test_spearman_ordinal_ties(self):
        x = np.array([[1.0], [1.0], [0.0], [1.0]], np.float32)
        y = np.array([[0.0], [1.0], [2.0], [3.0]], np.float32)
        # ranks of x in stable order: 1, 2, 0, 3 → the JAX package's value
        got = tmetrics.spearman_r(x, y).item()
        assert got == pytest.approx(float(jmetrics.spearman_r(x, y)), abs=METRIC_TOL)
        assert got == pytest.approx(np.corrcoef([1, 2, 0, 3], [0, 1, 2, 3])[0, 1], abs=1e-6)

    def test_r2_score(self):
        rng = np.random.RandomState(1)
        y = rng.randn(32, 4).astype(np.float32)
        y[:, 2] = 1.5  # a zero-variance column (32 rows: its mean is exact in both packages)
        pred = (y + 0.3 * rng.randn(32, 4)).astype(np.float32)
        np.testing.assert_allclose(tmetrics.r2_score(y, pred).numpy(),
                                   np.asarray(jmetrics.r2_score(y, pred)), atol=METRIC_TOL)

    def test_kernel_hsic_cka(self):
        rng = np.random.RandomState(2)
        x = rng.randn(25, 6).astype(np.float32)
        y = (x @ rng.randn(6, 4) + 0.5 * rng.randn(25, 4)).astype(np.float32)
        x2 = rng.randn(7, 6).astype(np.float32)
        np.testing.assert_allclose(tmetrics.linear_kernel(torch.from_numpy(x),
                                                          torch.from_numpy(x2)).numpy(),
                                   np.asarray(jmetrics.linear_kernel(x, x2)), atol=METRIC_TOL)
        kx, ky = x @ x.T, y @ y.T
        np.testing.assert_allclose(tmetrics.hsic(torch.from_numpy(kx), torch.from_numpy(ky)).item(),
                                   float(jmetrics.hsic(kx, ky)), rtol=1e-5)
        np.testing.assert_allclose(tmetrics.cka(x, y).item(), float(jmetrics.cka(x, y)),
                                   atol=METRIC_TOL)
        assert analysis_metrics.cka is tmetrics.cka


class TestPooling:
    @pytest.mark.parametrize("hw,out", [(13, 3), (7, 4), (6, 1), (5, 5)])
    def test_adaptive_avg_pool(self, hw, out):
        x = np.random.RandomState(3).randn(2, hw, hw + 1, 5).astype(np.float32)  # NHWC
        want = np.asarray(jpool.adaptive_avg_pool(jnp.asarray(x), out)).transpose(0, 3, 1, 2)
        t = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        got = tpool.adaptive_avg_pool(t, out)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.numpy(), torch.nn.AdaptiveAvgPool2d(out)(t).numpy(),
                                   atol=1e-6, rtol=0)


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.fixture(scope="module")
def alexnet():
    """JAX AlexNet (seed 1) and the port's AlexNet with its weights, and
    8 noise stimuli at 256 px."""
    state = jax_init_model("AlexNet", 1000, seed=1, cache=False)
    model = AlexNet()
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, state.params)))
    rng = np.random.RandomState(4)
    stimuli = {f"s{i}": rng.randint(0, 256, (256, 256, 3)).astype(np.uint8) for i in range(8)}
    return state, model.eval(), stimuli


def _loaders(stimuli):
    return (jax_loader(stimuli, jax_transform("imgnet"), 4, 2),
            make_stimuli_loader(stimuli, get_transform("imgnet"), 4, 2))


class TestExtractRepresentations:
    NODES = ["conv2", "fc1"]

    def test_exact_taps(self, alexnet):
        state, model, stimuli = alexnet
        jl, tl = _loaders(stimuli)
        want, jids = jax_extract(state, jl, self.NODES, srp_k=0, batch_size=4)
        got, ids = textract.extract_representations(model, tl, self.NODES, srp_k=0, device="cpu")
        assert list(ids) == list(jids)
        assert list(got) == ["conv2_pre", "conv2_post", "fc1_pre", "fc1_post"] == list(want)
        for k in want:
            assert got[k].shape == np.asarray(want[k]).shape
            assert _rel_err(got[k], np.asarray(want[k])) <= TAP_TOL, k

    def test_spatial_pool(self, alexnet):
        state, model, stimuli = alexnet
        jl, tl = _loaders(stimuli)
        want, _ = jax_extract(state, jl, self.NODES, srp_k=0, spatial_pool=True, batch_size=4)
        got, ids = textract.extract_representations(model, tl, self.NODES, srp_k=0,
                                                    spatial_pool=True, device="cpu")
        assert got["conv2"].shape == (8, 192) and got["fc1"].shape == (8, 4096)
        for k in want:
            assert _rel_err(got[k], np.asarray(want[k])) <= TAP_TOL, k

    def test_srp(self, alexnet, monkeypatch):
        state, model, stimuli = alexnet
        jl, tl = _loaders(stimuli)
        want, _ = jax_extract(state, jl, self.NODES, pre_and_post=False, srp_k=32, batch_size=4)
        own = textractor.FeatureExtractor

        def with_jax_srp(*args, **kwargs):
            ext = own(*args, **kwargs)
            jsrp = JaxSRP(k=32, seed=0)
            srp_from_jax(ext.srp, {
                d: tuple(np.asarray(c, np.float32) for c in jsrp.matrix_chunks(d))
                for d in set(ext.tap_dims.values())})
            return ext

        monkeypatch.setattr(textractor, "FeatureExtractor", with_jax_srp)
        got, _ = textract.extract_representations(model, tl, self.NODES, pre_and_post=False,
                                                  srp_k=32, device="cpu")
        assert list(got) == ["conv2", "fc1"]
        for k in want:
            assert got[k].shape == (8, 32) and got[k].dtype == np.float32
            assert _rel_err(got[k], np.asarray(want[k])) <= SRP_TOL, k

    def test_cli_on_imagenet_layout(self, tmp_path):
        from visreps_tpu_torch.benchmarks.fixture import write_imagenet_fixture

        data = write_imagenet_fixture(tmp_path / "imagenet", 6, n_classes=3, pca_n_classes=3)
        out = tmp_path / "feats.npz"
        assert textract.main(["--model", "AlexNet", "--dataset", "imagenet",
                              "--dataset-path", data["dataset_path"],
                              "--label-file", data["label_file"], "--return-nodes", "conv5",
                              "--srp-k", "0", "--spatial-pool", "--batch-size", "4",
                              "--device", "cpu", "--out", str(out)]) == 0
        saved = np.load(out)
        assert sorted(saved.files) == ["conv5", "image_ids"]
        assert saved["conv5"].shape == (6, 256)
        assert list(saved["image_ids"]) == sorted(saved["image_ids"])  # the dataset's order


class TestEigenspectra:
    def test_matches_jax(self):
        x = (np.random.RandomState(5).randn(40, 30) @ np.diag(np.linspace(3, 0.1, 30))).astype(
            np.float32)
        want = jeig.analyze_layer_pca(x)
        got = teig.analyze_layer_pca(x, device="cpu")
        scale = want["eigenvalues"].max()
        np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"], atol=1e-5 * scale,
                                   rtol=0)
        np.testing.assert_allclose(got["explained_variance_ratio"],
                                   want["explained_variance_ratio"], atol=1e-5)
        assert got["effective_dim"] == pytest.approx(want["effective_dim"], rel=1e-5)
        assert got["total_variance"] == pytest.approx(want["total_variance"], rel=1e-5)

    def test_cli(self, tmp_path):
        rng = np.random.RandomState(6)
        np.savez(tmp_path / "f.npz", conv=rng.randn(12, 2, 3, 3).astype(np.float32),
                 ids=np.arange(12), names=np.array(["a", "b"]))
        assert teig.main([str(tmp_path / "f.npz"), "--out-dir", str(tmp_path / "o"),
                          "--device", "cpu"]) == 0
        saved = np.load(tmp_path / "o" / "eigenspectra_f.npz")
        assert sorted(saved.files) == ["conv_effective_dim", "conv_eigenvalues", "conv_evr"]
        assert saved["conv_eigenvalues"].shape == (12,)

    def test_numpy_needs_a_device(self):
        with pytest.raises(ValueError, match="device="):
            teig.analyze_layer_pca(np.zeros((3, 2), np.float32))


def _manifold(n=200, intrinsic=4, ambient=40, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, intrinsic) @ rng.randn(intrinsic, ambient)).astype(np.float32)


class TestTwoNN:
    def test_ratios_match_jax(self):
        x = _manifold()
        want = np.asarray(jtwonn._two_nn_ratios(jnp.asarray(x)))
        got = ttwonn._two_nn_ratios(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_id_and_decimation_match_jax(self):
        x = _manifold()
        assert ttwonn.twoNN_id(x, device="cpu") == pytest.approx(jtwonn.twoNN_id(x), rel=1e-4)
        want = jtwonn.intrinsic_dim_layer(x.reshape(200, 4, 10))
        got = ttwonn.intrinsic_dim_layer(x.reshape(200, 4, 10), device="cpu")
        assert got["n_samples"] == want["n_samples"] == 200
        for k in ("id", "id_half_mean", "id_half_std"):
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
        assert 2.5 < got["id"] < 5.5

    def test_too_few_points(self):
        assert np.isnan(ttwonn.twoNN_id(_manifold(n=8), device="cpu"))

    def test_cli_appends_rows(self, tmp_path):
        np.savez(tmp_path / "f.npz", layer=_manifold(n=60), ids=np.arange(60))
        for _ in range(2):
            assert ttwonn.main([str(tmp_path / "f.npz"), "--out-csv", str(tmp_path / "id.csv"),
                                "--device", "cpu"]) == 0
        rows = list(csv.DictReader(open(tmp_path / "id.csv")))
        assert [r["layer"] for r in rows] == ["layer", "layer"]
        assert float(rows[0]["id"]) == float(rows[1]["id"])


class TestCrossDecomposition:
    @pytest.fixture()
    def planted(self):
        rng = np.random.RandomState(8)
        x = rng.randn(160, 40).astype(np.float32)
        u, _ = np.linalg.qr(rng.randn(40, 40))
        v, _ = np.linalg.qr(rng.randn(30, 30))
        w = u[:, :30] @ np.diag(np.linspace(3.0, 0.1, 30)) @ v.T
        y = (x @ w + 0.5 * rng.randn(160, 30)).astype(np.float32)
        return x, y

    def test_matches_jax_with_its_projections(self, planted, monkeypatch, tmp_path):
        x, y = planted

        def jax_matrix(d, k, seed):
            m = jax.random.normal(jax.random.PRNGKey(seed), (d, k), jnp.float32) / np.sqrt(k)
            return torch.from_numpy(np.array(m))

        monkeypatch.setattr(txdec, "gaussian_matrix", jax_matrix)
        np.testing.assert_allclose(txdec.gaussian_random_projection(torch.from_numpy(x), 20, 3),
                                   jxdec.gaussian_random_projection(x, 20, 3), atol=1e-5)
        want = jxdec.compute_cross_decomposition_alignment(x, y, n_components=5, n_folds=4,
                                                            proj_dim=20, seed=2, tag="t")
        got = txdec.compute_cross_decomposition_alignment(
            x, y, n_components=5, n_folds=4, proj_dim=20, seed=2, tag="t", device="cpu",
            out_pickle=str(tmp_path / "r.pkl"))
        assert got["n_components"] == want["n_components"] == 5 and got["tag"] == "t"
        assert got["mean_cv_correlation"] == pytest.approx(want["mean_cv_correlation"], abs=1e-4)
        np.testing.assert_allclose(got["fold_correlations"], want["fold_correlations"],
                                   atol=1e-4)
        assert got["mean_cv_correlation"] > 0.5
        txdec.compute_cross_decomposition_alignment(x, y, n_components=5, n_folds=4,
                                                    proj_dim=20, device="cpu",
                                                    out_pickle=str(tmp_path / "r.pkl"))
        import pickle

        assert len(pickle.load(open(tmp_path / "r.pkl", "rb"))) == 2

    def test_own_projection(self):
        m = txdec.gaussian_matrix(400, 300, 0)
        assert torch.equal(m, txdec.gaussian_matrix(400, 300, 0))
        assert abs(m.var().item() * 300 - 1.0) < 0.02 and abs(m.mean().item()) < 1e-3
        x = torch.randn(5, 10)
        assert torch.equal(txdec.gaussian_random_projection(x, 20), x)  # d ≤ k: unchanged
