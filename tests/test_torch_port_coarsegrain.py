"""The PyTorch port's PCA-label pipeline against the JAX package's scripts,
on the CPU: source-model feature extraction (``scripts/
extract_representations/``), the covariance eigenvectors and the
median-split labels (``scripts/coarsegrain/``), each held to the JAX
script on the same seeded inputs.

Tolerances: eigenvalues, mean and total variance 1e-5 relative and
eigenvectors |cos| ≥ 1 − 1e-5 (both fits accumulate in float32);
labels exactly, CSVs byte for byte; AlexNet ``fc2_post`` and ViT
``block12`` CLS features 1e-4 of the largest value (XLA and PyTorch sum
convolutions in other orders); the CLIP resize and the towers'
extraction 1e-5 (values O(1)).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from scripts.coarsegrain import compute_eigenvectors as jeig  # noqa: E402
from scripts.coarsegrain import make_pca_labels as jlabels  # noqa: E402
from scripts.extract_representations import alexnet_representations as jalex  # noqa: E402
from scripts.extract_representations import clip_representations as jclip  # noqa: E402
from scripts.extract_representations import dino_representations as jdino  # noqa: E402
from visreps_tpu.data import obj_cls as jobj  # noqa: E402
from visreps_tpu.models import hf_vit as jhf  # noqa: E402
from visreps_tpu.models.vit import ViTBase as JaxViT  # noqa: E402
from visreps_tpu.models.standard import AlexNet as JaxAlexNet  # noqa: E402
from visreps_tpu.models.zoo import ModelState  # noqa: E402

from visreps_tpu_torch.benchmarks.fixture import write_imagenet_fixture  # noqa: E402
from visreps_tpu_torch.data import obj_cls as tobj  # noqa: E402
from visreps_tpu_torch.models import hf_vit as thf  # noqa: E402
from visreps_tpu_torch.models import zoo as tzoo  # noqa: E402
from visreps_tpu_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from visreps_tpu_torch.models.standard import AlexNet  # noqa: E402
from visreps_tpu_torch.models.vit import ViTBase  # noqa: E402
from visreps_tpu_torch.ops.resize import resize  # noqa: E402
from visreps_tpu_torch.scripts.coarsegrain import compute_eigenvectors as teig  # noqa: E402
from visreps_tpu_torch.scripts.coarsegrain import make_pca_labels as tlabels  # noqa: E402
from visreps_tpu_torch.scripts.extract_representations import (  # noqa: E402
    alexnet_representations as talex,
    clip_representations as tclip,
    dino_representations as tdino,
    vit_representations as tvit,
)

EIG_TOL = 1e-5
FEAT_TOL = 1e-4
TOWER_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gapped_features(n: int, d: int = 64, seed: int = 0) -> np.ndarray:
    """(n, d) float32 rows with a gapped spectrum (variances 4·0.85^i in a
    random basis) around a mean of 0.5. Float32 roundoff in a fit is
    about eps · the largest eigenvalue, so the top 20 span only ~25×
    for a 1e-5 relative comparison to mean something."""
    rng = np.random.RandomState(seed)
    basis, _ = np.linalg.qr(rng.randn(d, d))
    scales = 2.0 * 0.85 ** (np.arange(d) / 2)
    return (0.5 + (rng.randn(n, d) * scales) @ basis.T).astype(np.float32)


def _eigen_npz(feats: np.ndarray, tmp: Path, name: str, top_k: int = 20):
    np.savez(tmp / f"{name}_feats.npz", features=feats,
             image_ids=np.asarray([f"img{i:04d}.JPEG" for i in range(len(feats))]))
    jeig.main(["--features", str(tmp / f"{name}_feats.npz"), "--out", str(tmp / f"{name}_jax.npz"),
               "--top-k", str(top_k), "--batch-size", "128"])
    teig.main(["--features", str(tmp / f"{name}_feats.npz"),
               "--out", str(tmp / f"{name}_torch.npz"), "--top-k", str(top_k),
               "--batch-size", "128", "--device", "cpu"])
    return np.load(tmp / f"{name}_jax.npz"), np.load(tmp / f"{name}_torch.npz")


class TestEigenvectors:
    def test_against_jax_script(self, tmp_path):
        jax_eig, torch_eig = _eigen_npz(gapped_features(600), tmp_path, "g")
        assert set(torch_eig.files) == set(jax_eig.files) == {
            "eigenvectors", "eigenvalues", "mean", "total_variance"}
        for key in ("eigenvalues", "mean", "total_variance"):
            np.testing.assert_allclose(torch_eig[key], jax_eig[key], rtol=EIG_TOL, err_msg=key)
        cos = np.abs((torch_eig["eigenvectors"] * jax_eig["eigenvectors"]).sum(axis=0))
        assert torch_eig["eigenvectors"].shape == (64, 20)
        assert cos.min() >= 1 - EIG_TOL


class TestLabels:
    @pytest.mark.parametrize("case", ["even", "odd", "ties"])
    def test_pca_bit_labels_equal(self, tmp_path, case):
        """The JAX script's eigenvectors carried across; labels equal for
        an even and an odd count, and with tied projections (repeated
        rows put exact ties at the medians)."""
        feats = gapped_features(601 if case == "odd" else 600)
        if case == "ties":
            feats = np.repeat(feats[:150], 4, axis=0)
        jax_eig, _ = _eigen_npz(feats, tmp_path, case, top_k=6)
        for n_bits in range(1, 7):
            want = jlabels.pca_bit_labels(feats, jax_eig["eigenvectors"], jax_eig["mean"], n_bits)
            got = tlabels.pca_bit_labels(feats, jax_eig["eigenvectors"], jax_eig["mean"], n_bits,
                                         device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)

    def test_np_median(self):
        x = torch.from_numpy(np.random.RandomState(1).randn(10, 3).astype(np.float32))
        for n in (9, 10):
            np.testing.assert_array_equal(tlabels.np_median(x[:n]).numpy(),
                                          np.median(x[:n].numpy(), axis=0))

    def test_csvs_byte_identical_and_read_alike(self, tmp_path):
        """Both scripts' CSVs from the same features and eigenvectors are
        byte-identical; the JAX package's pandas PCADataset and the port's
        csv reader read the port's CSVs to the same labels."""
        data = write_imagenet_fixture(tmp_path / "imnet", 64, n_classes=8, pca_n_classes=[2])
        ids = sorted(p.name for p in Path(data["dataset_path"]).rglob("*.JPEG"))
        feats = gapped_features(len(ids))
        np.savez(tmp_path / "f.npz", features=feats, image_ids=np.asarray(ids))
        jeig.main(["--features", str(tmp_path / "f.npz"), "--out", str(tmp_path / "e.npz")])
        args = ["--features", str(tmp_path / "f.npz"), "--eigen", str(tmp_path / "e.npz")]
        jlabels.main([*args, "--out-dir", str(tmp_path / "jax")])
        tlabels.main([*args, "--out-dir", str(tmp_path / "torch"), "--device", "cpu"])
        for n_bits in range(1, 7):
            name = f"n_classes_{2 ** n_bits}.csv"
            assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        csv_path = str(tmp_path / "torch" / "n_classes_64.csv")
        jds = jobj.PCADataset(jobj.ImageNetDataset(data["dataset_path"], "all",
                                                   label_file=data["label_file"]), csv_path, 64)
        tds = tobj.PCADataset(tobj.ImageNetDataset(data["dataset_path"], "all",
                                                   label_file=data["label_file"]), csv_path, 64)
        assert len(tds.samples) == len(jds.samples) == 64
        assert [s[1:] for s in tds.samples] == [s[1:] for s in jds.samples]

    def test_pipeline_up_to_eigenvector_signs(self, tmp_path):
        """Each package's own fit, then its own labels: equal up to the XOR
        mask of the bits whose eigenvectors came out with opposite signs.
        Both CPU fits here return the same signs, so the port's fit is also
        taken with PCs 1 and 3 negated, as another eigh may return them."""
        feats = gapped_features(600, seed=3)
        jax_eig, torch_eig = _eigen_npz(feats, tmp_path, "p", top_k=6)
        flipped = torch_eig["eigenvectors"] * np.asarray([-1, 1, -1, 1, 1, 1], np.float32)
        for vecs in (torch_eig["eigenvectors"], flipped):
            signs = np.sign((jax_eig["eigenvectors"] * vecs).sum(axis=0))
            for n_bits in range(1, 7):
                want = jlabels.pca_bit_labels(feats, jax_eig["eigenvectors"], jax_eig["mean"],
                                              n_bits)
                got = tlabels.pca_bit_labels(feats, vecs, torch_eig["mean"], n_bits,
                                             device="cpu").numpy()
                mask = sum(1 << (n_bits - 1 - j) for j in range(n_bits) if signs[j] < 0)
                np.testing.assert_array_equal(got ^ mask, want)


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    """A 24-image ImageNet layout and its environment for the scripts."""
    root = tmp_path_factory.mktemp("imnet")
    data = write_imagenet_fixture(root, 24, n_classes=6, pca_n_classes=[2])
    return data


class TestExtraction:
    def test_alexnet_script(self, imagenet, tmp_path, monkeypatch):
        """Both scripts end to end on the same images and weights: the same .npz keys, ids in the same order,
        and ``fc2_post`` within 1e-4 of the largest value."""
        monkeypatch.setenv("IMAGENET_DATA_DIR", imagenet["dataset_path"])
        monkeypatch.setenv("IMAGENET_LOCAL_DIR", str(Path(imagenet["label_file"]).parent))
        monkeypatch.delenv("TORCH_WEIGHTS_DIR", raising=False)
        seeded = AlexNet()  # the port's seeded init, carried into the JAX script
        seeded.init_weights(torch.Generator().manual_seed(0))
        params, _ = params_to_jax(seeded.state_dict())
        monkeypatch.setattr(jalex, "init_model", lambda name, num_classes, seed=0: ModelState(
            module=JaxAlexNet(num_classes=num_classes), params=params))
        monkeypatch.setattr(tzoo, "init_model",
                            lambda name, num_classes, seed=0, device=None, arch=None:
                            seeded.to(device).eval())
        jalex.main(["--out", str(tmp_path / "jax.npz"), "--batch-size", "16"])
        talex.main(["--out", str(tmp_path / "torch.npz"), "--batch-size", "16", "--device", "cpu"])
        want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "torch.npz")
        assert set(got.files) == set(want.files) == {"features", "image_ids"}
        assert list(got["image_ids"]) == list(want["image_ids"])
        assert len(got["image_ids"]) == 24 and got["features"].dtype == np.float32
        ref = want["features"]
        assert got["features"].shape == ref.shape == (24, 4096)
        assert np.abs(got["features"] - ref).max() <= FEAT_TOL * np.abs(ref).max()

    def test_vit_block12_cls(self):
        """``--backend flax``'s forward (block12's CLS) on a narrow ViT at
        64 px, the port's seeded weights carried into the JAX module (a
        flax init of 12 blocks takes seconds)."""
        kw = dict(hidden_dim=32, num_layers=12, num_heads=4, mlp_dim=64)
        model = ViTBase(num_classes=10, image_size=64, **kw)
        model.init_weights(torch.Generator().manual_seed(0))
        params, _ = params_to_jax(model.state_dict(), model.num_heads)
        x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
        fwd = jax.jit(lambda p, x: JaxViT(num_classes=10, **kw).apply(
            {"params": p}, x, train=False, capture=("block12",))[1]["block12"][:, 0])
        want = np.asarray(fwd(params, jnp.asarray(x)))
        got = tvit.build_extract(model.eval(), torch.device("cpu"))(x).numpy()
        assert got.shape == (2, 32)
        assert np.abs(got - want).max() <= FEAT_TOL * np.abs(want).max()


SMALL = dict(hidden=32, num_layers=2, heads=4, mlp_dim=64, patch=16)


def _tower(kind: str, image_size: int = 32):
    jmod = (jhf.CLIPVisionTower(**SMALL, projection_dim=24) if kind == "clip"
            else jhf.DINOv2Tower(**SMALL))
    x = np.zeros((1, image_size, image_size, 3), np.float32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)["params"]
    params = jax.tree_util.tree_map(  # no parameter left at its trivial init
        lambda p: p + 0.05 * np.random.RandomState(p.size % 97).randn(*p.shape).astype(p.dtype),
        params)
    tmod = (thf.CLIPVisionTower(**SMALL, projection_dim=24, image_size=image_size)
            if kind == "clip" else thf.DINOv2Tower(**SMALL, image_size=image_size))
    tmod.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jmod, params, tmod.eval()


class TestTowers:
    @pytest.mark.parametrize("size", [48, 24], ids=["downsample", "upsample"])
    def test_clip_resize(self, size):
        """The CLIP script's bilinear resize against ``jax.image.resize``."""
        x = np.random.RandomState(2).randn(2, size, size, 3).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 32, 32, 3), method="bilinear"))
        got = resize(torch.from_numpy(x).permute(0, 3, 1, 2), (2, 3, 32, 32), "bilinear")
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=TOWER_TOL)

    @pytest.mark.parametrize("size", [48, 24], ids=["downsample", "upsample"])
    def test_clip_extract(self, size):
        """Renormalise → resize → tower → L2 norm against the JAX script's
        jitted program, on a small tower at 32 px."""
        jmod, params, tower = _tower("clip")
        x = np.random.RandomState(3).randn(2, size, size, 3).astype(np.float32)
        want = jclip.build_extract_jax(jmod, params, 32)(x)
        got = tclip.build_extract(tower, 32, torch.device("cpu"))(x).numpy()
        assert got.shape == (2, 24)
        np.testing.assert_allclose(got, want, atol=TOWER_TOL)

    def test_dino_extract_resampled_grid(self):
        """The pooled CLS with the position grid resampled from 32 px to
        48 px, against the JAX script's conversion-time resampling."""
        jmod, params, tower = _tower("dino")
        params = dict(params)
        params["pos_embedding"] = jnp.asarray(jhf.interpolate_positions(
            np.asarray(params["pos_embedding"]), (48 // 16) ** 2))
        x = np.random.RandomState(4).randn(2, 48, 48, 3).astype(np.float32)
        want = jdino.build_extract_jax(jmod, params)(x)
        got = tdino.build_extract(tower, torch.device("cpu"), image_size=48)(x).numpy()
        np.testing.assert_allclose(got, want, atol=TOWER_TOL)
