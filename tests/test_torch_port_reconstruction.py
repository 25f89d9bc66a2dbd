"""The PyTorch port's PC-reconstruction sweep, binary-PC RSA and fig. 1's
RSM comparison against the JAX package's
(``experiments/reconstruction_analysis/run_reconstruction.py``,
``experiments/binary_pc_rsa/main.py``,
``experiments/neurips_2025/fig1/model_reps_rsa_comparisons.py``), on
the CPU at toy sizes: one CustomCNN checkpoint written by the JAX
package (its training config sets ``srp_k`` 16, which the sweep's THINGS
store takes), 30 shared NSD test stimuli of block images × 2 subjects ×
8 voxels, 40 THINGS concepts × 3 images, pca_k {1, 3}, 20 bootstraps.

Tolerances: every RDM the sweeps build 1e-4 (the packages' f32 taps
differ by ~1e-6 and their RDM sums by ~2e-6, but the JAX package's f32
SVD rebuilds a (30, 186,624) conv tap up to 3e-5 of its largest value
away from the port's f64 Gram eigh: RDMs observed up to 3.1e-5 apart
there, 2.4e-7 elsewhere); scores, CIs
and bootstrap scores 1e-4 at pca_k 3 and 5e-4 at pca_k 1: a rank-1
rebuild crowds the RDM entries to within 1e-7 of each other, so the
~2e-6 RDM differences exchange ranks, and one exchange moves a Spearman
score over the 435 pairs of 30 stimuli by up to 12/(N² − 1) = 6.3e-5
(observed at pca_k 1: up to 1.5e-4; at pca_k 3: up to 2.7e-5); the
Hamming RDM and the binary codes exactly; binary RSA rows and fig. 1's
scores 1e-6 (the same codes and RSMs, f32 sums in another order); the
port's uint8 feed against its float feed: NSD equal, THINGS' RDMs and
scores 1e-3 (observed 1.8e-4 and 6.0e-4 at pca_k 1).
"""
import json
import sqlite3
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch


import visreps_tpu.core.db as jdb
import visreps_tpu.data.neural as jneural
from experiments.binary_pc_rsa import main as jbin
from experiments.neurips_2025.fig1 import model_reps_rsa_comparisons as jfig1
from experiments.reconstruction_analysis import plot as jplot
from experiments.reconstruction_analysis import run_reconstruction as jrec
from visreps_tpu.benchmarks import fixture as jfixture
from visreps_tpu.core.config import Config as JaxConfig
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor
from visreps_tpu.train import checkpoint as jckpt

import visreps_tpu_torch.core.db as tdb
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.experiments.binary_pc_rsa import main as tbin
from visreps_tpu_torch.experiments.neurips_2025.fig1 import model_reps_rsa_comparisons as tfig1
from visreps_tpu_torch.experiments.reconstruction_analysis import plot as tplot
from visreps_tpu_torch.experiments.reconstruction_analysis import run_reconstruction as trec
from visreps_tpu_torch.models.custom_cnn import CustomCNN
from visreps_tpu_torch.models.standard import AlexNet
from visreps_tpu_torch.train import checkpoint as tckpt

TINY_NSD = {"N_SHARED": 30, "N_UNIQUE": 4, "N_SUBJECTS": 2, "REGIONS": ["early", "ventral"],
            "N_VOXELS": 8, "N_STIMULI": 30 + 2 * 4, "IMG_SIZE": 64}
TINY_THINGS = {"THINGS_CONCEPTS": 40, "THINGS_IMGS_PER_CONCEPT": 3, "N_JPEG": 120}
SCORE_TOL = {1: 5e-4, 3: 1e-4}  # by pca_k
RDM_TOL = 1e-4
ROW_TOL = 1e-6
U8_RDM_TOL, U8_SCORE_TOL = 1e-3, 1e-3  # THINGS, uint8 feed against the float feed
PCA_K = [1, 3]
N_BOOT = 20
CKPT_MODEL = "checkpoint_epoch_20.pth"
# Each (region, subject)'s baseline rows: the best layer last, by score.
BASELINE = {("early visual stream", 0): ["conv5_post", "conv2_post"],
            ("early visual stream", 1): ["fc1_post", "conv2_post"],
            ("ventral visual stream", 0): ["conv2_post", "conv5_pre"],
            ("ventral visual stream", 1): ["conv2_post", "conv5_pre"]}
THINGS_LAYER = "conv5_pre"


def _block_brick(path):
    """4 × 4 colour blocks in place of pixel noise, so deep-layer RDMs are
    spread (tests/test_torch_port_e2e.py)."""
    import h5py

    with h5py.File(path, "r+") as f:
        brick = f["imgBrick"]
        n, h, w, _ = brick.shape
        colours = np.random.RandomState(7).randint(0, 256, (n, 4, 4, 3)).astype(np.uint8)
        brick[...] = np.kron(colours, np.ones((1, h // 4, w // 4, 1), np.uint8))


def _block_jpegs(paths):
    from PIL import Image

    rng = np.random.RandomState(7)
    for p in paths:
        colours = rng.randint(0, 256, (4, 4, 3)).astype(np.uint8)
        Image.fromarray(np.kron(colours, np.ones((16, 16, 1), np.uint8))).save(p, quality=90)


def _seeded(model, seed):
    """``model`` with seeded normal weights (std 1/√fan-in), zero biases
    and BN statistics off their init."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, float(np.prod(p.shape[1:])) ** -0.5, generator=gen)
            elif "bn" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 2.0, generator=gen)
    return model.eval()


def _write_checkpoint(root: Path) -> Path:
    """A 1000-way CustomCNN checkpoint (``cfg1000a``, epoch 20) in the JAX
    package's pickle format, with the training config.json beside it;
    returns the checkpoint_dir."""
    run_dir = root / "ckpt" / "cfg1000a"
    run_dir.mkdir(parents=True)
    cfg = {"mode": "train", "seed": 1, "dataset": "imagenet", "pca_labels": False,
           "lr_scheduler": "cosineannealinglr", "model_class": "custom_model",
           "model_name": "CustomCNN", "batchsize": 256, "srp_k": 16,
           "checkpoint_dir": str(root / "ckpt")}
    (run_dir / "config.json").write_text(json.dumps(cfg))
    tckpt.save_checkpoint(str(run_dir), 20, _seeded(CustomCNN(num_classes=1000), 3), {}, cfg)
    return root / "ckpt"


def _baseline_cfg(cls, checkpoint_dir, dataset, region, subject):
    return cls({
        "seed": 1, "epoch": 20, "region": region, "subject_idx": subject,
        "neural_dataset": dataset, "cfg_id": 1000, "pca_labels": False,
        "pca_n_classes": None, "pca_labels_folder": None,
        "checkpoint_dir": str(checkpoint_dir), "analysis": "rsa",
        "compare_method": "spearman", "reconstruct_from_pcs": False, "pca_k": 1,
        "model_name": "CustomCNN"})


def _seed_baselines(save, cls, checkpoint_dir, db_path):
    """NSD's and THINGS' baseline rows (scores rising along each list)."""
    for (region, subject), layers in BASELINE.items():
        for i, layer in enumerate(layers):
            save([{"layer": layer, "compare_method": "spearman", "score": 0.1 + 0.1 * i,
                   "analysis": "rsa"}],
                 _baseline_cfg(cls, checkpoint_dir, "nsd", region, subject), db_path=db_path)
    for i, layer in enumerate(["conv1_post", THINGS_LAYER]):
        save([{"layer": layer, "compare_method": "spearman", "score": 0.2 + 0.1 * i,
               "analysis": "rsa"}],
             _baseline_cfg(cls, checkpoint_dir, "things-behavior", "N/A", "N/A"),
             db_path=db_path)


def _args(checkpoint_dir):
    return SimpleNamespace(cfg_id=1000, checkpoint_dir=str(checkpoint_dir),
                           checkpoint_model=CKPT_MODEL, seeds=[1], pca_k=PCA_K,
                           compare_method="spearman", n_bootstrap=N_BOOT, batch_size=16,
                           num_workers=2, uint8_transfer=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tiny NSD and THINGS fixtures, the JAX-written checkpoint, and
    the baseline rows in two results.dbs (each package's own writer)."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("recon")
    try:
        mp.setattr(jfixture, "FIXTURE_DIR", tmp / "fx")
        mp.setattr(jfixture, "N_JPEG", 1)
        for k, v in TINY_NSD.items():
            mp.setattr(jfixture, k, v)
        meta = jfixture.ensure_fixture()
        _block_brick(meta["hdf5"])
        mp.setenv("NSD_DATA_DIR", str(Path(meta["pickle"]).parent))
        mp.setenv("NSD_STIMULI_HDF5", meta["hdf5"])
        mp.setattr(jneural, "NSD_STIMULI_HDF5", meta["hdf5"])
        mp.setenv("VISREPS_INIT_CACHE", "0")
        for k, v in TINY_THINGS.items():
            mp.setattr(jfixture, k, v)
        things = jfixture.ensure_things_fixture()
        _block_jpegs(sorted((tmp / "fx" / "jpeg").glob("*.jpg")))
        for pkg in (jrec, trec):
            mp.setitem(pkg.DATASET_CONFIG, "nsd", {**pkg.DATASET_CONFIG["nsd"],
                                                   "subjects": [0, 1]})
        checkpoint_dir = _write_checkpoint(tmp)
        _seed_baselines(jdb.save_results, JaxConfig, checkpoint_dir, tmp / "jax.db")
        _seed_baselines(tdb.save_results, Config, checkpoint_dir, tmp / "torch.db")
        yield {"tmp": tmp, "checkpoint_dir": checkpoint_dir, "things": things, "mp": mp}
    finally:
        mp.undo()


def _use_db(mp, path):
    mp.setattr(jdb, "RESULTS_DB_PATH", path)
    mp.setattr(tdb, "RESULTS_DB_PATH", path)


class TestQueryBestLayers:
    def test_both_packages_on_one_db(self, world, monkeypatch):
        _use_db(monkeypatch, world["tmp"] / "jax.db")
        args = ("nsd", 1, 1000, str(world["checkpoint_dir"]), "spearman")
        want = jrec.query_best_layers(*args)
        assert trec.query_best_layers(*args) == want
        assert want == {(r, str(s)): layers[-1] for (r, s), layers in BASELINE.items()}
        _use_db(monkeypatch, world["tmp"] / "torch.db")  # the port's rows, the JAX query
        assert jrec.query_best_layers(*args) == want
        for pkg in (jrec, trec):
            with pytest.raises(ValueError, match="No baseline results"):
                pkg.query_best_layers("tvsd", 1, 1000, str(world["checkpoint_dir"]), "spearman")
            with pytest.raises(ValueError, match="No baseline results"):
                pkg.query_best_layers("nsd", 2, 1000, str(world["checkpoint_dir"]), "spearman")


def _recon_rows(path):
    with sqlite3.connect(str(path)) as conn:
        return conn.execute(
            "SELECT r.run_id, r.neural_dataset, r.region, r.subject_idx, r.pca_k, r.layer, "
            "r.score, r.ci_low, r.ci_high, b.scores FROM results r JOIN "
            "bootstrap_distributions b USING (run_id, compare_method) "
            "WHERE r.reconstruct_from_pcs = 1 ORDER BY r.neural_dataset, r.region, "
            "r.subject_idx, r.pca_k").fetchall()


@pytest.fixture(scope="module")
def sweeps(world):
    """Both packages' NSD and THINGS sweeps, each into its own results.db:
    {package: (rows with their bootstrap lists, every RDM built in order)}."""
    mp = world["mp"]
    args = _args(world["checkpoint_dir"])
    cwd = Path.cwd()
    out = {}
    for name, pkg, kwargs in (("jax", jrec, {}), ("torch", trec, {"device": "cpu"})):
        rdms = []
        build = pkg.compute_rdm

        def record(x, *a, build=build, rdms=rdms, **kw):
            rdm = build(x, *a, **kw)
            rdms.append(np.asarray(rdm))
            return rdm

        mp.setattr(pkg, "compute_rdm", record)
        _use_db(mp, world["tmp"] / f"{name}.db")
        pkg.run_nsd_tvsd(args, "nsd", **kwargs)
        mp.chdir(world["things"]["root"])
        try:
            pkg.run_things(args, **kwargs)
        finally:
            mp.chdir(cwd)
            mp.setattr(pkg, "compute_rdm", build)
        rows = [(*r[:9], json.loads(r[9])) for r in _recon_rows(world["tmp"] / f"{name}.db")]
        out[name] = (rows, rdms)
    return out


class TestSweepParity:
    def test_same_rows(self, sweeps):
        """One row per (region, subject, pca_k) with the baseline's best
        layer, under the same run_ids."""
        keys = [r[:6] for r in sweeps["torch"][0]]
        assert keys == [r[:6] for r in sweeps["jax"][0]]
        assert len(keys) == (len(BASELINE) + 1) * len(PCA_K)
        best = {(r, str(s)): layers[-1] for (r, s), layers in BASELINE.items()}
        best[("N/A", "N/A")] = THINGS_LAYER
        assert all(k[5] == best[(k[2], k[3])] for k in keys)

    def test_rdms(self, sweeps):
        """Every neural and reconstructed model RDM, in the order built:
        NSD's 4 neural RDMs, 2 layers × 2 ks, then THINGS' neural RDM and
        one per k."""
        got, want = sweeps["torch"][1], sweeps["jax"][1]
        assert [r.shape for r in got] == [r.shape for r in want]
        assert len(got) == 4 + 2 * len(PCA_K) + 1 + len(PCA_K)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=RDM_TOL)

    def test_scores_cis_and_bootstraps(self, sweeps):
        for t, j in zip(sweeps["torch"][0], sweeps["jax"][0]):
            tol = SCORE_TOL[t[4]]
            assert len(t[9]) == len(j[9]) == N_BOOT
            np.testing.assert_allclose(t[6:9], j[6:9], atol=tol, err_msg=str(t[:6]))
            np.testing.assert_allclose(t[9], j[9], atol=tol, err_msg=str(t[:6]))
        assert len({round(r[6], 6) for r in sweeps["torch"][0]}) > len(PCA_K)

    def test_each_package_reads_the_others_rows(self, world, sweeps):
        """The JAX figure query over the port's results.db, and the port's
        over the JAX package's, return what each returns over its own."""
        for region in ("early visual stream", "ventral visual stream"):
            for a, b in (("jax", "torch"), ("torch", "jax")):
                own = jplot.query_reconstruction_curve(world["tmp"] / f"{a}.db", "nsd", region)
                other = jplot.query_reconstruction_curve(world["tmp"] / f"{b}.db", "nsd", region)
                assert own[["pca_k", "seed", "subject_idx", "layer"]].values.tolist() == \
                    other[["pca_k", "seed", "subject_idx", "layer"]].values.tolist()
                mine = tplot.query_reconstruction_curve(world["tmp"] / f"{b}.db", "nsd", region)
                assert mine["layer"].tolist() == own["layer"].tolist()
                np.testing.assert_allclose(mine["score"], own["score"], atol=SCORE_TOL[1])


def test_uint8_feed_gives_the_same_rows(world, sweeps):
    """The port's sweeps with ``--uint8-transfer`` (uint8 batches,
    normalised by the extractor in f32, where the float feed normalises
    in f64 and rounds once) build the float feed's RDMs and write its
    rows: NSD's (a uint8 brick, normalised alike) equal; THINGS' within
    U8_RDM_TOL and U8_SCORE_TOL (taps one f32 rounding apart move the
    RDM of a rank-1 rebuild of 32 concept means by up to 1.8e-4, and its
    scores by up to 6.0e-4 through exchanged ranks)."""
    mp = world["mp"]
    args = _args(world["checkpoint_dir"])
    args.uint8_transfer = True
    _seed_baselines(tdb.save_results, Config, world["checkpoint_dir"], world["tmp"] / "u8.db")
    _use_db(mp, world["tmp"] / "u8.db")
    rdms, build = [], trec.compute_rdm

    def record(x, *a, **kw):
        rdm = build(x, *a, **kw)
        rdms.append(np.asarray(rdm))
        return rdm

    mp.setattr(trec, "compute_rdm", record)
    trec.run_nsd_tvsd(args, "nsd", device="cpu")
    mp.chdir(world["things"]["root"])
    try:
        trec.run_things(args, device="cpu")
    finally:
        mp.chdir(Path(__file__).resolve().parents[1])
        mp.setattr(trec, "compute_rdm", build)
    nsd = 4 + 2 * len(PCA_K)  # NSD's RDMs come first: equal; then THINGS'
    for i, (g, w) in enumerate(zip(rdms, sweeps["torch"][1], strict=True)):
        np.testing.assert_allclose(g, w, atol=0 if i < nsd else U8_RDM_TOL)
    got = [(*r[:9], json.loads(r[9])) for r in _recon_rows(world["tmp"] / "u8.db")]
    want = sweeps["torch"][0]
    assert [r[:6] for r in got] == [r[:6] for r in want]
    for g, w in zip(got, want):
        tol = 0 if g[1] == "nsd" else U8_SCORE_TOL
        np.testing.assert_allclose([*g[6:9], *g[9]], [*w[6:9], *w[9]], atol=tol,
                                   err_msg=str(g[:6]))


@pytest.mark.parametrize("shape", [(30, 50), (50, 20)])
def test_one_fit_per_layer_rebuilds_as_ops_pca(shape):
    """One fit per layer and a top-k slice per k rebuild what a fit per k
    (``ops/pca.reconstruct_from_pcs``) rebuilds."""
    from visreps_tpu_torch.ops.pca import reconstruct_from_pcs

    x = torch.as_tensor(np.random.RandomState(3).randn(*shape).astype(np.float32))
    pcas = trec.fit_layer_pcs({"l": x}, 15)
    for k in (1, 2, 5, 15):
        np.testing.assert_allclose(trec.reconstruct_from_pcs({"l": x}, pcas, k)["l"],
                                   reconstruct_from_pcs({"l": x}, k)["l"], atol=1e-6)


# ── binary-PC RSA ───────────────────────────────────────────────────

def _xor_rdm(codes: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Σ_k w_k·xor(b_ik, b_jk) / Σw, pair by pair, in integers then f32."""
    w = weights.astype(np.int64)
    diff = codes[:, None, :] != codes[None, :, :]
    return ((diff * w).sum(-1).astype(np.float32) / np.float32(w.sum())).astype(np.float32)


class TestBinaryCodes:
    @pytest.mark.parametrize("weighted", [True, False])
    def test_hamming_rdm_equals_jax_and_xor(self, weighted):
        codes = np.random.RandomState(0).randint(0, 2, (50, 20)).astype(np.int32)
        w = np.arange(20, 0, -1, dtype=np.float32) if weighted else np.ones(20, np.float32)
        got = tbin.binary_rdm(torch.from_numpy(codes), weighted).numpy()
        want = np.asarray(jbin.binary_rdm(codes, weighted))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _xor_rdm(codes, w))
        assert (np.diag(got) == 0).all()

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_project_and_binarize_even_n(self, dtype):
        """n = 30 PC scores (unit eigenvectors and a zero mean: the
        product is exact) per column: distinct values; ties at the middle;
        and two adjacent middle values whose mean rounds to the upper one,
        so numpy's median (not the lower middle value torch.median gives)
        decides the bits."""
        rng = np.random.RandomState(1)
        n, h = 30, 15
        lower = np.nextafter(dtype(1), dtype(2))
        upper = np.nextafter(lower, dtype(2))
        cols = [rng.permutation(n).astype(dtype) * 3 - 40,
                rng.randint(-3, 3, n).astype(dtype),
                rng.permutation(np.concatenate([np.linspace(-10, -1, h - 1), [lower, upper],
                                                np.linspace(5, 10, n - h - 1)]).astype(dtype))]
        acts = np.stack(cols, axis=1)
        eig, mean = np.eye(3, dtype=dtype), np.zeros(3, dtype)
        want = jbin.project_and_binarize(acts, eig, mean, 3)
        got = tbin.project_and_binarize(acts, eig, mean, 3, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
        assert got[:, 2].sum() == h - 1  # the upper middle value is not above the median
        assert got[:, 0].sum() == h


@pytest.fixture(scope="module")
def binary_runs(world, tmp_path_factory):
    """run_analysis of both packages on the NSD fixture with one seeded
    AlexNet (its checkpoint file read by the JAX package), the port on the
    JAX taps so both binarise the same scores (its own taps are checked
    against them)."""
    tmp = tmp_path_factory.mktemp("binary")
    rng = np.random.RandomState(2)
    vecs = np.linalg.qr(rng.randn(4096, 6))[0].astype(np.float32)
    np.savez(tmp / "eig.npz", eigenvectors=vecs, mean=rng.randn(4096).astype(np.float32))
    args = SimpleNamespace(eigenvectors=str(tmp / "eig.npz"), model="AlexNet",
                           pretrained="none", layer="fc2", subjects=[0, 1], n_pcs=[2, 6],
                           correlations=["spearman", "kendall"], batch_size=16,
                           num_workers=2, device="cpu")
    taps = []
    jax_single = JaxExtractor.extract_single_layer

    def keep(self, *a, **kw):
        acts, ids = jax_single(self, *a, **kw)
        taps.append((np.asarray(acts, np.float32), list(ids)))
        return acts, ids

    alexnet = _seeded(AlexNet(), 0)
    path = tckpt.save_checkpoint(str(tmp), 0, alexnet, {}, {})
    jstate, _ = jckpt.load_checkpoint(path)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JaxExtractor, "extract_single_layer", keep)
        mp.setattr(jbin, "init_model", lambda name, num_classes, seed=0: jstate)
        want = jbin.run_analysis(args)

        def init_model(name, num_classes, seed=0, device=None):
            return alexnet.to(device)

        own_acts = tbin.subject_activations
        seen = []

        def jax_taps(extractor, layer, subject_idx, *a):
            acts, ids = own_acts(extractor, layer, subject_idx, *a)
            jacts, jids = taps[subject_idx]
            seen.append((acts.numpy(), [str(i) for i in ids], jacts, [str(i) for i in jids]))
            return torch.from_numpy(jacts), jids

        mp.setattr("visreps_tpu_torch.models.zoo.init_model", init_model)
        mp.setattr(tbin, "subject_activations", jax_taps)
        got = tbin.run_analysis(args)
    finally:
        mp.undo()
    return want, got, seen


class TestBinaryRsa:
    def test_own_taps_match_jax(self, binary_runs):
        for acts, ids, jacts, jids in binary_runs[2]:
            assert sorted(ids) == sorted(jids) and len(ids) == TINY_NSD["N_SHARED"]
            order = [ids.index(i) for i in jids]
            np.testing.assert_allclose(acts[order], jacts, rtol=1e-4,
                                       atol=1e-4 * np.abs(jacts).max())

    def test_rows(self, binary_runs):
        want, got, _ = binary_runs
        keys = ("subject_idx", "n_pcs", "region", "weighted", "correlation")
        assert [tuple(r[k] for k in keys) for r in got] == [tuple(r[k] for k in keys)
                                                            for r in want]
        assert len(got) == 2 * 2 * 2 * 2 * 2
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   atol=ROW_TOL)


# ── fig. 1: RSM comparisons ─────────────────────────────────────────

@pytest.mark.parametrize("method", ["Pearson", "Spearman", "Kendall"])
def test_fig1_compare_layers(method):
    rng = np.random.RandomState(3)

    def rsm():
        return np.corrcoef(rng.rand(25, 6)).astype(np.float32)

    sets = [{"conv1": rsm(), "fc2": rsm(), "neural": rsm()} for _ in range(4)]
    want = jfig1.compare_layers(*sets, method)
    got = tfig1.compare_layers(*sets, method, device="cpu")
    assert got[0] == want[0] == ["conv1", "fc2"]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=ROW_TOL)
