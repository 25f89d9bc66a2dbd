"""The PyTorch port's representation analyses against the JAX package's
(``experiments/representation_analysis/``), on the CPU, on inputs drawn
from numpy seeds at toy widths (n ≤ 64, d ≤ 64; a TinyCustomCNN checkpoint
on 64 px JPEGs).

Tolerances: f32 device-program outputs (eigenvalues, Two-NN, Hoyer,
Fisher ratios, cosine similarities, PCs) within 1e-5 relative; host parts
that keep numpy's seeded streams and tie order (variance ratio, quadrants,
alignment, top-k sets, retrieval order, the Two-NN subsample) exactly;
ridge outputs within 1e-5 on the Woodbury route (n_fit − max_fold ≥ d);
RSA scores within 1e-6. Taps that go through the SRP are compared at rtol
1e-2 (the JAX SRP matrices carried across; ~1e-6 tap differences move
bf16-rounded SRP inputs, as in ``test_torch_port_e2e.py``); the metrics
are then held to the JAX package on the same taps. No t-SNE or UMAP runs:
both packages' ``embed_2d`` is replaced by one stub.
"""
import ast
import csv
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from experiments.representation_analysis import dim_metrics as jdm  # noqa: E402
from experiments.representation_analysis import dim_plots as jplots  # noqa: E402
from experiments.representation_analysis import dimensionality as jdim  # noqa: E402
from experiments.representation_analysis import nearest_neighbors as jnn  # noqa: E402
from experiments.representation_analysis import rsm_comparison as jrsm  # noqa: E402
from experiments.representation_analysis import run_all as jrun  # noqa: E402
from experiments.representation_analysis import task_brain_alignment as jtba  # noqa: E402
from experiments.representation_analysis import two_pcs_compare as jpcs  # noqa: E402
from experiments.representation_analysis import utils as jutils  # noqa: E402
from experiments.representation_analysis import variance_ratio as jvr  # noqa: E402
from experiments.semantic_analysis import fine_grained_structure as jfg  # noqa: E402
from visreps_tpu.ops.srp import SRPTransform as JaxSRP  # noqa: E402
from visreps_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402

from visreps_tpu_torch.experiments.representation_analysis import (  # noqa: E402
    dim_metrics as tdm,
    dim_plots as tplots,
    dimensionality as tdim,
    nearest_neighbors as tnn,
    rsm_comparison as trsm,
    run_all as trun,
    task_brain_alignment as ttba,
    two_pcs_compare as tpcs,
    utils as tutils,
    variance_ratio as tvr,
)
from visreps_tpu_torch.models.convert import srp_from_jax  # noqa: E402
from visreps_tpu_torch.models.custom_cnn import TinyCustomCNN  # noqa: E402
from visreps_tpu_torch.train import checkpoint as tckpt  # noqa: E402

RTOL = 1e-5
RSA_TOL = 1e-6
SRP_K = 16
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planted(n, d, seed, scales=None):
    """(n, d) float32 rows with a planted, well-separated spectrum."""
    rng = np.random.RandomState(seed)
    scales = np.geomspace(8.0, 0.5, d) if scales is None else scales
    return (rng.randn(n, d) * scales).astype(np.float32)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """``cfg4a`` and ``cfg8a``: seeded TinyCustomCNN checkpoints with
    non-trivial BatchNorm statistics, in the format both packages read."""
    root = tmp_path_factory.mktemp("ckpts")
    for cfg_id, seed in ((4, 3), (8, 5)):
        model = TinyCustomCNN(num_classes=cfg_id)
        gen = torch.Generator().manual_seed(seed)
        model.init_weights(gen)
        with torch.no_grad():
            for name, b in model.named_buffers():
                if name.endswith("running_mean"):
                    b.normal_(0.0, 0.1, generator=gen)
                elif name.endswith("running_var"):
                    b.uniform_(0.5, 1.5, generator=gen)
        (root / f"cfg{cfg_id}a").mkdir()
        tckpt.save_checkpoint(str(root / f"cfg{cfg_id}a"), 20, model, {}, {"seed": 1})
    return root


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """16 noisy 4 × 4 colour-block 64 px JPEGs."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(11)
    for i in range(16):
        blocks = rng.randint(0, 256, (4, 4, 3))
        img = np.kron(blocks, np.ones((16, 16, 1))) + rng.randint(-20, 20, (64, 64, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(root / f"n0{i % 4}_{i}.jpg")
    return root


def embed_stub(calls):
    """A cheap ``embed_2d`` stand-in that records what it was given."""
    def embed(feats, seed=42, metric="cosine"):
        calls.append(np.array(feats))
        return np.asarray(feats, np.float64)[:, :2] * 3.0, "stub"
    return embed


# ── 1. utils ────────────────────────────────────────────────────────

class TestUtils:
    def test_constants(self):
        for name in ("DATASET", "LAYER", "ALL_LAYERS", "MODEL_NAMES", "SEED"):
            assert getattr(tutils, name) == getattr(jutils, name), name

    def test_extract_pooled_layers(self, ckpt_dir):
        """conv taps pooled to 3 × 3 (and 2 × 2), rows L2-normalised; the
        JAX state and the port's model from the same checkpoint."""
        path = ckpt_dir / "cfg4a" / "checkpoint_epoch_20.pth"
        state, _ = jax_load_checkpoint(path)
        model, _ = tckpt.load_checkpoint(path, device=CPU)
        rng = np.random.RandomState(0)
        batches = [(rng.randn(4, 64, 64, 3).astype(np.float32), np.arange(4) % 2 + 2 * b)
                   for b in range(2)]
        for pool, norm in ((3, True), (2, False)):
            layers = ["conv3", "conv5", "fc1", "fc2"]
            jf, jl = jutils.extract_pooled_layers(state, batches, layers, pool, norm)
            tf, tl = tutils.extract_pooled_layers(model, batches, layers, pool, norm,
                                                  device=CPU)
            np.testing.assert_array_equal(tl, jl)
            assert list(tf) == list(jf)
            for layer in layers:
                assert tf[layer].shape == jf[layer].shape
                _close(tf[layer], jf[layer], 1e-4)

    def test_npz_dirs_and_labels(self, tmp_path):
        np.savez(tmp_path / "f.npz", fc2=np.arange(6.0).reshape(3, 2), labels=np.arange(3))
        np.savez(tmp_path / "g.npz", fc2=np.ones((2, 2)))
        for p in ("f.npz", "g.npz"):
            jf, jl = jutils.load_feature_npz(str(tmp_path / p))
            tf, tl = tutils.load_feature_npz(str(tmp_path / p))
            assert list(tf) == list(jf) and (tl is None) == (jl is None)
            np.testing.assert_array_equal(tf["fc2"], jf["fc2"])
        assert tutils.ensure_output_dir(str(tmp_path / "o")) == str(tmp_path / "o")
        (tmp_path / "pca.csv").write_text("image,pca_label\nn01_1.jpg,3\nn02_9.jpg,1\n")
        (tmp_path / "sem.csv").write_text("image,pca_label\nn02_9.jpg,5\n")
        samples = [("/a/n01_1.jpg", 0, "n01_1.jpg"), ("/a/n02_9.jpg", 1, "n02_9.jpg"),
                   ("b/n03_2.jpg", 1, "n03_2.jpg")]
        args = (samples, str(tmp_path / "pca.csv"), str(tmp_path / "sem.csv"))
        for got, ref in zip(tutils.load_labels(*args), jutils.load_labels(*args)):
            np.testing.assert_array_equal(got, ref)

    def test_embed_2d_backends(self, monkeypatch):
        """Without umap, both take sklearn's TSNE with the same arguments
        (a stub class); without either, both raise ImportError."""
        import types

        made = []

        class TSNE:
            def __init__(self, **kwargs):
                made.append(kwargs)

            def fit_transform(self, x):
                return x[:, :2].astype(np.float64)

        monkeypatch.setitem(sys.modules, "umap", None)
        monkeypatch.setitem(sys.modules, "sklearn.manifold", types.SimpleNamespace(TSNE=TSNE))
        x = _planted(20, 6, 1)
        (jc, jname), (tc, tname) = jutils.embed_2d(x), tutils.embed_2d(x)
        assert jname == tname == "t-SNE" == tutils.embedding_backend()
        assert made[0] == made[1] and made[0]["perplexity"] == 5
        np.testing.assert_array_equal(tc, jc)
        monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
        for fn in (jutils.embed_2d, tutils.embed_2d):
            with pytest.raises(ImportError):
                fn(x)
        assert tutils.embedding_backend() is None

    def test_load_models_pair(self, ckpt_dir, capsys, monkeypatch):
        """The checkpoint's weights as the JAX package loads them, and
        AlexNet where no weights file is present (its seeded init, 6 s of
        random draws here, skipped)."""
        from visreps_tpu_torch.models.standard import AlexNet

        monkeypatch.setattr(AlexNet, "init_weights", lambda self, gen: None)
        pre, trained = tutils.load_models_pair(4, 1, str(ckpt_dir), device=CPU)
        assert type(pre).__name__ == "AlexNet" and pre.num_classes == 1000
        state, _ = jax_load_checkpoint(ckpt_dir / "cfg4a" / "checkpoint_epoch_20.pth")
        from visreps_tpu_torch.models.convert import params_to_jax

        params, _ = params_to_jax(trained.state_dict())
        ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, state.params))
        got = jax.tree_util.tree_leaves(params)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        assert "Loaded pretrained + cfg4a models" in capsys.readouterr().out


# ── 2. dim_metrics ──────────────────────────────────────────────────

@pytest.mark.parametrize("shape", [(48, 24), (24, 48)], ids=["d_lt_n", "d_gt_n"])
class TestDimMetrics:
    def test_spectrum_and_counts(self, shape):
        x = _planted(*shape, seed=2)
        _close(tdm.eigenspectrum(x, device=CPU), jdm.eigenspectrum(x))
        assert tdm.participation_ratio(x, device=CPU) == pytest.approx(
            jdm.participation_ratio(x), rel=RTOL)
        _close(tdm.cumulative_variance(x, device=CPU), jdm.cumulative_variance(x))
        for t in (0.5, 0.9, 0.99):
            assert tdm.n_components_for_variance(x, t, device=CPU) == \
                jdm.n_components_for_variance(x, t)

    def test_two_nn_hoyer_active(self, shape):
        x = _planted(*shape, seed=3)
        x[:, : shape[1] // 3] = np.maximum(x[:, : shape[1] // 3], 0)
        for n_samples in (None, 20):
            got = tdm.two_nn_dimension(x, n_samples=n_samples, device=CPU)
            ref = jdm.two_nn_dimension(x, n_samples=n_samples)
            np.testing.assert_allclose(got, ref, rtol=RTOL)
        _close(tdm.hoyer_sparsity(x, device=CPU), jdm.hoyer_sparsity(x))
        _close(tdm.fraction_active(x, 0.5, device=CPU), jdm.fraction_active(x, 0.5))

    def test_compute_all_metrics(self, shape):
        feats = {"a": _planted(*shape, seed=4),
                 "b": _planted(shape[0], 30, seed=5).reshape(shape[0], 2, 3, 5)}
        got = tdm.compute_all_metrics(feats, ["a", "b"], n_samples_twonn=20, device=CPU)
        ref = jdm.compute_all_metrics(feats, ["a", "b"], n_samples_twonn=20)
        for layer in ("a", "b"):
            assert got["n90"][layer] == ref["n90"][layer]
            assert got["pr"][layer] == pytest.approx(ref["pr"][layer], rel=RTOL)
            for k in ("dimension", "std"):
                assert got["twonn"][layer][k] == pytest.approx(ref["twonn"][layer][k], rel=RTOL)
            for k in ("mean", "std", "frac_active"):
                assert got["sparsity"][layer][k] == pytest.approx(
                    ref["sparsity"][layer][k], rel=RTOL, abs=1e-7)
            _close(got["eigenvalues"][layer], ref["eigenvalues"][layer])


def test_hoyer_zero_rows_and_degenerate_two_nn():
    x = _planted(12, 8, seed=6)
    x[3] = 0.0
    _close(tdm.hoyer_sparsity(x, device=CPU), jdm.hoyer_sparsity(x))
    dup = np.repeat(_planted(4, 8, seed=7), 5, axis=0)
    assert np.isnan(tdm.two_nn_dimension(dup, device=CPU)).all()
    assert np.isnan(jdm.two_nn_dimension(dup)).all()
    with pytest.raises(ValueError, match="device"):
        tdm.eigenspectrum(x)


def test_summary_table_prints_the_same(capsys):
    layers, names = ["l1", "l2"], ["A", "B"]
    results = {"PR": {"A": {"l1": 3.0, "l2": 4.5}, "B": {"l1": 1.5, "l2": 0.0}},
               "ID": {"A": {"l1": {"mean": 2.0}, "l2": {"dimension": 1.0}},
                      "B": {"l1": {"mean": 1.0}, "l2": {"dimension": 4.0}}}}
    jplots.print_summary_table(results, layers, names)
    ref = capsys.readouterr().out
    tplots.print_summary_table(results, layers, names)
    assert capsys.readouterr().out == ref


# ── 4. dimensionality CLI ───────────────────────────────────────────

@pytest.fixture(scope="module")
def dim_runs(ckpt_dir, jpegs, tmp_path_factory):
    """Both packages' ``dimensionality.main`` on the same checkpoints and
    JPEGs, SRP k = 16 (the JAX matrices carried into the port), with every
    store each ``_extract`` returned: the JAX run of the first checkpoint
    (its store is the reference), the port's of both with the comparison
    figures."""
    mp = pytest.MonkeyPatch()
    out = tmp_path_factory.mktemp("dim")
    stores = {"jax": [], "torch": []}
    runs = {}
    try:
        jconf = jdim.configure_feature_extractor

        def jax_configure(cfg, state, *a, **kw):
            cfg["srp_k"] = SRP_K
            return jconf(cfg, state, *a, **kw)

        from visreps_tpu_torch.models import extractor as textractor

        tconfigure = textractor.configure_feature_extractor

        def torch_configure(cfg, model, *a, **kw):
            cfg["srp_k"] = SRP_K
            ex = tconfigure(cfg, model, *a, **kw)
            jsrp = JaxSRP(k=SRP_K, seed=0)
            srp_from_jax(ex.srp, {d: tuple(np.asarray(c, np.float32)
                                           for c in jsrp.matrix_chunks(d))
                                  for d in set(ex.tap_dims.values())})
            return ex

        mp.setattr(jdim, "configure_feature_extractor", jax_configure)
        for name in ("plot_metric_comparison", "plot_eigenspectrum", "plot_sparsity_comparison"):
            mp.setattr(jdim, name, lambda *a, **k: None)
        mp.setattr(textractor, "configure_feature_extractor", torch_configure)
        for key, mod in (("jax", jdim), ("torch", tdim)):
            inner = mod._extract

            def keep(args, cfg_id, inner=inner, key=key):
                acts = inner(args, cfg_id)
                stores[key].append({k: np.asarray(torch.as_tensor(v).cpu()
                                                  if isinstance(v, torch.Tensor) else v,
                                                  np.float32) for k, v in acts.items()})
                return acts

            mp.setattr(mod, "_extract", keep)
        for key, mod in (("jax", jdim), ("torch", tdim)):
            compare = ["--compare-cfg-id", "8"] if key == "torch" else []
            argv = ["--checkpoint-dir", str(ckpt_dir), "--cfg-id", "4", *compare,
                    "--stimuli-dir", str(jpegs),
                    "--return-nodes", "conv5", "fc2", "--batch-size", "8",
                    "--twonn-samples", "12", "--out", str(out / f"{key}.csv"),
                    "--fig-dir", str(out / f"{key}_figs")]
            runs[key] = mod.main(argv + (["--device", CPU] if key == "torch" else []))
    finally:
        mp.undo()
    return out, stores, runs


class TestDimensionalityCLI:
    def test_stores(self, dim_runs):
        _, stores, _ = dim_runs
        assert (len(stores["jax"]), len(stores["torch"])) == (1, 2)
        assert list(stores["torch"][1]) == list(stores["torch"][0])
        for jst, tst in zip(stores["jax"], stores["torch"]):
            assert list(tst) == list(jst)
            assert len(tst) == 4 and all(v.shape == (16, SRP_K) for v in tst.values())
            for k in jst:
                _close(tst[k], jst[k], 1e-2)

    def test_metrics_on_the_jax_taps(self, dim_runs):
        """The port's metrics of the JAX store equal the JAX CSV's rows
        (rounded as the CSV rounds), and the port's own CSV is its
        metrics of its own store."""
        out, stores, runs = dim_runs
        layers = list(stores["jax"][0])
        got = tdm.compute_all_metrics(stores["jax"][0], layers, 12, device=CPU)
        tdim.write_csv(got, layers, out / "port_on_jax.csv")
        with open(out / "port_on_jax.csv") as f, open(out / "jax.csv") as g:
            rows, ref = list(csv.DictReader(f)), list(csv.DictReader(g))
        assert [r["layer"] for r in rows] == [r["layer"] for r in ref] == layers
        for r, e in zip(rows, ref):
            for k in r:
                if k != "layer":
                    assert float(r[k]) == pytest.approx(float(e[k]), abs=1.5e-3), k
        own = tdm.compute_all_metrics(stores["torch"][0], layers, 12, device=CPU)
        tdim.write_csv(own, layers, out / "own.csv")
        assert (out / "own.csv").read_text() == (out / "torch.csv").read_text()
        assert list(runs["torch"]) == ["cfg4", "cfg8"]

    def test_figures_and_their_data(self, dim_runs):
        out, _, _ = dim_runs
        for name in ("participation_ratio", "intrinsic_dimension", "eigenspectrum",
                     "sparsity"):
            assert (out / "torch_figs" / f"{name}.png").is_file()
            data = json.loads((out / "torch_figs" / f"{name}.json").read_text())
            assert data["model_names"] == ["cfg4", "cfg8"]


# ── 5. variance ratio ───────────────────────────────────────────────

def _clustered(n_per, n_classes, d, seed):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_classes, d) * 3
    x = np.concatenate([centers[c] + rng.randn(n_per, d) for c in range(n_classes)])
    return x.astype(np.float32), np.repeat(np.arange(n_classes), n_per)


def test_variance_ratio(tmp_path):
    x, y = _clustered(8, 4, 12, 8)
    got, ref = tvr.variance_ratio_stats(x, y), jvr.variance_ratio_stats(x, y)
    for k in ("within", "between", "ratio"):
        assert got[k] == ref[k]
    for g, r in zip(got["within_per_class"], ref["within_per_class"]):
        np.testing.assert_array_equal(g, r)
    np.save(tmp_path / "a.npy", x)
    np.save(tmp_path / "b.npy", x * 2 + 1)
    np.save(tmp_path / "y.npy", y)
    argv = ["--features", str(tmp_path / "a.npy"), str(tmp_path / "b.npy"),
            "--labels", str(tmp_path / "y.npy")]
    tstats = tvr.main(argv + ["--out", str(tmp_path / "t.png")])
    jstats = jvr.main(argv + ["--out", str(tmp_path / "j.png")])
    assert [s["ratio"] for s in tstats] == [s["ratio"] for s in jstats]
    assert (tmp_path / "t.png").is_file()
    data = json.loads((tmp_path / "t.json").read_text())
    assert data["b"]["ratio"] == tstats[1]["ratio"]


# ── 6. nearest neighbours ───────────────────────────────────────────

class TestNearestNeighbors:
    def test_scores_and_retrieval(self):
        x, y = _clustered(6, 5, 16, 9)
        q = np.array([0, 7, 13, 29])
        sims = tnn._cosine_topk_scores(torch.from_numpy(x), torch.from_numpy(q))
        ref = np.asarray(jnn._cosine_topk_scores(jax.numpy.asarray(x), jax.numpy.asarray(q)))
        assert np.isneginf(sims.numpy()[np.arange(4), q]).all()
        finite = np.isfinite(ref)
        _close(sims.numpy()[finite], ref[finite])
        (tk, tacc), (jk, jacc) = tnn.retrieve(x, y, q, 5, device=CPU), jnn.retrieve(x, y, q, 5)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tacc, jacc)

    def test_main_with_images(self, tmp_path, jpegs):
        x, y = _clustered(4, 4, 8, 10)
        paths = sorted(str(p) for p in Path(jpegs).iterdir())
        (tmp_path / "paths.txt").write_text("\n".join(paths[:12] + ["missing.jpg"] * 4))
        np.save(tmp_path / "a.npy", x)
        np.save(tmp_path / "y.npy", y)
        argv = ["--features", str(tmp_path / "a.npy"), "--labels", str(tmp_path / "y.npy"),
                "--image-paths", str(tmp_path / "paths.txt"), "--n-queries", "3", "--k", "3"]
        got = tnn.main(argv + ["--out", str(tmp_path / "t.png"), "--device", CPU])
        ref = jnn.main(argv + ["--out", str(tmp_path / "j.png")])
        assert got == ref
        assert (tmp_path / "t.png").is_file()
        data = json.loads((tmp_path / "t.json").read_text())
        assert len(data["query_idx"]) == 3 and len(data["top_k"]["a"][0]) == 3


# ── 7. RSM comparison ───────────────────────────────────────────────

def test_rsm_comparison(tmp_path, jpegs, monkeypatch):
    """Node selection, one RDM per tap and the similarity matrix of both
    packages on the same taps: a stub extractor returns seeded (n, 32)
    rows per tap (its arguments recorded), so no torchvision-size SRP is
    built here; the card runs the real extraction."""
    made = {"jax": [], "torch": []}
    rng = np.random.RandomState(12)
    base = rng.randn(16, 32).astype(np.float32)

    def stub(key):
        class Stub:
            def __init__(self, model, nodes, srp_k=None, batch_size=None, image_size=None,
                         device=None, **kw):
                made[key].append((list(nodes), srp_k, image_size))
                self.nodes = list(nodes)
                self.device = torch.device("cpu")

            def get_activations(self, loader, store=None, **kw):
                acts = {}
                for i, node in enumerate(self.nodes):
                    for j, suffix in enumerate(("pre", "post")):
                        a = base + (i + 0.5 * j) * np.random.RandomState(i * 2 + j).randn(
                            16, 32).astype(np.float32)
                        acts[f"{node}_{suffix}"] = torch.from_numpy(a) if key == "torch" else a
                return acts, [f"s{i}" for i in range(16)]
        return Stub

    import visreps_tpu.models.zoo as jzoo
    import visreps_tpu_torch.models.extractor as textractor
    import visreps_tpu_torch.models.zoo as tzoo

    monkeypatch.setattr(jrsm, "FeatureExtractor", stub("jax"))
    monkeypatch.setattr(jrsm, "init_model", lambda *a, **k: None)
    monkeypatch.setattr(textractor, "FeatureExtractor", stub("torch"))
    monkeypatch.setattr(tzoo, "init_model", lambda *a, **k: None)
    assert jzoo.TORCHVISION_RETURN_NODES == tzoo.TORCHVISION_RETURN_NODES
    argv = ["--stimuli-dir", str(jpegs), "--models", "AlexNet", "ResNet18",
            "--layers-per-model", "3"]
    jrsm.main(argv + ["--out", str(tmp_path / "j.npz")])
    rdms, sim = trsm.main(argv + ["--out", str(tmp_path / "t.npz"), "--device", CPU])
    assert made["torch"] == made["jax"]
    assert made["torch"][0] == (["conv1", "conv3", "conv5"], 4096, 224)
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert t["names"].tolist() == j["names"].tolist() == list(rdms)
    assert len(rdms) == 12
    np.testing.assert_allclose(t["similarity"], j["similarity"], rtol=0, atol=RSA_TOL)
    np.testing.assert_allclose(np.diag(sim), 1.0, atol=RSA_TOL)
    np.testing.assert_array_equal(sim, sim.T)


# ── 8. task–brain alignment ─────────────────────────────────────────

class TestTaskBrainAlignment:
    def test_importances(self):
        x, y = _clustered(10, 4, 16, 13)
        got = ttba.fisher_discriminant_per_dim(x, y, 5, device=CPU).numpy()
        ref = np.asarray(jtba.fisher_discriminant_per_dim(jax.numpy.asarray(x),
                                                          jax.numpy.asarray(y), 5))
        np.testing.assert_allclose(got, ref, rtol=RTOL)
        np.testing.assert_array_equal(ttba.class_centroid_importance(x, y),
                                      jtba.class_centroid_importance(x, y))

    def test_ridge_weights_on_the_woodbury_route(self):
        """60 stimuli (48 fit rows, folds of ≤ 10) × 16 dims: n_fit −
        max_fold = 38 ≥ d."""
        rng = np.random.RandomState(14)
        x = rng.randn(60, 16).astype(np.float32) * np.linspace(0.5, 3, 16).astype(np.float32)
        w = rng.randn(16, 6).astype(np.float32)
        neural = (x @ w + 0.5 * rng.randn(60, 6)).astype(np.float32)
        tw, tr, ta = ttba.brain_predictive_weights(x, neural, device=CPU)
        jw, jr, ja = jtba.brain_predictive_weights(x, neural)
        np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=1e-7)
        assert tr == pytest.approx(jr, abs=RTOL) and ta == ja

    def test_alignment(self):
        rng = np.random.RandomState(15)
        a, b = rng.rand(64), rng.rand(64)
        b[:20] = a[:20] * 2
        got, ref = ttba.compute_alignment(a, b, device=CPU), jtba.compute_alignment(a, b)
        assert list(got) == list(ref)
        for k in ref:
            assert got[k] == pytest.approx(ref[k], abs=RSA_TOL), k

    def test_main_appends_rows(self, tmp_path, monkeypatch):
        x, y = _clustered(8, 4, 16, 16)
        rng = np.random.RandomState(17)
        bf = rng.randn(60, 16).astype(np.float32)
        resp = (bf @ rng.randn(16, 5) + rng.randn(60, 5)).astype(np.float32)
        for name, arr in (("tf", x), ("tl", y), ("bf", bf), ("br", resp)):
            np.save(tmp_path / f"{name}.npy", arr)
        argv = ["--task-features", str(tmp_path / "tf.npy"), "--task-labels",
                str(tmp_path / "tl.npy"), "--brain-features", str(tmp_path / "bf.npy"),
                "--brain-responses", str(tmp_path / "br.npy")]
        rows = {}
        monkeypatch.setattr(jtba, "plot_alignment", lambda *a, **k: None)  # JAX figure: not drawn
        for key, mod, extra in (("jax", jtba, []), ("torch", ttba, ["--device", CPU])):
            for imp in ("fisher", "centroid"):
                rows[key, imp] = mod.main(argv + ["--task-importance", imp, "--layer", imp,
                                                  "--out-dir", str(tmp_path / key)] + extra)
        for imp in ("fisher", "centroid"):
            got, ref = rows["torch", imp], rows["jax", imp]
            assert list(got) == list(ref)
            for k, v in ref.items():
                assert got[k] == (v if isinstance(v, str) else pytest.approx(v, abs=RTOL)), k
        with open(tmp_path / "torch" / "task_brain_alignment.csv") as f:
            assert [r["layer"] for r in csv.DictReader(f)] == ["fisher", "centroid"]
        assert (tmp_path / "torch" / "task_brain_alignment_fisher.png").is_file()


# ── 9. two-PC quadrants ─────────────────────────────────────────────

def _pc_feats(seed):
    return {layer: _planted(40, 12, seed=seed + i) for i, layer in enumerate(tpcs.LAYERS)}


class TestTwoPcs:
    def test_compute_pca_up_to_sign(self):
        x = _planted(50, 12, seed=18)
        (tp, tv), (jp, jv) = tpcs.compute_pca(x, 3, device=CPU), jpcs.compute_pca(x, 3)
        np.testing.assert_allclose(tv, jv, rtol=RTOL)
        signs = np.sign((tp * jp).sum(axis=0))
        _close(tp * signs, jp)

    def test_host_parts_exactly(self):
        rng = np.random.RandomState(19)
        pcs = rng.randn(40, 2)
        tq, jq = tpcs.assign_quadrants(*pcs.T), jpcs.assign_quadrants(*pcs.T)
        np.testing.assert_array_equal(tq[0], jq[0])
        assert tq[1:] == jq[1:]
        trained = np.stack([-pcs[:, 1], pcs[:, 0]], axis=1) + 0.1 * rng.randn(40, 2)
        got = tpcs.align_pcs(trained.copy(), np.array([60.0, 40.0]), tq[0])
        ref = jpcs.align_pcs(trained.copy(), np.array([60.0, 40.0]), jq[0])
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]

    def test_main_npz_through_the_matching_relabelling(self, tmp_path, monkeypatch):
        """Both mains on the same npz: each PC equal up to its sign; the
        JAX run's host parts fed the port's PCs give the port's quadrants,
        medians and aligned PCs exactly."""
        pre, trn = _pc_feats(20), _pc_feats(30)
        np.savez(tmp_path / "pre.npz", **pre)
        np.savez(tmp_path / "trn.npz", **trn)
        argv = ["--features_pre", str(tmp_path / "pre.npz"), "--features_trained",
                str(tmp_path / "trn.npz"), "--n_classes", "4"]
        got = tpcs.main(argv + ["--out_dir", str(tmp_path), "--device", CPU])
        (tmp_path / "j").mkdir()
        ref = jpcs.main(argv + ["--out_dir", str(tmp_path / "j")])
        assert ref is None
        ref = dict(np.load(tmp_path / "j" / "data_4way.npz"))
        saved = dict(np.load(tmp_path / "data_4way.npz"))
        assert set(saved) == set(ref)
        for layer in tpcs.LAYERS:
            p, jp = saved[f"{layer}_pretrained_pcs"], ref[f"{layer}_pretrained_pcs"]
            _close(p * np.sign((p * jp).sum(axis=0)), jp)
            np.testing.assert_allclose(saved[f"{layer}_trained_var"],
                                       ref[f"{layer}_trained_var"], rtol=RTOL)
        outputs = iter([tpcs.compute_pca(f[layer], device=CPU)
                        for layer in tpcs.LAYERS for f in (pre, trn)])
        monkeypatch.setattr(jpcs, "compute_pca", lambda *a, **k: next(outputs))
        again = jpcs.run_analysis(pre, trn, 4, str(tmp_path / "again.npz"))
        for k, v in again.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert (tmp_path / "pc_quadrant_pretrained_vs_4way_fc2.png").is_file()


# ── 11. run_all ─────────────────────────────────────────────────────

def test_run_all(tmp_path, monkeypatch):
    """Both mains on the same npz files (fine-grained step included, with
    one embedding stub; the JAX package's figures other than the
    fine-grained one not drawn): the summary rows parsed and compared
    within tolerance, the port's files, and the data each package
    embedded."""
    x, y = _clustered(12, 5, 10, 21)
    synsets = np.array([f"n{i % 7:03d}" for i in range(60)])
    sem = (np.arange(60) % 6 == 5).astype(int)
    paths = []
    for m in range(2):
        rng = np.random.RandomState(22 + m)
        np.savez(tmp_path / f"m{m}.npz", fc2=x * (m + 1) + rng.randn(60, 10).astype(np.float32),
                 conv4=rng.randn(60, 6).astype(np.float32), labels=y)
        paths.append(str(tmp_path / f"m{m}.npz"))
    np.save(tmp_path / "sem.npy", sem)
    np.save(tmp_path / "syn.npy", synsets)
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jfg, "embed_2d", embed_stub(calls["jax"]))
    monkeypatch.setattr(tutils, "embed_2d", embed_stub(calls["torch"]))
    for name in ("plot_metric_comparison", "plot_eigenspectrum", "plot_sparsity_comparison"):
        monkeypatch.setattr(jdim, name, lambda *a, **k: None)  # the JAX figures: not drawn
    monkeypatch.setattr(jvr, "plot_variance_ratio", lambda *a, **k: None)
    import matplotlib.pyplot as plt

    save = plt.savefig
    monkeypatch.setattr(plt, "savefig", lambda path, *a, **k: None if "/j/" in str(path)
                        else save(path, *a, **k))
    argv = ["--features", *paths, "--names", "A", "B", "--sem_labels",
            str(tmp_path / "sem.npy"), "--synsets", str(tmp_path / "syn.npy")]
    jrun.main(argv + ["--out_dir", str(tmp_path / "j")])
    out = trun.main(argv + ["--out_dir", str(tmp_path / "t"), "--device", CPU])
    rows, ref = ([ast.literal_eval(r) for r in np.load(tmp_path / d / "dimensionality_summary.npz")
                  ["rows"]] for d in ("t", "j"))
    assert rows == [{**r, **{k: pytest.approx(v, rel=RTOL) for k, v in r.items()
                             if isinstance(v, float)}} for r in ref]
    assert rows == out["dimensionality"] and out["fine_grained"] == 50
    assert len(calls["torch"]) == len(calls["jax"]) == 2
    for got, r in zip(calls["torch"], calls["jax"]):
        np.testing.assert_array_equal(got, r)
    for name in ("variance_ratio.png", "participation_ratio.png", "sparsity.png",
                 "fine_grained_animals.png", "fine_grained_animals.npz"):
        assert (tmp_path / "t" / name).is_file(), name
    accs = jrun.run_nearest_neighbors([x], y, ["A"], str(tmp_path))
    assert trun.run_nearest_neighbors([x], y, ["A"], str(tmp_path), device=CPU) == accs


def test_clis_need_a_card_unless_cpu_is_asked(tmp_path, jpegs):
    """Each computing CLI defaults to CUDA and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule cannot be observed")
    x, y = _clustered(4, 3, 6, 23)
    np.save(tmp_path / "a.npy", x)
    np.save(tmp_path / "y.npy", y)
    np.savez(tmp_path / "f.npz", fc2=x, conv4=x, fc1=x, labels=y)
    feats = ["--features", str(tmp_path / "a.npy"), "--labels", str(tmp_path / "y.npy")]
    calls = [
        lambda: tnn.main(feats),
        lambda: trsm.main(["--stimuli-dir", str(jpegs), "--out", str(tmp_path / "r.npz")]),
        lambda: ttba.main(["--task-features", str(tmp_path / "a.npy"), "--task-labels",
                           str(tmp_path / "y.npy"), "--brain-features", str(tmp_path / "a.npy"),
                           "--brain-responses", str(tmp_path / "a.npy")]),
        lambda: tpcs.main(["--features_pre", str(tmp_path / "f.npz"), "--features_trained",
                           str(tmp_path / "f.npz"), "--out_dir", str(tmp_path)]),
        lambda: trun.main(["--features", str(tmp_path / "f.npz"), "--out_dir", str(tmp_path)]),
        lambda: tdim.main(["--checkpoint-dir", str(tmp_path), "--cfg-id", "4",
                           "--stimuli-dir", str(jpegs)]),
        lambda: tdm.eigenspectrum(torch.zeros(3, 2).numpy(), device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
