"""The PyTorch port's semantic analyses against the JAX package's
(``experiments/semantic_analysis/``), on the CPU, on inputs drawn from
numpy seeds at toy widths (n ≤ 64, d ≤ 64; the NSD eval on the JAX
package's tiny HDF5 fixture and a TinyCustomCNN checkpoint).

Tolerances: host numpy parts (the animal data, enrichment tables, PC
poles, L2 rows, colours) exactly; RSA scores within 1e-6 on the same
activations (the port's own SRP store, with the JAX SRP matrices carried
across, at rtol 1e-2, as in ``test_torch_port_e2e.py``); after
``reconstruct_from_pcs`` on that 52-stimulus store within 1e-5 (the
packages' reconstructions part by ~1e-6 of the largest value, as
``test_torch_port_pca.py`` holds them, and move tied RDM ranks by
~2e-6). No t-SNE or UMAP
runs: both packages' ``embed_2d`` is replaced by one stub, and the data
each package hands it is compared.
"""
import builtins
import csv
import json
import sqlite3
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import visreps_tpu.core.db as jdb  # noqa: E402
import visreps_tpu.data.neural as jneural  # noqa: E402
from experiments.semantic_analysis import fine_grained_structure as jfg  # noqa: E402
from experiments.semantic_analysis import pc_semantic_analysis as jpsa  # noqa: E402
from experiments.semantic_analysis import plot_semantic_classes_umap as jumap  # noqa: E402
from experiments.semantic_analysis import semantic_alignment as jsa  # noqa: E402
from experiments.wordnet.make_semantic_labels import SUPER_CATEGORIES  # noqa: E402
from visreps_tpu.benchmarks import fixture as jfixture  # noqa: E402
from visreps_tpu.core.config import Config as JaxConfig  # noqa: E402
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor  # noqa: E402
from visreps_tpu.ops.srp import SRPTransform as JaxSRP  # noqa: E402

import visreps_tpu_torch.core.db as tdb  # noqa: E402
import visreps_tpu_torch.models.extractor as textractor  # noqa: E402
from visreps_tpu_torch.core.config import Config  # noqa: E402
from visreps_tpu_torch.experiments.representation_analysis import utils as tutils  # noqa: E402
from visreps_tpu_torch.experiments.semantic_analysis import (  # noqa: E402
    fine_grained_structure as tfg,
    pc_semantic_analysis as tpsa,
    plot_semantic_classes_umap as tumap,
    semantic_alignment as tsa,
)
from visreps_tpu_torch.models.convert import srp_from_jax  # noqa: E402
from visreps_tpu_torch.models.custom_cnn import TinyCustomCNN  # noqa: E402
from visreps_tpu_torch.train import checkpoint as tckpt  # noqa: E402

RSA_TOL = 1e-6
RECON_TOL = 1e-5
SRP_K = 16
CPU = "cpu"
TINY_NSD = {"N_SHARED": 12, "N_UNIQUE": 20, "N_SUBJECTS": 2, "REGIONS": ["early", "ventral"],
            "N_VOXELS": 8, "N_STIMULI": 12 + 2 * 20, "IMG_SIZE": 64}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def embed_stub(calls):
    """A cheap ``embed_2d`` stand-in that records what it was given."""
    def embed(feats, seed=42, metric="cosine"):
        calls.append(np.array(feats))
        return np.asarray(feats, np.float64)[:, :2] * 3.0, "stub"
    return embed


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages' ``embed_2d`` replaced by recording stubs; the JAX
    modules' figures are laid out but not rendered to files (the port's
    are)."""
    import matplotlib.pyplot as plt

    calls = {"jax": [], "torch": []}
    save = plt.savefig

    def savefig(path, *args, **kwargs):
        if str(path).endswith("/j.png"):
            return None
        return save(path, *args, **kwargs)

    monkeypatch.setattr(plt, "savefig", savefig)
    monkeypatch.setattr(jfg, "embed_2d", embed_stub(calls["jax"]))
    monkeypatch.setattr(jumap, "embed_2d", embed_stub(calls["jax"]))
    monkeypatch.setattr(tutils, "embed_2d", embed_stub(calls["torch"]))
    return calls


def _same_calls(calls):
    assert len(calls["torch"]) == len(calls["jax"]) > 0
    for got, ref in zip(calls["torch"], calls["jax"]):
        np.testing.assert_array_equal(got, ref)


# ── 10. fine-grained structure ──────────────────────────────────────

class TestFineGrained:
    def _inputs(self):
        rng = np.random.RandomState(0)
        sem = np.where(np.arange(64) % 8 == 7, 3, 0)
        synsets = np.array([f"n{(i * 7) % 9:03d}" for i in range(64)])
        feats = [rng.randn(64, 12).astype(np.float32) for _ in range(2)]
        feats[0][5] = 0.0  # a zero row: the 1e-8 floor
        return feats, sem, synsets

    def test_data(self, tmp_path, stubbed, monkeypatch):
        """The data each package embeds and the port's npz (its figure is
        laid out but not rendered here: ``test_main`` renders it)."""
        import matplotlib.pyplot as plt

        monkeypatch.setattr(plt, "savefig", lambda *a, **k: None)
        feats, sem, synsets = self._inputs()
        n_t = tfg.analyze_fine_grained_structure(feats, sem, synsets, str(tmp_path / "t.png"),
                                                 model_names=["A", "B"], top_k=4)
        n_j = jfg.analyze_fine_grained_structure(feats, sem, synsets, str(tmp_path / "j.png"),
                                                 model_names=["A", "B"], top_k=4)
        assert n_t == n_j == 56
        _same_calls(stubbed)
        data = np.load(tmp_path / "t.npz")
        assert data["model_names"].tolist() == ["A", "B"]
        np.testing.assert_array_equal(data["animal_mask"], sem == 0)
        unique, counts = np.unique(synsets[sem == 0], return_counts=True)
        np.testing.assert_array_equal(data["top_synsets"], unique[np.argsort(counts)[::-1][:4]])
        np.testing.assert_array_equal(data["rows_1"], stubbed["jax"][1])

    def test_too_few_animals_and_no_backend(self, tmp_path, stubbed, monkeypatch, capsys):
        feats, sem, synsets = self._inputs()
        out = str(tmp_path / "few.png")
        assert tfg.analyze_fine_grained_structure(feats, sem, synsets, out, min_images=60) == \
            jfg.analyze_fine_grained_structure(feats, sem, synsets, out, min_images=60) == 56
        assert not (tmp_path / "few.npz").exists()
        monkeypatch.setitem(sys.modules, "umap", None)
        monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
        tfg.analyze_fine_grained_structure(feats, sem, synsets, out, min_images=10)
        assert (tmp_path / "few.npz").is_file() and not (tmp_path / "few.png").exists()
        assert "nothing embedded" in capsys.readouterr().out
        assert stubbed["torch"] == []

    def test_main(self, tmp_path, stubbed):
        feats, sem, synsets = self._inputs()
        for i, f in enumerate(feats):
            np.savez(tmp_path / f"m{i}.npz", fc2=f, labels=np.zeros(64))
        np.save(tmp_path / "sem.npy", sem)
        np.save(tmp_path / "syn.npy", synsets)
        argv = ["--features", str(tmp_path / "m0.npz"), str(tmp_path / "m1.npz"),
                "--sem_labels", str(tmp_path / "sem.npy"), "--synsets",
                str(tmp_path / "syn.npy"), "--names", "A", "B"]
        assert tfg.main(argv + ["--out", str(tmp_path / "t.png")]) == 56
        jfg.main(argv + ["--out", str(tmp_path / "j.png")])
        _same_calls(stubbed)
        assert (tmp_path / "t.png").is_file() and (tmp_path / "t.npz").is_file()


# ── 12. semantic alignment ──────────────────────────────────────────

class TestSemanticAlignmentScores:
    def _inputs(self):
        rng = np.random.RandomState(1)
        ids = [f"s{i}" for i in range(40)]
        emb = {sid: rng.randn(24).astype(np.float32) for sid in ids[:36]}
        acts = {"fc1": rng.randn(40, 32).astype(np.float32),
                "fc2": np.concatenate([np.stack([emb[s] for s in ids[:36]]),
                                       rng.randn(4, 24).astype(np.float32)], 0)
                + 0.3 * rng.randn(40, 24).astype(np.float32)}
        return acts, emb, ids

    @pytest.mark.parametrize("recon,method", [(False, "spearman"), (True, "spearman"),
                                              (False, "pearson")])
    def test_scores(self, recon, method):
        acts, emb, ids = self._inputs()
        cfg = {"compare_method": method, "reconstruct_from_pcs": recon, "pca_k": 5}
        got = tsa.semantic_alignment_scores(Config(cfg), acts, emb, ids, device=CPU)
        ref = jsa.semantic_alignment_scores(JaxConfig(cfg), acts, emb, ids)
        assert [{**r, "score": None} for r in got] == [{**r, "score": None} for r in ref]
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in ref],
                                   rtol=0, atol=RSA_TOL)
        by_layer = {r["layer"]: r["score"] for r in got}
        assert by_layer["fc2"] > 0.5 > by_layer["fc1"]

    def test_load_embeddings(self, tmp_path):
        np.savez(tmp_path / "e.npz", stimulus_ids=np.array([3, 17, 29]),
                 gemini_representations=np.arange(6.0).reshape(3, 2))
        got, ref = tsa.load_embeddings(str(tmp_path / "e.npz")), \
            jsa.load_embeddings(str(tmp_path / "e.npz"))
        assert list(got) == list(ref) == ["3", "17", "29"]
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
        with pytest.raises(ValueError, match="device"):
            tsa.semantic_alignment_scores(Config({}), {"a": np.ones((3, 2))},
                                          {"x": np.ones(2)}, ["x", "y", "z"])


@pytest.fixture(scope="module")
def nsd_eval(tmp_path_factory):
    """Both packages' ``semantic_alignment.eval`` (and ``main``, which
    raises alike in both on NSD) on the tiny NSD fixture, with a seeded caption-embedding npz and a
    TinyCustomCNN checkpoint, each into its own results.db; the port's
    extractor carries the JAX SRP matrices and, after its own store is
    recorded, scores the JAX store."""
    import h5py

    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("sem_nsd")
    stores = {}
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
        mp.setattr(jdb, "RESULTS_DB_PATH", tmp / "jax.db")
        mp.setattr(tdb, "RESULTS_DB_PATH", tmp / "torch.db")

        model = TinyCustomCNN(num_classes=64)
        model.init_weights(torch.Generator().manual_seed(3))
        (tmp / "ck" / "cfg64a").mkdir(parents=True)
        tckpt.save_checkpoint(str(tmp / "ck" / "cfg64a"), 20, model, {}, {"seed": 1})
        rng = np.random.RandomState(8)
        ids = np.arange(TINY_NSD["N_STIMULI"])
        np.savez(tmp / "gemini.npz", stimulus_ids=ids,
                 gemini_representations=rng.randn(len(ids), 24).astype(np.float32))
        cfg = {"mode": "eval", "neural_dataset": "nsd", "region": "early visual stream",
               "subject_idx": 0, "load_model_from": "checkpoint", "seed": 1, "cfg_id": 64,
               "model_name": "TinyCustomCNN",
               "checkpoint_dir": str(tmp / "ck"), "checkpoint_model": "checkpoint_epoch_20.pth",
               "return_nodes": ["fc1", "fc2"], "extract_pre_and_post": True,
               "srp_k": SRP_K, "batchsize": 16, "num_workers": 2, "compare_method": "spearman",
               "gemini_features_path": str(tmp / "gemini.npz"), "log_expdata": True,
               "analysis": "rsa", "reconstruct_from_pcs": False, "pca_k": 3}

        jax_get = JaxExtractor.get_activations

        def keep_jax(self, *args, **kwargs):
            acts, ids_ = jax_get(self, *args, **kwargs)
            stores["jax"] = ({n: np.asarray(a, np.float32) for n, a in acts.items()}, list(ids_))
            return acts, ids_

        mp.setattr(JaxExtractor, "get_activations", keep_jax)
        configure = textractor.configure_feature_extractor

        def configure_with_jax_srp(cfg_, model_, device=None, verbose=False):
            ext = configure(cfg_, model_, device=device, verbose=verbose)
            jsrp = JaxSRP(k=SRP_K, seed=0)
            srp_from_jax(ext.srp, {d: tuple(np.asarray(c, np.float32)
                                            for c in jsrp.matrix_chunks(d))
                                   for d in set(ext.tap_dims.values())})
            own = ext.get_activations

            def on_jax_store(loader, store="device", retain_ids=None):
                acts, ids_ = own(loader, store=store, retain_ids=retain_ids)
                stores["torch"] = ({n: a.float().cpu().numpy() for n, a in acts.items()}, ids_)
                jacts, jids = stores["jax"]
                assert [str(i) for i in ids_] == [str(i) for i in jids]
                return {n: torch.from_numpy(jacts[n]) for n in acts}, ids_

            ext.get_activations = on_jax_store
            return ext

        mp.setattr(textractor, "configure_feature_extractor", configure_with_jax_srp)
        # the JAX eval once; its reconstruction rows from the same store, as its
        # eval makes and saves them
        jrows = [jsa.eval(JaxConfig(cfg))]
        jcfg = JaxConfig({**cfg, "reconstruct_from_pcs": True})
        jacts, jids = stores["jax"]
        jrows.append(jsa.semantic_alignment_scores(
            jcfg, jacts, jsa.load_embeddings(cfg["gemini_features_path"]), jids))
        jdb.save_results(jrows[1], jcfg)
        # the port's eval once; its reconstruction rows from the same store
        trows = [tsa.eval(Config(cfg), device=CPU)]
        tcfg = Config({**cfg, "reconstruct_from_pcs": True})
        tacts, tids = stores["torch"]
        trows.append(tsa.semantic_alignment_scores(
            tcfg, {n: torch.from_numpy(jacts[n]) for n in tacts},
            tsa.load_embeddings(cfg["gemini_features_path"]), tids))
        tdb.save_results(trows[1], tcfg)
        # main: validate_config turns region and subject_idx into lists, which
        # the NSD loader cannot index; both packages raise alike
        overrides = [f"{k}={json.dumps(v) if not isinstance(v, str) else v}"
                     for k, v in cfg.items()]
        errors = []
        for fn, extra in ((jsa.main, []), (tsa.main, ["--device", CPU])):
            with pytest.raises(TypeError, match="unhashable type: 'list'") as info:
                fn(["--config", str(REPO / "configs/eval/base.json"), "--override",
                    *overrides] + extra)
            errors.append(str(info.value))
        assert errors[0] == errors[1]
        yield jrows, trows, tmp, stores
    finally:
        mp.undo()


def _db_rows(path):
    with sqlite3.connect(str(path)) as conn:
        conn.row_factory = sqlite3.Row
        rows = [dict(r) for r in conn.execute("SELECT * FROM results")]
    return sorted(rows, key=lambda r: (r["layer"], str(r.get("reconstruct_from_pcs"))))


class TestSemanticAlignmentEval:
    def test_port_store(self, nsd_eval):
        _, _, _, stores = nsd_eval
        (jacts, jids), (tacts, tids) = stores["jax"], stores["torch"]
        assert list(tacts) == list(jacts) and len(tacts) == 4
        assert [str(i) for i in tids] == [str(i) for i in jids]
        for name, ref in jacts.items():
            np.testing.assert_allclose(tacts[name], ref, rtol=1e-2,
                                       atol=1e-2 * np.abs(ref).max(), err_msg=name)

    def test_scores_and_db_rows(self, nsd_eval):
        jrows, trows, tmp, _ = nsd_eval
        for got, ref, tol in zip(trows, jrows, (RSA_TOL, RECON_TOL)):
            assert [r["layer"] for r in got] == [r["layer"] for r in ref]
            np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in ref],
                                       rtol=0, atol=tol)
        tdb_rows, jdb_rows = _db_rows(tmp / "torch.db"), _db_rows(tmp / "jax.db")
        assert len(tdb_rows) == len(jdb_rows) == 8
        skip = {"id", "timestamp", "score", "run_id"}
        for t, j in zip(tdb_rows, jdb_rows):
            assert {k: v for k, v in t.items() if k not in skip} == \
                {k: v for k, v in j.items() if k not in skip}
            assert t["score"] == pytest.approx(j["score"], abs=RECON_TOL)


# ── 13. PC-pole enrichment ──────────────────────────────────────────

class TestPcSemantic:
    def _files(self, tmp_path):
        rng = np.random.RandomState(2)
        n, d = 60, 8
        names = np.array([f"n{i % 5:08d}_{i}.JPEG" for i in range(n)])
        cats = np.array(["animal.n.01", "plant.n.02", "tool.n.01"])[np.arange(n) % 3]
        feats = rng.randn(n, d).astype(np.float32)
        eig = np.linalg.qr(rng.randn(d, d))[0].astype(np.float32)
        feats[cats == "animal.n.01"] += 3.0 * eig[:, 1]
        np.savez(tmp_path / "features_m.npz", features=feats, image_names=names.astype("S"))
        np.savez(tmp_path / "eig.npz", eigenvectors=eig, mean=feats.mean(0))
        with open(tmp_path / "cats.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["image", "category"])
            for nm, c in list(zip(names, cats))[:-3]:
                w.writerow([nm, c])
        return names, cats

    def test_host_parts(self, tmp_path):
        names, cats = self._files(tmp_path)
        assert tpsa.csv_ancestors(names, str(tmp_path / "cats.csv")) == \
            jpsa.csv_ancestors(names, str(tmp_path / "cats.csv"))
        scores = np.random.RandomState(3).randn(len(names))
        anc = list(cats)
        for pct in (10, 20):
            assert tpsa.analyze_pc(scores, anc, pct) == jpsa.analyze_pc(scores, anc, pct)

    def test_wordnet_raises_alike(self, monkeypatch):
        real_import = builtins.__import__
        errors = []
        for missing in (True, False):
            def fake_import(name, *args, **kwargs):
                if name.startswith("nltk") and missing:
                    raise ImportError("No module named 'nltk'")
                if name.startswith("nltk"):
                    raise LookupError("Resource wordnet not found.")
                return real_import(name, *args, **kwargs)

            monkeypatch.setattr(builtins, "__import__", fake_import)
            for fn in (jpsa.wordnet_ancestors, tpsa.wordnet_ancestors):
                with pytest.raises((ImportError, LookupError)) as info:
                    fn(["n01440764_1.JPEG"], 6)
                errors.append(info.type)
            monkeypatch.setattr(builtins, "__import__", real_import)
        assert errors == [ImportError, ImportError, LookupError, LookupError]

    def test_main(self, tmp_path):
        self._files(tmp_path)
        argv = ["--features", str(tmp_path / "features_m.npz"), "--eigenvectors",
                str(tmp_path / "eig.npz"), "--pc", "2", "--ancestors-csv",
                str(tmp_path / "cats.csv")]
        got = tpsa.main(argv + ["--out-dir", str(tmp_path / "t")])
        ref = jpsa.main(argv + ["--out-dir", str(tmp_path / "j")])
        assert got == ref
        assert got["high_enriched"][0]["category"] == "animal"
        assert (tmp_path / "t" / "pc2_histogram.png").is_file()
        data = json.loads((tmp_path / "t" / "pc2_histogram.json").read_text())
        assert data["n_total"] == 60 and data["low_enriched"] == got["low_enriched"]


# ── 14. semantic-class embedding grid ───────────────────────────────

class TestUmapGrid:
    def test_constants_and_helpers(self):
        from visreps_tpu_torch.experiments.wordnet import make_semantic_labels as tsem

        assert tumap.SUPER_CATEGORIES is tsem.SUPER_CATEGORIES  # one table, in wordnet/
        assert list(tumap.SUPER_CATEGORIES.items()) == list(SUPER_CATEGORIES.items())
        assert tumap.CATEGORY_NAMES == jumap.CATEGORY_NAMES == list(SUPER_CATEGORIES)
        for name in ("ZOOM_PERCENTILE", "POINT_SIZE", "POINT_ALPHA", "DEFAULT_NAMES"):
            assert getattr(tumap, name) == getattr(jumap, name)
        for n in (3, 8, 15, 25):
            assert tumap.generate_category_colors(n) == jumap.generate_category_colors(n)
        x = np.random.RandomState(4).randn(10, 6).astype(np.float32)
        x[2] = 0
        np.testing.assert_array_equal(tumap.l2_normalize(x), jumap.l2_normalize(x))

    def test_main(self, tmp_path, stubbed):
        rng = np.random.RandomState(5)
        labels = rng.randint(-1, 8, 50)
        paths = []
        for i in range(3):
            np.savez(tmp_path / f"m{i}.npz", fc2=rng.randn(50, 12).astype(np.float32))
            paths.append(str(tmp_path / f"m{i}.npz"))
        np.save(tmp_path / "y.npy", labels)
        argv = ["--features", *paths, "-", "--labels", str(tmp_path / "y.npy"),
                "--names", "4-way", "8-way", "16-way", "gone"]
        got = tumap.main(argv + ["--out", str(tmp_path / "t.png")])
        jumap.main(argv + ["--out", str(tmp_path / "j.png")])
        _same_calls(stubbed)
        assert got[-1] is None and got[0].shape == ((labels >= 0).sum(), 2)
        data = np.load(tmp_path / "t.npz")
        np.testing.assert_array_equal(data["labels"], labels[labels >= 0])
        assert "rows_3" not in data and data["model_names"].tolist()[-1] == "gone"
        assert (tmp_path / "t.png").is_file()
