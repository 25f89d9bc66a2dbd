"""The whole NSD RSA eval of the PyTorch port against the JAX package's,
on the CPU, plus the port's standalone and device rules."""
import json
import re
import sqlite3
import subprocess
import sys
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

import visreps_tpu_torch.core.db as tdb
import visreps_tpu_torch.data.neural as tneural
import visreps_tpu_torch.evals as tevals
from visreps_tpu_torch import run as trun
from visreps_tpu_torch.benchmarks import fixture as tfixture
from visreps_tpu_torch.core.config import Config, load_config
from visreps_tpu_torch.device import resolve_device
import visreps_tpu_torch.models.zoo as tzoo
from visreps_tpu_torch.models.convert import params_from_jax, srp_from_jax
from visreps_tpu_torch.models.extractor import FeatureExtractor, configure_feature_extractor
from visreps_tpu_torch.models.standard import AlexNet
from visreps_tpu_torch.ops.srp import SRPTransform

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "visreps_tpu_torch"

TINY = {"N_SHARED": 12, "N_UNIQUE": 20, "N_SUBJECTS": 2, "REGIONS": ["early", "ventral"],
        "N_VOXELS": 8, "N_STIMULI": 12 + 2 * 20, "IMG_SIZE": 64}
SRP_K = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(cls):
    return cls({
        "mode": "eval", "seed": 1, "neural_dataset": "nsd", "subject_idx": [0, 1],
        "shared_test_subjects": [0, 1],
        "region": ["early visual stream", "ventral visual stream"],
        "analysis": "rsa", "compare_method": "spearman", "bootstrap": True,
        "n_bootstrap": 8, "n_select": 10, "batchsize": 16, "num_workers": 2,
        "load_model_from": "torchvision", "model_name": "AlexNet",
        "pretrained_dataset": "none", "extract_pre_and_post": True, "srp_k": SRP_K,
        "uint8_transfer": True, "log_expdata": True, "use_mesh": False,
    })


def _db_rows(path) -> int:
    with sqlite3.connect(str(path)) as conn:
        return conn.execute("SELECT COUNT(*) FROM results").fetchone()[0]


def _block_images(path):
    """Overwrite the fixture brick's pixels with 4 × 4 blocks of random
    colours. Deep-layer RDMs of pixel noise crowd into a narrow band
    (e.g. conv5_post: 66 values within 0.059-0.067, nearest two 4e-7
    apart), where the two packages' f32 Gram sums, which differ by up to
    ~1e-5 at d = 43,264, reorder ranks; block images spread the RDMs, so
    rank statistics can be compared at 1e-4."""
    import h5py

    with h5py.File(path, "r+") as f:
        brick = f["imgBrick"]
        n, h, w, _ = brick.shape
        colours = np.random.RandomState(7).randint(0, 256, (n, 4, 4, 3)).astype(np.uint8)
        brick[...] = np.kron(colours, np.ones((1, h // 4, w // 4, 1), np.uint8))


@pytest.fixture(scope="module")
def nsd_world(tmp_path_factory):
    """Both packages' eval on one tiny on-disk fixture (the JAX bench's
    HDF5 fixture at the scale of tests/test_bench_stages.py), with the
    same weights and SRP matrices: ``run(overrides, name)`` runs the JAX
    eval and then the port's of ``_cfg`` with ``overrides``, each into
    its own results.db (``{jax,torch}_{name}.db``; "base" → jax.db and
    torch.db).

    The port extracts its own SRP store, which is kept for
    TestEvalParity.test_srp_store, and then selects on the JAX eval's
    store: the two packages' f32 taps differ by ~1e-6 (convolution
    order, and XLA's rewrite of the uint8 normalisation), which moves
    a few tap elements across a bf16 rounding boundary before the
    projection. The stores then differ by up to ~1e-3 of their largest
    value, enough to exchange ranks of near-tied RDM entries; on one
    store, selection is held at 1e-4 along the eval's own path. Phase 2
    and scoring run on the port's own exact taps.
    """
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("e2e")
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

        state = jax_init_model("AlexNet", 1000, seed=1, cache=False)
        mp.setattr(jevals, "load_model", lambda cfg, verbose=False: state)
        mp.setattr(jneural, "NSD_STIMULI_HDF5", meta["hdf5"])
        jax_get_activations = JaxExtractor.get_activations

        def keep_jax_store(self, *args, **kwargs):
            acts, ids = jax_get_activations(self, *args, **kwargs)
            stores["jax"] = ({n: np.asarray(a, np.float32) for n, a in acts.items()}, list(ids))
            return acts, ids

        mp.setattr(JaxExtractor, "get_activations", keep_jax_store)
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))

        def load_model(cfg, device=None):
            model = AlexNet()
            model.load_state_dict(params)
            return model.to(device).eval()

        configure = tevals.configure_feature_extractor

        def configure_with_jax_srp(cfg, model, device=None, verbose=False):
            ext = configure(cfg, model, device=device, verbose=verbose)
            jax_srp = JaxSRP(k=cfg.srp_k, seed=0)
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

        mp.setattr(tevals, "load_model", load_model)
        mp.setattr(tevals, "configure_feature_extractor", configure_with_jax_srp)
        mp.setenv("NSD_STIMULI_HDF5", meta["hdf5"])  # the port reads it per call

        def run(overrides: dict, name: str = "base"):
            suffix = "" if name == "base" else f"_{name}"
            mp.setattr(jdb, "RESULTS_DB_PATH", tmp / f"jax{suffix}.db")
            mp.setattr(jevals, "RESULTS_DB_PATH", tmp / f"jax{suffix}.db")
            mp.setattr(tdb, "RESULTS_DB_PATH", tmp / f"torch{suffix}.db")
            jax_results = jevals.eval(_cfg(JaxConfig).merge(overrides))
            return jax_results, tevals.eval(_cfg(Config).merge(overrides), device="cpu")

        yield {"run": run, "tmp": tmp, "stores": stores, "mp": mp}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def both_evals(nsd_world):
    jax_results, torch_results = nsd_world["run"]({})
    return jax_results, torch_results, nsd_world["tmp"], dict(nsd_world["stores"])


def _top_two_gap(result) -> float:
    top2 = sorted(e["score"] for e in result["layer_selection_scores"])[-2:]
    return top2[1] - top2[0]


class TestEvalParity:
    def test_same_pairs_and_db_rows(self, both_evals):
        jax_results, torch_results, tmp, _ = both_evals
        assert len(torch_results) == len(jax_results) == 4
        assert _db_rows(tmp / "torch.db") == _db_rows(tmp / "jax.db") == 4
        assert set(tevals.LAST_PHASE_TIMES) == {
            "model_load_s", "data_load_s", "extraction_s", "extraction_loader_s",
            "phase1_selection_s",
            "phase2_extract_s", "scoring_bootstrap_s"}

    def test_srp_store(self, both_evals):
        """The port's own SRP store against the JAX eval's, at the
        extractor test's tolerance (bf16 rounding of the taps)."""
        jacts, jids = both_evals[3]["jax"]
        tacts, tids = both_evals[3]["torch"]
        assert list(tacts) == list(jacts) and len(tacts) == 14
        assert len(tids) == len(jids) == TINY["N_STIMULI"]
        for name, ref in jacts.items():
            assert tacts[name].shape == ref.shape == (TINY["N_STIMULI"], SRP_K)
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
        """Every pair on the same layer is compared; a pair may differ
        in layer only where its top two selection scores tie to 1e-4."""
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


class TestFixture:
    def test_brick_matches_jax_hdf5(self, tmp_path, monkeypatch):
        import h5py

        for mod, name in ((jfixture, "jax"), (tfixture, "torch")):
            monkeypatch.setattr(mod, "FIXTURE_DIR", tmp_path / name)
            for k, v in TINY.items():
                monkeypatch.setattr(mod, k, v)
        monkeypatch.setattr(jfixture, "N_JPEG", 1)
        jmeta, tmeta = jfixture.ensure_fixture(), tfixture.ensure_fixture()
        brick = tneural.LazyStimulusBrick(tmeta["stimuli"], "imgBrick", range(TINY["N_STIMULI"]))
        hbrick = tneural.LazyStimulusBrick(jmeta["hdf5"], "imgBrick", range(TINY["N_STIMULI"]))
        with h5py.File(jmeta["hdf5"], "r") as f:
            ref = f["imgBrick"][:]
        keys = [str(i) for i in (3, 4, 5, 9, 0)]
        np.testing.assert_array_equal(brick.get_batch(keys), ref[[3, 4, 5, 9, 0]])
        np.testing.assert_array_equal(hbrick.get_batch(keys), ref[[3, 4, 5, 9, 0]])
        np.testing.assert_array_equal(brick["7"], ref[7])
        assert brick.item_spec() == hbrick.item_spec() == ((64, 64, 3), np.uint8)
        assert Path(tmeta["pickle"]).read_bytes() == Path(jmeta["pickle"]).read_bytes()
        brick.close()
        hbrick.close()


class TestStandalone:
    def test_import_does_not_load_jax(self):
        code = (
            "import importlib, pkgutil, sys, visreps_tpu_torch\n"
            "for m in pkgutil.walk_packages(visreps_tpu_torch.__path__, 'visreps_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "new = {'visreps_tpu_torch.models.' + m for m in ('resnet', 'vit', 'ecnet', "
            "'nn_ops', 'torch_import', 'hf_vit', 'pooling')} | {'visreps_tpu_torch.analysis.' + m "
            "for m in ('cross_model_rdms', 'extract_representations', 'compute_eigenspectra', "
            "'compute_twonn_id', 'cross_decomposition', 'metrics')} | "
            "{'visreps_tpu_torch.benchmarks.weights', 'visreps_tpu_torch.ops.metrics', "
            "'visreps_tpu_torch.explore_results', 'visreps_tpu_torch.config'} | "
            "{'visreps_tpu_torch.scripts.' + m for m in ('extract_representations.utils', "
            "'extract_representations.alexnet_representations', "
            "'extract_representations.vit_representations', "
            "'extract_representations.clip_representations', "
            "'extract_representations.dino_representations', "
            "'coarsegrain.compute_eigenvectors', 'coarsegrain.make_pca_labels')} | "
            "{'visreps_tpu_torch.experiments.coarse_grain_benefits.' + m for m in ('utils', "
            "'corruptions', 'linear_probe', 'few_shot', 'class_selectivity', "
            "'augmentation_invariance', 'imagenet_c_robustness', 'curriculum_finetuning', "
            "'curriculum_nsd_rsa', 'plot_curriculum_rsa')} | "
            "{'visreps_tpu_torch.experiments.' + m for m in ("
            "'reconstruction_analysis.run_reconstruction', 'reconstruction_analysis.plot', "
            "'binary_pc_rsa.main', 'binary_pc_rsa.visualize', 'neurips_2025.figutils', "
            "'neurips_2025.fig1.model_reps_rsa_comparisons', "
            "'neurips_2025.fig2.reconstructed_rsa_nsd', 'neurips_2025.fig2.bar_plot_nsd', "
            "'neurips_2025.fig3.reconstructed_rsa_things', 'neurips_2025.fig3.full_vs_pcs_things', "
            "'neurips_2025.fig3.bar_plot_things', 'neurips_2025.fig4.full_vs_pcs_nsd')} | "
            "{'visreps_tpu_torch.experiments.representation_analysis.' + m for m in ("
            "'utils', 'dim_metrics', 'dim_plots', 'dimensionality', 'variance_ratio', "
            "'nearest_neighbors', 'rsm_comparison', 'task_brain_alignment', 'two_pcs_compare', "
            "'run_all')} | "
            "{'visreps_tpu_torch.experiments.semantic_analysis.' + m for m in ("
            "'fine_grained_structure', 'semantic_alignment', 'pc_semantic_analysis', "
            "'plot_semantic_classes_umap')} | "
            "{'visreps_tpu_torch.experiments.' + m for m in ("
            "'wordnet.hierarchy', 'wordnet.wordnet', 'wordnet.make_wordnet_labels', "
            "'wordnet.make_semantic_labels', 'pca_analysis.pca_poles_images', "
            "'pca_analysis.pca_visualization', 'pca_analysis.visualize_class_distribution', "
            "'neurips_2025.fig1.imagenet_pca_schematic')} | "
            "{'visreps_tpu_torch.plotters.' + m for m in ("
            "'plotter_utils', 'plot_helpers', 'plot_architectures', 'nsd.plot_coarseness', "
            "'nsd_synthetic.plot_coarseness', 'things.plot_coarseness', "
            "'tvsd.plot_coarseness')}\n"
            "assert new <= set(sys.modules), new - set(sys.modules)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'transformers', 'visreps_tpu', 'pandas', "
            "'sklearn', 'matplotlib', 'seaborn', 'experiments', 'plotters')]\n"
            "assert not bad, bad\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr

    def test_no_jax_package_imports_in_source(self):
        pattern = re.compile(
            r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|transformers|visreps_tpu|pandas|seaborn"
            r"|experiments|plotters)(\.|\s|$)")
        sources = [p for p in sorted(PKG.rglob("*.py"))
                   if "_build" not in p.relative_to(PKG).parts]  # git-ignored build output
        assert len(sources) > 20
        offenders = [f"{path.relative_to(REPO)}:{i}"
                     for path in sources
                     for i, line in enumerate(path.read_text().splitlines(), 1)
                     if pattern.match(line)]
        assert not offenders

    def test_entry_points_need_a_card_unless_cpu_is_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the no-card rule cannot be observed")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tevals.eval(_cfg(Config))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trun.main(["--mode", "eval", "--override", "load_model_from=torchvision",
                       "pretrained_dataset=none"])
        cfg = _cfg(Config).merge({"return_nodes": ["conv5"]})
        model = AlexNet()
        for call in (lambda: tzoo.init_model(), lambda: tzoo.load_model(cfg),
                     lambda: FeatureExtractor(model, ["conv5"]),
                     lambda: configure_feature_extractor(cfg, model),
                     lambda: SRPTransform(k=8)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
        assert resolve_device("cpu") == torch.device("cpu")
        assert next(tzoo.load_model(cfg, device="cpu").parameters()).device.type == "cpu"
        assert FeatureExtractor(model, ["conv5"], srp_k=8, image_size=64,
                                device="cpu").srp.device == torch.device("cpu")

    @pytest.mark.parametrize("override,item", [
        ({"neural_dataset": "things-behavior", "bootstrap_exact_ties": False},
         "Pearson/Kendall scoring"),
        ({"analysis": "encoding_score", "reconstruct_from_pcs": True}, "Analysis remainder"),
        ({"compare_method": "kendall"}, "Pearson/Kendall scoring"),
        ({"reconstruct_from_pcs": True}, "Analysis remainder"),
        ({"model_name": "CLIPVisionTower"}, "Remaining models"),
    ])
    def test_out_of_slice_configs_raise(self, override, item, nsd_world, monkeypatch):
        """Models outside the port raise NotImplementedError naming their
        ROADMAP.md item. The configurations that raised "Pearson/Kendall
        scoring" or "Analysis remainder" before those items were ported now
        run and agree with the JAX package (selection, point and bootstrap
        scores at 1e-4): the NSD evals whole on the tiny fixture (the
        encoding eval at srp_k 8, which keeps ridge's Woodbury route, on
        the alphas ≥ 1, since its rank-1 reconstructed features leave a
        null space whose roundoff decides smaller alphas); THINGS' setting
        through ``compute_traintest_alignment`` on planted splits."""
        if item == "Remaining models":
            with pytest.raises(NotImplementedError, match=re.escape(item)):
                tevals.eval(_cfg(Config).merge(override), device="cpu")
            return
        tevals._check_slice(_cfg(Config).merge(override))
        if override.get("neural_dataset") == "things-behavior":
            from visreps_tpu.analysis import alignment as jalign
            from visreps_tpu_torch.analysis import alignment as talign

            rng = np.random.RandomState(6)
            acts = {f"L{i}": rng.randn(50, 24).astype(np.float32) for i in range(3)}
            neural = rng.randn(50, 6).astype(np.float32) + acts["L1"][:, :6]
            cfg = {**override, "analysis": "rsa", "n_bootstrap": 8}
            split = [(cls({l: a[sl] for l, a in acts.items()}, neural[sl]))
                     for cls in (talign.AlignmentData, jalign.AlignmentData)
                     for sl in (slice(0, 30), slice(30, 50))]
            got = talign.compute_traintest_alignment(Config(cfg), *split[:2], device="cpu")
            ref = jalign.compute_traintest_alignment(JaxConfig(cfg), *split[2:])
            pairs = [(got[0], ref[0])]
        else:
            if override.get("analysis") == "encoding_score":
                override = {**override, "srp_k": 8}
                from visreps_tpu.analysis import encoding as jenc
                from visreps_tpu.ops import ridge as jridge
                from visreps_tpu_torch.analysis import encoding as tenc
                from visreps_tpu_torch.ops import ridge as tridge

                alphas = jridge.default_alphas()
                for mod in (jridge, tridge, jenc, tenc):
                    monkeypatch.setattr(mod, "default_alphas",
                                        lambda n=20: alphas[alphas >= 1].copy())
            ref, got = nsd_world["run"](override, name=re.sub(r"\W", "", json.dumps(override)))
            assert len(got) == len(ref) == 4
            pairs = list(zip(got, ref))
        for t, j in pairs:
            assert t["compare_method"] == j["compare_method"] and t["analysis"] == j["analysis"]
            ts = [e["score"] for e in t["layer_selection_scores"]]
            np.testing.assert_allclose(ts, [e["score"] for e in j["layer_selection_scores"]],
                                       atol=1e-4)
            if t["layer"] != j["layer"]:
                assert _top_two_gap(j) <= 1e-4
                continue
            assert t["score"] == pytest.approx(j["score"], abs=1e-4)
            assert len(t["bootstrap_scores"]) == len(j["bootstrap_scores"]) == 8
            np.testing.assert_allclose(t["bootstrap_scores"], j["bootstrap_scores"], atol=1e-4)

    def test_cli_reads_the_shared_configs(self):
        cfg = trun.validate_config(load_config(
            REPO / "configs/eval/base.json",
            ["load_model_from=torchvision", "subject_idx=3", "mode=eval"]))
        assert cfg.subject_idx == [3] and cfg.model_name == "AlexNet" and "cfg_id" not in cfg
        with pytest.raises(ValueError):
            trun.validate_config(load_config(REPO / "configs/eval/base.json",
                                                  ["subject_idx=9", "mode=eval"]))
        assert json.loads(json.dumps(cfg.to_dict()))["region"] == list(cfg.region)
