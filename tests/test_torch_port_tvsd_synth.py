"""The TVSD and NSD-Synthetic evals of the PyTorch port against the JAX
package's, on the CPU: the loaders (string TVSD ids through the
selection plan), the fixtures, the validator's rules for both datasets,
the results.db lookup of NSD-selected layers (rows written by the JAX
package are found; a missing row raises), and the whole evals through
the port's CLI on tiny on-disk fixtures: TVSD RSA and encoding score,
and NSD-Synthetic with and without a bootstrap.

Tolerance 1e-4 for scores. As in tests/test_torch_port_e2e.py the port
selects on the JAX eval's SRP store and images are 4 × 4 colour blocks,
decoded by each package's default route (the same C++ decoder where it
builds, else PIL). Test sets hold 30 stimuli: the deep
taps of such images crowd their RDM entries (fc1_post at 10 TVSD test
images: gaps of 1.5e-6, against a 2.5e-6 difference between the two
packages' RDMs of the same taps, from f32 sums in another order), and
one exchanged rank moves a Spearman score over n(n−1)/2 entries by up to
12·(M−1)/(M(M²−1)), M = n(n−1)/2: 6e-3 at n = 10, 6e-5 at n = 30.
"""
import json
import pickle
import shutil
import sqlite3
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import visreps_tpu.core.db as jdb
import visreps_tpu.data.neural as jneural
import visreps_tpu.evals as jevals
import visreps_tpu.native as jnative
from visreps_tpu.benchmarks import fixture as jfixture
from visreps_tpu.core.config import load_config as jax_load_config
from visreps_tpu.core.validate import validate_config as jax_validate
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor
from visreps_tpu.models.zoo import init_model as jax_init_model

import visreps_tpu_torch.core.db as tdb
import visreps_tpu_torch.data.neural as tneural
import visreps_tpu_torch.evals as tevals
from visreps_tpu_torch import run as trun
from visreps_tpu_torch.benchmarks import fixture as tfixture
from visreps_tpu_torch.core.config import load_config
from visreps_tpu_torch.data import loader as tloader
from visreps_tpu_torch.models.convert import params_from_jax
from visreps_tpu_torch.models.standard import AlexNet


REPO = Path(__file__).resolve().parents[1]
BASE = REPO / "configs/eval/base.json"
N_BOOT = 8
TVSD = {"TVSD_CONCEPTS": 10, "TVSD_IMGS_PER_CONCEPT": 3, "TVSD_N_TEST": 30,
        "TVSD_N_SITES": 16, "N_JPEG": 60, "IMG_SIZE": 64}  # 30 train + 30 test images
SYNTH = {"NSDSYN_N_STIMULI": 30, "N_SUBJECTS": 2, "REGIONS": ["early", "ventral"],
         "N_VOXELS": 8, "IMG_SIZE": 64}
REGIONS_NSD = ["early visual stream", "ventral visual stream"]
COMMON = ["load_model_from=torchvision", "model_name=AlexNet", "pretrained_dataset=none",
          "compare_method=spearman", "bootstrap=true", f"n_bootstrap={N_BOOT}",
          "extract_pre_and_post=true", "log_expdata=true", "batchsize=16", "num_workers=2",
          "use_mesh=false"]
TVSD_RSA = ["neural_dataset=tvsd", "subject_idx=[0,1]", 'region=["V1","V4","IT"]',
            "analysis=rsa", "n_select=20", "srp_k=64", "uint8_transfer=true", *COMMON]
TVSD_ENC = ["neural_dataset=tvsd", "subject_idx=[0,1]", 'region=["V1","V4","IT"]',
            "analysis=encoding_score", "srp_k=16", "uint8_transfer=true", *COMMON]
SYN = ["neural_dataset=nsd_synthetic", "subject_idx=[0,1]", f"region={json.dumps(REGIONS_NSD)}",
       "analysis=rsa", "srp_k=64", *COMMON]
# The NSD layers the synthetic eval inherits: 3 unique layers over 4 pairs.
NSD_LAYERS = {("early visual stream", 0): "conv5_post", ("early visual stream", 1): "fc1_pre",
              ("ventral visual stream", 0): "conv2_post", ("ventral visual stream", 1): "conv5_post"}
CLI = ["--mode", "eval", "--device", "cpu", "--config", str(BASE), "--override"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _db_rows(path, dataset):
    with sqlite3.connect(str(path)) as conn:
        return conn.execute("SELECT run_id, region, subject_idx, analysis, compare_method, layer, "
                            "score, ci_low, ci_high FROM results WHERE neural_dataset=? "
                            "ORDER BY region, subject_idx", (dataset,)).fetchall()


def _same_rows(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g[:6] == r[:6]  # run_id, region, subject, analysis, method, layer
        np.testing.assert_allclose(g[6:], r[6:], atol=1e-4)


def _top_two_gap(result) -> float:
    top2 = sorted(e["score"] for e in result["layer_selection_scores"])[-2:]
    return top2[1] - top2[0]


def _same_result(got, ref):
    gsel = {e["layer"]: e["score"] for e in got["layer_selection_scores"]}
    rsel = {e["layer"]: e["score"] for e in ref["layer_selection_scores"]}
    assert list(gsel) == list(rsel)
    np.testing.assert_allclose(list(gsel.values()), list(rsel.values()), atol=1e-4)
    assert got["compare_method"] == ref["compare_method"]
    if got["layer"] != ref["layer"]:  # only where the top two selection scores tie to 1e-4
        assert _top_two_gap(ref) <= 1e-4
        return
    assert got["score"] == pytest.approx(ref["score"], abs=1e-4)
    assert len(got["bootstrap_scores"]) == len(ref["bootstrap_scores"]) == N_BOOT
    np.testing.assert_allclose(got["bootstrap_scores"], ref["bootstrap_scores"], atol=1e-4)
    assert (got["ci_low"], got["ci_high"]) == pytest.approx((ref["ci_low"], ref["ci_high"]),
                                                            abs=1e-4)


def block_pool(paths, size):
    """Overwrite image files (JPEG or PNG) with 4 × 4 blocks of random
    colours."""
    from PIL import Image

    rng = np.random.RandomState(7)
    for p in paths:
        colours = rng.randint(0, 256, (4, 4, 3)).astype(np.uint8)
        Image.fromarray(np.kron(colours, np.ones((size // 4, size // 4, 1), np.uint8))).save(
            p, quality=85)


def _select_on_jax_store(mp, stores):
    """Run the port's selection on the JAX eval's SRP store (its own
    extraction still runs)."""
    configure = tevals.configure_feature_extractor

    def configure_on_jax_store(cfg, model, device=None, verbose=False):
        ext = configure(cfg, model, device=device, verbose=verbose)
        own_get_activations = ext.get_activations

        def select_on_jax_store(loader, store="device", retain_ids=None):
            acts, ids = own_get_activations(loader, store=store, retain_ids=retain_ids)
            jacts, jids = stores["jax"]
            assert [str(i) for i in ids] == [str(i) for i in jids]
            return {n: torch.from_numpy(jacts[n]).to(acts[n].device, acts[n].dtype)
                    for n in acts}, ids

        ext.get_activations = select_on_jax_store
        return ext

    mp.setattr(tevals, "configure_feature_extractor", configure_on_jax_store)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both fixtures at a tiny scale with block images, both packages'
    model loaders on one AlexNet, each package's default decode, and the
    JAX eval's SRP store kept for the port; ``routes`` collects the
    port's decode routes per eval."""
    state = jax_init_model("AlexNet", 1000, seed=1, cache=False)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))

    def load_model(cfg=None, device=None):
        model = AlexNet()
        model.load_state_dict(params)
        return model.to(device).eval()

    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("tvsd_synth")
    stores = {}
    try:
        mp.setattr(jfixture, "FIXTURE_DIR", tmp / "fx")
        for k, v in {**TVSD, **SYNTH}.items():
            mp.setattr(jfixture, k, v)
        tvsd = jfixture.ensure_tvsd_fixture()
        synth = jfixture.ensure_nsd_synthetic_fixture()
        block_pool(sorted((tmp / "fx" / "jpeg").glob("*.jpg")), TVSD["IMG_SIZE"])
        block_pool(sorted((Path(synth["root"]) / "stimuli").glob("*.png")), SYNTH["IMG_SIZE"])
        mp.chdir(tvsd["root"])
        mp.setenv("BONNER_DATASETS_HOME", tvsd["bonner_home"])
        mp.setenv("NSD_SYNTHETIC_DATA_DIR", synth["root"])
        mp.setenv("VISREPS_INIT_CACHE", "0")
        mp.setattr(jevals, "load_model", lambda cfg, verbose=False: state)
        mp.setattr(tevals, "load_model", load_model)
        jax_get_activations = JaxExtractor.get_activations

        def keep_jax_store(self, *args, **kwargs):
            acts, ids = jax_get_activations(self, *args, **kwargs)
            stores["jax"] = ({n: np.asarray(a, np.float32) for n, a in acts.items()}, list(ids))
            return acts, ids

        mp.setattr(JaxExtractor, "get_activations", keep_jax_store)
        _select_on_jax_store(mp, stores)
        yield {"mp": mp, "tmp": tmp, "stores": stores, "tvsd": tvsd, "synth": synth,
               "routes": {}}
    finally:
        mp.undo()


def _use_db(mp, jax_db, torch_db):
    mp.setattr(jdb, "RESULTS_DB_PATH", jax_db)
    mp.setattr(jevals, "RESULTS_DB_PATH", jax_db)
    mp.setattr(tdb, "RESULTS_DB_PATH", torch_db)


def _jax_cfg(overrides):
    return jax_validate(jax_load_config(BASE, [*overrides, "mode=eval"]))


@pytest.fixture(scope="module")
def tvsd_evals(world):
    mp, tmp, stores = world["mp"], world["tmp"], world["stores"]
    out = {}
    for name, overrides in (("rsa", TVSD_RSA), ("encoding", TVSD_ENC)):
        _use_db(mp, tmp / f"jax_{name}.db", tmp / f"torch_{name}.db")
        jax_results = jevals.eval(_jax_cfg(overrides))
        before = Counter(tloader.ROUTES)
        out[name] = (jax_results, trun.main([*CLI, *overrides]), dict(tevals.LAST_PHASE_TIMES))
        world["routes"][f"tvsd_{name}"] = Counter(tloader.ROUTES) - before
    return out


class TestTvsdLoaders:
    def test_load_all_tvsd_data_and_selection_plan_match_jax(self, world):
        subjects, regions = [0, 1], ["V1", "V4", "IT"]
        got = tneural.load_all_tvsd_data(None, subjects, regions)
        ref = jneural.load_all_tvsd_data(None, subjects, regions)
        assert got["shared_test_ids"] == ref["shared_test_ids"] == sorted(
            f"testconcept{j:04d}_00" for j in range(TVSD["TVSD_N_TEST"]))
        assert got["stimuli"] == ref["stimuli"] and len(got["stimuli"]) == 60
        assert all(isinstance(k, str) for k in got["stimuli"])
        for r in regions:
            for s in subjects:
                for split in ("train", "test"):
                    assert list(got["neural"][r][s][split]) == list(ref["neural"][r][s][split])
                    np.testing.assert_array_equal(
                        np.stack(list(got["neural"][r][s][split].values())),
                        np.stack(list(ref["neural"][r][s][split].values())))
        plan = tevals._selection_plan(got["neural"], subjects, regions, got["stimuli"], 20)
        assert plan == jevals._selection_plan(ref["neural"], subjects, regions, ref["stimuli"], 20)[0]
        assert all(len(ids) == 20 for ids in plan.values())
        x = tevals._neural_tensor(got["neural"]["IT"][1]["test"], got["shared_test_ids"])
        assert x.shape == (TVSD["TVSD_N_TEST"], TVSD["TVSD_N_SITES"]) and x.dtype == np.float32

    @pytest.mark.parametrize("dataset", ["tvsd", "things-behavior", "nsd_synthetic", "nsd",
                                         "cusack"])
    def test_get_neural_loader_matches_jax(self, world, dataset, tmp_path, monkeypatch):
        cfg = {"neural_dataset": dataset, "region": "IT", "subject_idx": 1, "batchsize": 8}
        if dataset == "nsd":
            cfg["region"] = "early visual stream"
            meta = tfixture.ensure_fixture(tmp_path, n_shared=3, n_unique=4, n_subjects=2,
                                           n_regions=1, n_voxels=2, img_size=8)
            monkeypatch.setenv("NSD_DATA_DIR", str(Path(meta["pickle"]).parent))
            monkeypatch.setenv("NSD_STIMULI_HDF5", meta["stimuli"])
            monkeypatch.setattr(jneural, "NSD_STIMULI_HDF5", meta["stimuli"])
        elif dataset == "cusack":
            from PIL import Image

            root = tmp_path / "datasets" / "neural" / "cusack2025"
            (root / "display_images").mkdir(parents=True)
            targets = {"IT": {"2month": {f"s{i}": np.full(3, i, np.float32) for i in range(3)}}}
            (root / "fmri_responses.pkl").write_bytes(pickle.dumps(targets))
            for i in range(3):
                Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
                    root / "display_images" / f"s{i}.png")
            monkeypatch.chdir(tmp_path)
        elif dataset == "things-behavior":
            meta = tfixture.ensure_things_fixture(tmp_path, n_concepts=3, imgs_per_concept=2,
                                                  n_jpeg=4, img_size=32)
            monkeypatch.chdir(meta["root"])
        elif dataset == "nsd_synthetic":
            cfg["region"] = "early"
            root = Path(world["synth"]["root"])
            fmri = {"early": {1: {"a": np.ones(3, np.float32), "b": np.zeros(3, np.float32)}}}
            (root / "fmri_responses.pkl").write_bytes(pickle.dumps(fmri))
            images = {"a": np.zeros((8, 8, 3), np.uint8), "c": np.ones((8, 8, 3), np.uint8)}
            (root / "stimuli_subject_1.pkl").write_bytes(pickle.dumps(images))
        got, tdl = tneural.get_neural_loader(cfg)
        ref, jdl = jneural.get_neural_loader(cfg)
        assert tdl.dataset.keys == jdl.dataset.keys and len(tdl.dataset.keys) > 0
        assert (sorted(got) == sorted(ref))
        if dataset in ("tvsd", "nsd"):
            assert list(got["test"]) == list(ref["test"])
        with pytest.raises(ValueError, match="neural_dataset must be"):
            tneural.get_neural_loader({"neural_dataset": "other", "batchsize": 8})

    def test_load_nsd_synthetic_test_data_matches_jax(self, world):
        got = tneural.load_nsd_synthetic_test_data(None, [0, 1], REGIONS_NSD)
        ref = jneural.load_nsd_synthetic_test_data(None, [0, 1], REGIONS_NSD)
        assert got["test_ids"] == ref["test_ids"] and len(got["test_ids"]) == 30
        assert got["stimuli"] == ref["stimuli"] and got["regions"] == ref["regions"]
        for r in REGIONS_NSD:
            for s in (0, 1):
                np.testing.assert_array_equal(np.stack(list(got["neural"][r][s].values())),
                                              np.stack(list(ref["neural"][r][s].values())))


class TestFixtures:
    def test_tvsd_and_synthetic_fixtures_match_jax(self, tmp_path, monkeypatch):
        small = {"TVSD_CONCEPTS": 3, "TVSD_IMGS_PER_CONCEPT": 2, "TVSD_N_TEST": 2,
                 "TVSD_N_SITES": 4, "N_JPEG": 3, "IMG_SIZE": 32, "NSDSYN_N_STIMULI": 3,
                 "N_SUBJECTS": 2, "REGIONS": ["early", "ventral"], "N_VOXELS": 5}
        monkeypatch.setattr(jfixture, "FIXTURE_DIR", tmp_path / "jax")
        for k, v in small.items():
            monkeypatch.setattr(jfixture, k, v)
        jt, js = jfixture.ensure_tvsd_fixture(), jfixture.ensure_nsd_synthetic_fixture()
        tt = tfixture.ensure_tvsd_fixture(tmp_path / "torch", n_concepts=3, imgs_per_concept=2,
                                          n_test=2, n_sites=4, n_jpeg=3, img_size=32)
        ts = tfixture.ensure_nsd_synthetic_fixture(tmp_path / "torch", n_stimuli=3, n_subjects=2,
                                                   n_regions=2, n_voxels=5, img_size=32)
        pkl = Path("datasets/neural/tvsd/fmri_responses.pkl")
        assert (Path(tt["root"]) / pkl).read_bytes() == (Path(jt["root"]) / pkl).read_bytes()
        links = sorted(p.relative_to(jt["bonner_home"])
                       for p in Path(jt["bonner_home"]).rglob("*.jpg"))
        assert links == sorted(p.relative_to(tt["bonner_home"])
                               for p in Path(tt["bonner_home"]).rglob("*.jpg")) and len(links) == 8
        for rel in links:
            assert (Path(tt["bonner_home"]) / rel).read_bytes() == \
                (Path(jt["bonner_home"]) / rel).read_bytes()
        for name in ["nsd_synthetic_data.pkl", *(f"stimuli/synth{i:03d}.png" for i in range(3))]:
            assert (Path(ts["root"]) / name).read_bytes() == (Path(js["root"]) / name).read_bytes()
        assert ts["regions"] == js["regions"] and tt["n_train"] == jt["n_train"] == 6


VALIDATION_CASES = [  # (overrides, raises)
    (["neural_dataset=tvsd", "subject_idx=[0,1]", 'region=["V1","V4","IT"]'], False),
    (["neural_dataset=tvsd", "subject_idx=1", "region=IT"], False),
    (["neural_dataset=tvsd", "subject_idx=2", "region=IT"], True),
    (["neural_dataset=tvsd", "subject_idx=0", "region=V2"], True),
    (["neural_dataset=tvsd", "subject_idx=0", "region=V1", "analysis=encoding_score"], False),
    (["neural_dataset=nsd_synthetic", "subject_idx=[0,7]", 'region=["V1","PPA"]'], False),
    (["neural_dataset=nsd_synthetic", "subject_idx=8", "region=V1"], True),
    (["neural_dataset=nsd_synthetic", "subject_idx=0", "region=IT"], True),
    (["neural_dataset=nsd_synthetic", "subject_idx=0", "region=V1",
      "analysis=encoding_score"], True),
    (["neural_dataset=cusack", "subject_idx=0", "region=V1"], True),
]


class TestValidator:
    @pytest.mark.parametrize("overrides,raises", VALIDATION_CASES)
    def test_rules_match_jax(self, overrides, raises):
        args = ["load_model_from=torchvision", *overrides, "mode=eval"]
        if raises:
            with pytest.raises(ValueError):
                trun.validate_config(load_config(BASE, args))
            with pytest.raises(AssertionError):
                jax_validate(jax_load_config(BASE, args))
            return
        got = trun.validate_config(load_config(BASE, args))
        ref = jax_validate(jax_load_config(BASE, args))
        assert isinstance(got.subject_idx, list) and isinstance(got.region, list)
        assert (got.subject_idx, got.region, got.compare_method) == \
            (ref.subject_idx, ref.region, ref.compare_method)


class TestTvsdEval:
    def test_rsa_results_and_db_rows(self, world, tvsd_evals):
        jax_results, torch_results, phases = tvsd_evals["rsa"]
        assert len(torch_results) == len(jax_results) == 6
        for t, j in zip(torch_results, jax_results):
            assert len(t["layer_selection_scores"]) == 14
            _same_result(t, j)
        tmp = world["tmp"]
        _same_rows(_db_rows(tmp / "torch_rsa.db", "tvsd"), _db_rows(tmp / "jax_rsa.db", "tvsd"))
        assert set(phases) == {"model_load_s", "data_load_s", "extraction_s", "extraction_loader_s",
                               "phase1_selection_s", "phase2_extract_s", "scoring_bootstrap_s"}

    def test_encoding_results_and_db_rows(self, world, tvsd_evals):
        jax_results, torch_results, phases = tvsd_evals["encoding"]
        assert len(torch_results) == len(jax_results) == 6
        for t, j in zip(torch_results, jax_results):
            assert t["analysis"] == j["analysis"] == "encoding_score"
            _same_result(t, j)
        tmp = world["tmp"]
        rows = _db_rows(tmp / "torch_encoding.db", "tvsd")
        _same_rows(rows, _db_rows(tmp / "jax_encoding.db", "tvsd"))
        assert {r[4] for r in rows} == {"pearson"} and "encoding_selection_s" in phases


@pytest.fixture(scope="module")
def synth_evals(world, tvsd_evals):
    """The NSD RSA rows the synthetic eval inherits, written by the JAX
    package into one results.db that each package's eval then reads (a
    copy each); the port once more without a bootstrap."""
    mp, tmp = world["mp"], world["tmp"]
    seeded = tmp / "nsd_rows.db"
    jcfg = _jax_cfg(SYN)
    for (region, subj), layer in NSD_LAYERS.items():
        jdb.save_results([{"layer": layer, "compare_method": "spearman", "score": 0.5,
                           "ci_low": 0.4, "ci_high": 0.6, "analysis": "rsa",
                           "layer_selection_scores": []}],
                         jcfg.merge({"epoch": -1, "cfg_id": "untrained", "neural_dataset": "nsd",
                                     "analysis": "rsa", "subject_idx": subj, "region": region}),
                         db_path=seeded)
    for name in ("jax_syn.db", "torch_syn.db", "torch_syn_noboot.db"):
        shutil.copy(seeded, tmp / name)
    _use_db(mp, tmp / "jax_syn.db", tmp / "torch_syn.db")
    jax_results = jevals.eval(jcfg)
    before = Counter(tloader.ROUTES)
    torch_results = trun.main([*CLI, *SYN])
    world["routes"]["nsd_synthetic"] = Counter(tloader.ROUTES) - before
    phases = dict(tevals.LAST_PHASE_TIMES)
    mp.setattr(tdb, "RESULTS_DB_PATH", tmp / "torch_syn_noboot.db")
    no_boot = trun.main([*CLI, *SYN, "bootstrap=false"])
    return jax_results, torch_results, no_boot, phases


class TestNsdSyntheticEval:
    def test_inherited_layers_scores_and_db_rows(self, world, synth_evals):
        jax_results, torch_results, _, phases = synth_evals
        pairs = [(r, s) for r in REGIONS_NSD for s in (0, 1)]
        assert [t["layer"] for t in torch_results] == [j["layer"] for j in jax_results] == \
            [NSD_LAYERS[p] for p in pairs]
        for t, j in zip(torch_results, jax_results):
            assert t["layer_selection_scores"] == j["layer_selection_scores"] == []
            _same_result(t, j)
        tmp = world["tmp"]
        _same_rows(_db_rows(tmp / "torch_syn.db", "nsd_synthetic"),
                   _db_rows(tmp / "jax_syn.db", "nsd_synthetic"))
        assert set(phases) == {"data_load_s", "model_load_s", "phase2_extract_s",
                               "scoring_bootstrap_s"}

    def test_decode_routes(self, world, tvsd_evals, synth_evals):
        """Every TVSD JPEG and NSD-Synthetic PNG went through the default
        route: the C++ decoder where both packages' builds, else PIL."""
        route = "native" if jnative.native_available() else "pil"
        routes = world["routes"]
        assert set(routes) == {"tvsd_rsa", "tvsd_encoding", "nsd_synthetic"}
        assert all(set(r) == {route} for r in routes.values()), routes

    def test_point_scores_without_bootstrap(self, synth_evals):
        """The batched average-tie point scores equal the grouped
        scoring's point scores."""
        _, torch_results, no_boot, _ = synth_evals
        for got, ref in zip(no_boot, torch_results):
            assert got["layer"] == ref["layer"] and got["ci_low"] is None
            assert "bootstrap_scores" not in got
            assert got["score"] == pytest.approx(ref["score"], abs=1e-6)

    def test_lookup_reads_jax_rows_and_missing_rows_raise(self, world, synth_evals, tmp_path):
        mp = world["mp"]
        cfg = trun.validate_config(load_config(BASE, [*SYN, "mode=eval"]))
        cfg.epoch, cfg.cfg_id = -1, "untrained"
        mp.setattr(tdb, "RESULTS_DB_PATH", world["tmp"] / "nsd_rows.db")
        assert tevals._lookup_nsd_best_layers(cfg, [0, 1], REGIONS_NSD) == {
            r: {s: NSD_LAYERS[(r, s)] for s in (0, 1)} for r in REGIONS_NSD}
        mp.setattr(tdb, "RESULTS_DB_PATH", tmp_path / "empty.db")
        with pytest.raises(ValueError, match="Run NSD eval first"):
            trun.main([*CLI, *SYN])
        with pytest.raises(ValueError, match="Run NSD eval first"):
            tevals._lookup_nsd_best_layers(cfg.merge({"seed": 2}), [0], REGIONS_NSD[:1])
