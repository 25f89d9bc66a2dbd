"""The THINGS eval of the PyTorch port against the JAX package's, on the
CPU: concept means (the device segment mean, the host mean and the JAX
package's), the exact single-layer taps and their device-averaged
concept means, ``single_pair_scoring`` and the RDM correlations on tied
and extreme RDMs, ``compute_rsa`` on both scoring paths with and without
an ``n_select`` draw, the fixture, the validator's THINGS rules, and the
whole eval through the port's CLI on a tiny on-disk fixture.

Tolerances: concept means 1e-6 of the largest value (f32 sums in
another order); taps 1e-4 of the largest (the packages' convolutions sum
in other orders, ~1e-6); rank statistics on identical RDMs 1e-5; the
whole eval 1e-4, selecting on the JAX eval's SRP store as
tests/test_torch_port_e2e.py does.
"""
import pickle
import sqlite3
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visreps_tpu.core.db as jdb
import visreps_tpu.evals as jevals
import visreps_tpu.native as jnative
from visreps_tpu.analysis import alignment as jalign
from visreps_tpu.analysis import rsa as jrsa
from visreps_tpu.benchmarks import fixture as jfixture
from visreps_tpu.core.config import load_config as jax_load_config
from visreps_tpu.core.validate import validate_config as jax_validate
from visreps_tpu.data.loader import make_stimuli_loader as jax_loader
from visreps_tpu.data.transforms import get_transform as jax_transform
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor
from visreps_tpu.models.zoo import init_model as jax_init_model
from visreps_tpu.ops import bootstrap as jboot
from visreps_tpu.ops import rdm as jrdm

import visreps_tpu_torch.core.db as tdb
import visreps_tpu_torch.evals as tevals
from visreps_tpu_torch import run as trun
from visreps_tpu_torch.analysis import alignment as talign
from visreps_tpu_torch.analysis import rsa as trsa
from visreps_tpu_torch.benchmarks import fixture as tfixture
from visreps_tpu_torch.core.config import Config, load_config
from visreps_tpu_torch.data import loader as tloader
from visreps_tpu_torch.data.loader import make_stimuli_loader
from visreps_tpu_torch.data.neural import load_things_data
from visreps_tpu_torch.data.transforms import get_transform
from visreps_tpu_torch.models.convert import params_from_jax
from visreps_tpu_torch.models.extractor import FeatureExtractor
from visreps_tpu_torch.models.standard import AlexNet
from visreps_tpu_torch.ops import bootstrap as tboot
from visreps_tpu_torch.ops import rdm as trdm

REPO = Path(__file__).resolve().parents[1]
BASE = REPO / "configs/eval/base.json"
N_BOOT = 8
# 40 concepts × 3 images (a JPEG each): 8 selection and 32 evaluation concepts
TINY = {"THINGS_CONCEPTS": 40, "THINGS_IMGS_PER_CONCEPT": 3, "N_JPEG": 120, "IMG_SIZE": 64}
OVERRIDES = ["neural_dataset=things-behavior", "load_model_from=torchvision",
             "model_name=AlexNet", "pretrained_dataset=none", "analysis=rsa",
             "compare_method=spearman", "bootstrap=true", f"n_bootstrap={N_BOOT}", "srp_k=64",
             "extract_pre_and_post=true", "uint8_transfer=true", "log_expdata=true",
             "batchsize=16", "num_workers=2", "use_mesh=false"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def block_image(rng, size):
    """4 × 4 blocks of random colours: deep-layer RDMs of such images are
    spread out, so the two packages' ~1e-6 tap differences do not reorder
    their ranks (tests/test_torch_port_e2e.py)."""
    colours = rng.randint(0, 256, (4, 4, 3)).astype(np.uint8)
    return np.kron(colours, np.ones((size // 4, size // 4, 1), np.uint8))


def block_pool(paths, size):
    """Overwrite image files (JPEG or PNG) with block images."""
    from PIL import Image

    rng = np.random.RandomState(7)
    for p in paths:
        Image.fromarray(block_image(rng, size)).save(p, quality=85)


@pytest.fixture(scope="module")
def alexnet():
    """One AlexNet's JAX state and the port's copy of its weights."""
    state = jax_init_model("AlexNet", 1000, seed=1, cache=False)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))

    def load_model(cfg=None, device=None):
        model = AlexNet()
        model.load_state_dict(params)
        return model.to(device).eval()

    return state, load_model


# ── concept means, exact taps and their device means ──

def _concepts(rng, n_concepts=6, per=3, orphan=True):
    keys = [f"concept{c:02d}_{i}" for c in range(n_concepts) for i in range(per)]
    if orphan:
        keys.append("orphan_img")  # belongs to no concept: the segment mean's dump row
    targets = {
        "embeddings": {f"concept{c:02d}": rng.randn(8).astype(np.float32)
                       for c in range(n_concepts)},
        "image_ids": {f"concept{c:02d}": [f"concept{c:02d}_{i}" for i in range(per)]
                      for c in range(n_concepts)},
    }
    return keys, targets


class TestConceptMeans:
    def test_segment_mean_host_mean_and_jax_agree(self):
        rng = np.random.RandomState(0)
        keys, targets = _concepts(rng)
        targets["image_ids"]["concept99"] = ["missing_img"]  # matched by no key: dropped
        acts = {f"tap{t}": rng.randn(len(keys), 16).astype(np.float32) for t in range(3)}
        ref = jalign.prepare_concept_alignment({}, acts, targets, keys)
        seg = talign.prepare_concept_alignment({}, {k: torch.from_numpy(v) for k, v in acts.items()},
                                               targets, keys)
        host = talign.prepare_concept_alignment({}, acts, targets, keys)
        for got in (seg, host):
            assert got.stimulus_ids == ref.stimulus_ids == [f"concept{c:02d}" for c in range(6)]
            assert got.concept_image_ids == ref.concept_image_ids
            np.testing.assert_array_equal(got.neural, ref.neural)
            for layer in acts:
                _close(np.asarray(got.activations[layer]), ref.activations[layer], 1e-6)
        assert all(isinstance(a, torch.Tensor) and a.dtype == torch.float32
                   for a in seg.activations.values())
        assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
                   for a in host.activations.values())

    def test_bf16_store_averages_in_f32(self):
        rng = np.random.RandomState(1)
        keys, targets = _concepts(rng, orphan=False)
        x = torch.from_numpy(rng.randn(len(keys), 32).astype(np.float32)).to(torch.bfloat16)
        got = talign.prepare_concept_alignment({}, {"t": x}, targets, keys).activations["t"]
        ref = jalign.prepare_concept_alignment(
            {}, {"t": jnp.asarray(x.float().numpy(), jnp.bfloat16)}, targets, keys).activations["t"]
        assert got.dtype == torch.float32
        _close(got.numpy(), np.asarray(ref), 1e-6)

    def test_concept_average_exact_matches_jax(self):
        rng = np.random.RandomState(2)
        keys, targets = _concepts(rng)
        raw = rng.randn(len(keys), 10).astype(np.float32)
        order = ["concept03", "concept00", "concept05"]
        data = talign.AlignmentData({}, np.zeros((3, 1)), stimulus_ids=order,
                                    concept_image_ids={c: targets["image_ids"][c] for c in order})
        got = trsa.concept_average_exact(raw, keys, data)
        ref = jrsa.concept_average_exact(raw, keys, data)
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def extractors(alexnet):
    """Both packages' extractors (same AlexNet, taps conv5 and fc1) and
    loaders over 7 concepts × 3 block images, 64 px."""
    state, load_model = alexnet
    rng = np.random.RandomState(3)
    keys, targets = _concepts(rng, n_concepts=7)
    stimuli = {k: block_image(rng, 64) for k in keys}
    jex = JaxExtractor(state, ["conv5", "fc1"], srp_k=32, batch_size=8, image_size=224)
    tex = FeatureExtractor(load_model(), ["conv5", "fc1"], srp_k=32, device="cpu")
    return (jex, jax_loader(stimuli, jax_transform("imgnet"), 8, 2),
            tex, make_stimuli_loader(stimuli, get_transform("imgnet"), 8, 2), keys, targets)


class TestSingleLayer:
    def test_extract_single_layer_matches_jax(self, extractors):
        jex, jdl, tex, tdl, keys, _ = extractors
        want = [keys[5], keys[0], "absent_img", keys[11]]  # reordered, one absent
        got, got_ids = tex.extract_single_layer(tdl, "conv5_post", want)
        ref, ref_ids = jex.extract_single_layer(jdl, "conv5_post", want)
        assert got_ids == ref_ids == [keys[5], keys[0], keys[11]]
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        _close(got, np.asarray(ref), 1e-4)

    def test_extract_single_layer_mean_matches_jax_and_host(self, extractors):
        jex, jdl, tex, tdl, keys, targets = extractors
        # a dropped concept and a reordered one: their images land in the dump row
        order = [f"concept{c:02d}" for c in (3, 0, 6, 5, 1, 2)]
        groups = {c: targets["image_ids"][c] for c in order}
        got, got_order = tex.extract_single_layer_mean(tdl, "fc1_pre", groups, order)
        ref, _ = jex.extract_single_layer_mean(jdl, "fc1_pre", groups, order)
        assert got_order == order and got.dtype == torch.float32
        _close(got.numpy(), np.asarray(ref), 1e-4)
        raw, raw_ids = tex.extract_single_layer(tdl, "fc1_pre")
        data = talign.AlignmentData({}, np.zeros((len(order), 1)), stimulus_ids=order,
                                    concept_image_ids=groups)
        _close(got.numpy(), trsa.concept_average_exact(raw, raw_ids, data), 1e-6)


# ── scoring: single pair, RDM correlations, compute_rsa ──

def _sign_rows(rng, n, d=64, dup=4):
    """(n, d) rows of ±1 with zero mean, the first ``dup`` repeated
    (scaled) and negated further down: every correlation is k/32 exactly
    in f32 in both packages, with ±1 among them, so the RDMs are tied,
    hold 0 and 2, and are identical bit for bit."""
    base = np.tile(np.r_[np.ones(d // 2), -np.ones(d // 2)], (n, 1))
    x = np.stack([rng.permutation(row) for row in base]).astype(np.float32)
    x[n - dup:] = -x[:dup]
    x[n - 2 * dup:n - dup] = 3 * x[:dup]
    return x


class TestScoring:
    @pytest.mark.parametrize("kind", ["tied", "random"])
    def test_single_pair_scoring_matches_jax(self, kind):
        rng = np.random.RandomState(4)
        n = 24
        if kind == "tied":
            model, neural = _sign_rows(rng, n), _sign_rows(rng, n, d=32, dup=3)
        else:
            model, neural = rng.randn(n, 40).astype(np.float32), rng.randn(n, 9).astype(np.float32)
        idx = jboot.bootstrap_indices(n, 16, seed=42)
        boot, point = tboot.single_pair_scoring(torch.from_numpy(model), neural, idx)
        jb, jp = jboot.single_pair_scoring(model, neural, idx)
        assert boot.dtype == np.float64 and boot.shape == (16,)
        assert point == pytest.approx(jp, abs=1e-5)
        np.testing.assert_allclose(boot, jb, atol=1e-5)

    @pytest.mark.parametrize("correlation", ["spearman", "spearman_dense", "pearson"])
    def test_rdm_correlations_match_jax_on_tied_rdms(self, correlation):
        rng = np.random.RandomState(5)
        rdms = [np.array(jrdm.compute_rdm(_sign_rows(rng, 20))) for _ in range(4)]
        assert any((r == 0).sum() > 20 for r in rdms) and any((r == 2).any() for r in rdms)
        got = trdm.compute_rdm_correlation(torch.from_numpy(rdms[0]), torch.from_numpy(rdms[1]),
                                           correlation)
        ref = jrdm.compute_rdm_correlation(jnp.asarray(rdms[0]), jnp.asarray(rdms[1]), correlation)
        assert got == pytest.approx(float(ref), abs=1e-5)
        a, b = np.stack(rdms[:2]), np.stack(rdms[2:])
        got_b = trdm.compute_rdm_correlation_batched(torch.from_numpy(a), torch.from_numpy(b),
                                                     correlation)
        ref_b = jrdm.compute_rdm_correlation_batched(jnp.asarray(a), jnp.asarray(b), correlation)
        np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), atol=1e-5)

    def test_kendall_and_bad_shapes_raise(self):
        """Kendall tau-a of tied RDMs (single and batched) agrees with the
        JAX package's within 1e-6 (the port counts exactly; JAX sums its
        counts in f32); ``compute_rdm`` still refuses Kendall; bad shapes
        raise."""
        rng = np.random.RandomState(5)
        rdms = [np.array(jrdm.compute_rdm(_sign_rows(rng, 20))) for _ in range(4)]
        got = trdm.compute_rdm_correlation(torch.from_numpy(rdms[0]), torch.from_numpy(rdms[1]),
                                           "kendall")
        ref = jrdm.compute_rdm_correlation(jnp.asarray(rdms[0]), jnp.asarray(rdms[1]), "kendall")
        assert got == pytest.approx(float(ref), abs=1e-6)
        a, b = np.stack(rdms[:2]), np.stack(rdms[2:])
        got_b = trdm.compute_rdm_correlation_batched(torch.from_numpy(a), torch.from_numpy(b),
                                                     "kendall")
        ref_b = jrdm.compute_rdm_correlation_batched(jnp.asarray(a), jnp.asarray(b), "kendall")
        np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), atol=1e-6)
        r = torch.zeros((4, 4))
        with pytest.raises(ValueError, match="Pearson"):
            trdm.compute_rdm(r, "kendall")
        with pytest.raises(ValueError):
            trdm.compute_rdm_correlation(r, r, "cosine")
        with pytest.raises(ValueError):
            trdm.compute_rdm_correlation(r, torch.zeros((3, 3)))
        assert np.isnan(trdm.compute_rdm_correlation(torch.zeros((1, 1)), torch.zeros((1, 1))))


def _splits(rng, n_sel=30, n_eval=20, d=24, v=6):
    layers = {f"L{i}": rng.randn(n_sel + n_eval, d).astype(np.float32) for i in range(3)}
    neural = rng.randn(n_sel + n_eval, v).astype(np.float32)
    neural += layers["L1"][:, :v]  # plant L1
    return [talign.AlignmentData({l: a[sl] for l, a in layers.items()}, neural[sl],
                                 stimulus_ids=[str(i) for i in range(sl.start or 0, sl.stop)])
            for sl in (slice(0, n_sel), slice(n_sel, n_sel + n_eval))]


class TestComputeRsa:
    @pytest.mark.parametrize("bootstrap", [True, False])
    @pytest.mark.parametrize("n_select", [None, 18])
    def test_matches_jax(self, bootstrap, n_select):
        """With ``n_select`` below the selection size the subsample draw
        comes first and the bootstrap draws continue the same stream."""
        sel, ev = _splits(np.random.RandomState(6))
        cfg = {"compare_method": "spearman"}
        kw = dict(n_select=n_select, bootstrap=bootstrap, n_bootstrap=N_BOOT)
        got = trsa.compute_rsa(cfg, sel, ev, **kw, device="cpu")[0]
        ref = jrsa.compute_rsa(cfg, sel, ev, **kw)[0]
        assert got["layer"] == ref["layer"] == "L1"
        np.testing.assert_allclose([e["score"] for e in got["layer_selection_scores"]],
                                   [e["score"] for e in ref["layer_selection_scores"]], atol=1e-5)
        assert got["score"] == pytest.approx(ref["score"], abs=1e-5)
        if bootstrap:
            np.testing.assert_allclose(got["bootstrap_scores"], ref["bootstrap_scores"], atol=1e-5)
            assert (got["ci_low"], got["ci_high"]) == pytest.approx((ref["ci_low"], ref["ci_high"]),
                                                                    abs=1e-5)
            assert got["bootstrap_exact_ties"] is ref["bootstrap_exact_ties"] is True
            assert trsa.LAST_RSA_TIMES["fused"] == 1.0
        else:
            assert got["ci_low"] is None and "bootstrap_scores" not in got
        assert set(got) == set(ref)

    def test_continued_stream_differs_from_a_fresh_one(self):
        """The n_select draw moves the bootstrap's draws: a fresh
        bootstrap_indices(seed=42) would give other scores."""
        sel, ev = _splits(np.random.RandomState(6))
        kw = dict(bootstrap=True, n_bootstrap=N_BOOT, device="cpu")
        drawn = trsa.compute_rsa({}, sel, ev, n_select=18, **kw)[0]["bootstrap_scores"]
        fresh = trsa.compute_rsa({}, sel, ev, n_select=None, **kw)[0]["bootstrap_scores"]
        assert not np.allclose(drawn, fresh)

    def test_re_extraction_and_unported_bootstraps(self):
        """The re-extraction hook scores the re-extracted activations; the
        unfused route (the dense-rank Spearman bootstrap, Pearson and
        Kendall, each with and without an n_select draw) agrees with the
        JAX package within 1e-5."""
        sel, ev = _splits(np.random.RandomState(6))
        seen = []

        def re_extract(layer, ids):
            seen.append((layer, list(ids)))
            return torch.from_numpy(ev.activations[layer]), ids

        got = trsa.compute_rsa({}, sel, ev, bootstrap=False, re_extract_fn=re_extract)[0]
        assert seen == [("L1", ev.stimulus_ids)] and "re_extract_s" in trsa.LAST_RSA_TIMES
        assert got["score"] == trsa.compute_rsa({}, sel, ev, bootstrap=False,
                                                device="cpu")[0]["score"]
        for cfg in ({"bootstrap_exact_ties": False}, {"compare_method": "pearson"},
                    {"compare_method": "kendall"}):
            for n_select in (None, 18):
                kw = dict(n_select=n_select, bootstrap=True, n_bootstrap=N_BOOT)
                got = trsa.compute_rsa(cfg, sel, ev, **kw, device="cpu")[0]
                ref = jrsa.compute_rsa(cfg, sel, ev, **kw)[0]
                assert set(got) == set(ref) and got["layer"] == ref["layer"] == "L1"
                assert got["compare_method"] == ref["compare_method"]
                assert got["bootstrap_exact_ties"] is ref["bootstrap_exact_ties"] is False
                np.testing.assert_allclose(
                    [e["score"] for e in got["layer_selection_scores"]],
                    [e["score"] for e in ref["layer_selection_scores"]], atol=1e-5)
                assert got["score"] == pytest.approx(ref["score"], abs=1e-5)
                np.testing.assert_allclose(got["bootstrap_scores"], ref["bootstrap_scores"],
                                           atol=1e-5)
                assert "bootstrap_s" in trsa.LAST_RSA_TIMES


# ── fixture and validator ──

class TestFixtureAndValidator:
    def test_things_fixture_matches_jax(self, tmp_path, monkeypatch):
        monkeypatch.setattr(jfixture, "FIXTURE_DIR", tmp_path / "jax")
        for k, v in {"THINGS_CONCEPTS": 5, "THINGS_IMGS_PER_CONCEPT": 3, "N_JPEG": 4,
                     "IMG_SIZE": 32}.items():
            monkeypatch.setattr(jfixture, k, v)
        jmeta = jfixture.ensure_things_fixture()
        tmeta = tfixture.ensure_things_fixture(tmp_path / "torch", n_concepts=5,
                                               imgs_per_concept=3, n_jpeg=4, img_size=32)
        assert tmeta["n_images"] == jmeta["n_images"] == 15
        pkl = Path("datasets/neural/things/things_split.pkl")
        jdata = pickle.loads((Path(jmeta["root"]) / pkl).read_bytes())
        tdata = pickle.loads((Path(tmeta["root"]) / pkl).read_bytes())
        assert tdata["image_ids"] == jdata["image_ids"]
        assert {k: Path(p).name for k, p in tdata["image_paths"].items()} == \
            {k: Path(p).name for k, p in jdata["image_paths"].items()}
        for c, e in jdata["embeddings"].items():
            np.testing.assert_array_equal(tdata["embeddings"][c], e)
        for p in sorted(Path(jmeta["root"]).parent.joinpath("jpeg").glob("*.jpg")):
            assert (tmp_path / "torch" / "jpeg" / p.name).read_bytes() == p.read_bytes()
        monkeypatch.chdir(tmeta["root"])
        targets, paths = load_things_data()
        assert set(targets) == {"embeddings", "image_ids"} and len(paths) == 15
        assert tfixture.ensure_things_fixture(tmp_path / "torch", n_concepts=5,
                                              imgs_per_concept=3, n_jpeg=4,
                                              img_size=32)["build_s"] == tmeta["build_s"]

    @pytest.mark.parametrize("extra", [[], ["region=V1", "subject_idx=3"],
                                       ['region=["V1","V2"]', "subject_idx=[0,1]"]])
    def test_things_region_and_subject_become_na(self, extra):
        args = [*OVERRIDES, *extra, "mode=eval"]
        got = trun.validate_config(load_config(BASE, args))
        ref = jax_validate(jax_load_config(BASE, args))
        assert got.region == ref.region == "N/A" and got.subject_idx == ref.subject_idx == "N/A"

    def test_things_encoding_raises(self):
        with pytest.raises(ValueError, match="not supported for things-behavior"):
            trun.validate_config(load_config(BASE, [*OVERRIDES, "analysis=encoding_score",
                                                    "mode=eval"]))
        with pytest.raises(ValueError, match="not supported for things-behavior"):
            tevals.eval(Config({**dict(a.split("=", 1) for a in OVERRIDES),
                                "analysis": "encoding_score"}), device="cpu")


# ── the whole eval ──

def _db_rows(path):
    with sqlite3.connect(str(path)) as conn:
        return conn.execute("SELECT run_id, region, subject_idx, neural_dataset, analysis, "
                            "compare_method, layer, score, ci_low, ci_high, cfg_id, epoch "
                            "FROM results").fetchall()


@pytest.fixture(scope="module")
def things_evals(tmp_path_factory, alexnet):
    """Both packages' THINGS eval on the JAX bench's fixture at a tiny
    scale, with block-image JPEGs and the same weights, each decoding as
    it does by default (the C++ decoder where it builds, the same source
    in both packages; else PIL in both). The port
    runs through its CLI and selects on the JAX eval's SRP store; then
    once more with a store in bf16 (``acts_store=device``: the device
    concept means and the device-averaged re-extraction, on the CPU)."""
    state, load_model = alexnet
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("things")
    stores = {}
    try:
        mp.setattr(jfixture, "FIXTURE_DIR", tmp / "fx")
        for k, v in TINY.items():
            mp.setattr(jfixture, k, v)
        meta = jfixture.ensure_things_fixture()
        block_pool(sorted((tmp / "fx" / "jpeg").glob("*.jpg")), TINY["IMG_SIZE"])
        mp.chdir(meta["root"])
        mp.setenv("VISREPS_INIT_CACHE", "0")
        mp.setattr(jevals, "load_model", lambda cfg, verbose=False: state)
        mp.setattr(jdb, "RESULTS_DB_PATH", tmp / "jax.db")
        jax_get_activations = JaxExtractor.get_activations

        def keep_jax_store(self, *args, **kwargs):
            acts, ids = jax_get_activations(self, *args, **kwargs)
            stores["jax"] = ({n: np.asarray(a, np.float32) for n, a in acts.items()}, list(ids))
            return acts, ids

        mp.setattr(JaxExtractor, "get_activations", keep_jax_store)
        jax_results = jevals.eval(jax_validate(jax_load_config(BASE, [*OVERRIDES, "mode=eval"])))

        configure = tevals.configure_feature_extractor

        def configure_on_jax_store(cfg, model, device=None, verbose=False):
            ext = configure(cfg, model, device=device, verbose=verbose)
            own_get_activations = ext.get_activations

            def select_on_jax_store(loader, store="device"):
                acts, ids = own_get_activations(loader, store=store)
                stores.setdefault("torch_store", []).append(store)
                jacts, jids = stores["jax"]
                assert [str(i) for i in ids] == [str(i) for i in jids]
                return {n: torch.from_numpy(jacts[n]).to(acts[n].device, acts[n].dtype)
                        for n in acts}, ids

            ext.get_activations = select_on_jax_store
            return ext

        mp.setattr(tevals, "load_model", load_model)
        mp.setattr(tevals, "configure_feature_extractor", configure_on_jax_store)
        mp.setattr(tdb, "RESULTS_DB_PATH", tmp / "torch.db")
        cli = ["--mode", "eval", "--device", "cpu", "--config", str(BASE), "--override"]
        routes = Counter(tloader.ROUTES)
        torch_results = trun.main([*cli, *OVERRIDES])
        routes = Counter(tloader.ROUTES) - routes
        phases = dict(tevals.LAST_PHASE_TIMES)
        mp.setattr(tdb, "RESULTS_DB_PATH", tmp / "device.db")
        device_results = trun.main([*cli, *OVERRIDES, "acts_store=device"])
        yield {"jax": jax_results, "torch": torch_results, "device": device_results,
               "phases": phases, "tmp": tmp, "stores": stores["torch_store"],
               "routes": routes, "n_ids": meta["n_images"]}
    finally:
        mp.undo()


class TestThingsEval:
    def test_one_result_and_db_row(self, things_evals):
        j, t = things_evals["jax"], things_evals["torch"]
        assert len(j) == len(t) == 1 and things_evals["stores"] == ["host", "device"]
        jrows, trows = _db_rows(things_evals["tmp"] / "jax.db"), _db_rows(things_evals["tmp"] / "torch.db")
        assert len(jrows) == len(trows) == 1
        assert trows[0][:7] == jrows[0][:7]  # run_id, N/A, N/A, dataset, analysis, method, layer
        assert trows[0][1:6] == ("N/A", "N/A", "things-behavior", "rsa", "spearman")
        assert trows[0][10:] == jrows[0][10:] == ("untrained", -1)
        np.testing.assert_allclose(trows[0][7:10], jrows[0][7:10], atol=1e-4)

    def test_decode_route_and_cache(self, things_evals):
        """The first pass decodes every id by the default route (native
        where both packages' decoder builds, else PIL); the re-extraction
        is served from the decode cache."""
        route = "native" if jnative.native_available() else "pil"
        n = things_evals["n_ids"]
        assert things_evals["routes"] == {route: n, "cache": n}

    def test_phases(self, things_evals):
        assert set(things_evals["phases"]) == {
            "model_load_s", "data_load_s", "extraction_s", "extraction_loader_s",
            "concept_avg_s", "scoring_s", "scoring_selection_s", "scoring_re_extract_s",
            "scoring_point_score_s", "scoring_fused"}

    def test_selection_point_and_bootstrap_scores(self, things_evals):
        j, t = things_evals["jax"][0], things_evals["torch"][0]
        js = {e["layer"]: e["score"] for e in j["layer_selection_scores"]}
        ts = {e["layer"]: e["score"] for e in t["layer_selection_scores"]}
        assert list(ts) == list(js) and len(ts) == 14
        np.testing.assert_allclose([ts[l] for l in js], list(js.values()), atol=1e-4)
        assert t["layer"] == j["layer"]
        assert t["score"] == pytest.approx(j["score"], abs=1e-4)
        assert len(t["bootstrap_scores"]) == len(j["bootstrap_scores"]) == N_BOOT
        np.testing.assert_allclose(t["bootstrap_scores"], j["bootstrap_scores"], atol=1e-4)
        assert (t["ci_low"], t["ci_high"]) == pytest.approx((j["ci_low"], j["ci_high"]), abs=1e-4)
        assert t["bootstrap_exact_ties"] is j["bootstrap_exact_ties"] is True

    def test_device_store_path(self, things_evals):
        """A bf16 store averaged by the segment mean and the selected
        layer's device-averaged re-extraction: selection on bf16 means
        stays within bf16 rounding of the host path's, and the scoring of
        the same layer agrees (its means are exact f32 either way)."""
        d, h = things_evals["device"][0], things_evals["torch"][0]
        np.testing.assert_allclose([e["score"] for e in d["layer_selection_scores"]],
                                   [e["score"] for e in h["layer_selection_scores"]], atol=2e-2)
        assert len(_db_rows(things_evals["tmp"] / "device.db")) == 1
        if d["layer"] == h["layer"]:
            assert d["score"] == pytest.approx(h["score"], abs=1e-4)
            np.testing.assert_allclose(d["bootstrap_scores"], h["bootstrap_scores"], atol=1e-4)
        assert all(np.isfinite([d["score"], d["ci_low"], d["ci_high"]]))
