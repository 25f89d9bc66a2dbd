"""The THINGS, TVSD and NSD-Synthetic evals of the PyTorch port against
the JAX package's under ``compare_method=kendall`` (Kendall selection,
the per-pair route's Kendall point scores and block-contraction
bootstraps), and THINGS with ``reconstruct_from_pcs`` (each per-image
exact tap rebuilt from its top PC before the concept means), on the CPU.

They run on the tiny fixtures of tests/test_torch_port_things.py and
tests/test_torch_port_tvsd_synth.py (block images, one AlexNet, the port
selecting on the JAX eval's SRP store) through the port's CLI, at those
files' tolerance: selection, point and bootstrap scores and results.db
rows at 1e-4.
"""
import shutil
from collections import Counter

import numpy as np
import pytest
import torch

import visreps_tpu.core.db as jdb
import visreps_tpu.evals as jevals
from visreps_tpu.benchmarks import fixture as jfixture
from visreps_tpu.core.config import load_config as jax_load_config
from visreps_tpu.core.validate import validate_config as jax_validate
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor

import visreps_tpu_torch.core.db as tdb
import visreps_tpu_torch.evals as tevals
from visreps_tpu_torch import run as trun
from visreps_tpu_torch.ops import pca as tpca

from test_torch_port_things import BASE, OVERRIDES, TINY, _db_rows as things_rows, alexnet, \
    block_pool  # noqa: F401  (alexnet: a fixture)
from test_torch_port_tvsd_synth import CLI, NSD_LAYERS, REGIONS_NSD, SYN, TVSD_RSA, \
    _db_rows as pair_rows, _jax_cfg, _same_result, _same_rows, _use_db, world  # noqa: F401

KENDALL = ["compare_method=kendall"]
RECONSTRUCT = ["reconstruct_from_pcs=true", "pca_k=1"]


@pytest.fixture(scope="module")
def things_world(tmp_path_factory, alexnet):  # noqa: F811
    """Both packages' THINGS eval on test_torch_port_things.py's tiny
    fixture: ``run(extra, name)`` runs the JAX eval and then the port's
    CLI with OVERRIDES + ``extra``, each into its own results.db; the port
    selects on the JAX eval's SRP store."""
    state, load_model = alexnet
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("things_scoring")
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
        mp.setattr(tevals, "load_model", load_model)
        jax_get_activations = JaxExtractor.get_activations

        def keep_jax_store(self, *args, **kwargs):
            acts, ids = jax_get_activations(self, *args, **kwargs)
            stores["jax"] = ({n: np.asarray(a, np.float32) for n, a in acts.items()}, list(ids))
            return acts, ids

        mp.setattr(JaxExtractor, "get_activations", keep_jax_store)
        configure = tevals.configure_feature_extractor

        def configure_on_jax_store(cfg, model, device=None, verbose=False):
            ext = configure(cfg, model, device=device, verbose=verbose)
            own_get_activations = ext.get_activations

            def select_on_jax_store(loader, store="device", retain_ids=None):
                acts, ids = own_get_activations(loader, store=store, retain_ids=retain_ids)
                jacts, _ = stores["jax"]
                return {n: torch.from_numpy(jacts[n]).to(acts[n].device, acts[n].dtype)
                        for n in acts}, ids

            ext.get_activations = select_on_jax_store
            return ext

        mp.setattr(tevals, "configure_feature_extractor", configure_on_jax_store)

        def run(extra, name):
            mp.setattr(jdb, "RESULTS_DB_PATH", tmp / f"jax_{name}.db")
            mp.setattr(tdb, "RESULTS_DB_PATH", tmp / f"torch_{name}.db")
            args = [*OVERRIDES, *extra]
            jax_results = jevals.eval(jax_validate(jax_load_config(BASE, [*args, "mode=eval"])))
            cli = ["--mode", "eval", "--device", "cpu", "--config", str(BASE), "--override"]
            return jax_results, trun.main([*cli, *args])

        yield {"run": run, "tmp": tmp, "mp": mp}
    finally:
        mp.undo()


def _same_things_result(got, ref):
    """Selection scores compared layer by layer: with a device store the
    JAX package lists its taps in another order."""
    js = {e["layer"]: e["score"] for e in ref["layer_selection_scores"]}
    ts = {e["layer"]: e["score"] for e in got["layer_selection_scores"]}
    assert set(ts) == set(js) and len(ts) == 14
    np.testing.assert_allclose([ts[l] for l in js], list(js.values()), atol=1e-4)
    assert got["layer"] == ref["layer"] and got["compare_method"] == ref["compare_method"]
    assert got["score"] == pytest.approx(ref["score"], abs=1e-4)
    assert len(got["bootstrap_scores"]) == len(ref["bootstrap_scores"]) == 8
    np.testing.assert_allclose(got["bootstrap_scores"], ref["bootstrap_scores"], atol=1e-4)
    assert (got["ci_low"], got["ci_high"]) == pytest.approx((ref["ci_low"], ref["ci_high"]),
                                                            abs=1e-4)
    assert got["bootstrap_exact_ties"] is ref["bootstrap_exact_ties"]


class TestThings:
    def test_kendall(self, things_world):
        jax_results, torch_results = things_world["run"](KENDALL, "kendall")
        assert len(jax_results) == len(torch_results) == 1
        _same_things_result(torch_results[0], jax_results[0])
        assert torch_results[0]["compare_method"] == "kendall"
        assert torch_results[0]["bootstrap_exact_ties"] is False
        trows = things_rows(things_world["tmp"] / "torch_kendall.db")
        jrows = things_rows(things_world["tmp"] / "jax_kendall.db")
        assert len(trows) == len(jrows) == 1 and trows[0][:7] == jrows[0][:7]
        assert trows[0][5] == "kendall"

    def test_reconstruct_from_pcs(self, things_world):
        """The re-extraction takes the host route (the per-image matrix,
        one PCA fit) with a device store too, as the JAX package does."""
        fits = Counter()
        fit_pca = tpca.fit_pca

        def counted(x, k):
            fits[(tuple(x.shape), k)] += 1
            return fit_pca(x, k)

        things_world["mp"].setattr(tpca, "fit_pca", counted)
        jax_results, torch_results = things_world["run"](
            [*RECONSTRUCT, "acts_store=device"], "reconstruct")
        _same_things_result(torch_results[0], jax_results[0])
        n_images = TINY["THINGS_CONCEPTS"] * TINY["THINGS_IMGS_PER_CONCEPT"]
        assert len(fits) == 1 and next(iter(fits))[0][0] == n_images and sum(fits.values()) == 1
        assert "scoring_re_extract_s" in tevals.LAST_PHASE_TIMES


@pytest.fixture(scope="module")
def kendall_evals(world):  # noqa: F811
    """TVSD RSA and NSD-Synthetic under Kendall in both packages; the
    synthetic eval inherits NSD Kendall rows the JAX package writes."""
    mp, tmp = world["mp"], world["tmp"]
    _use_db(mp, tmp / "jax_tvsd_k.db", tmp / "torch_tvsd_k.db")
    tvsd = (jevals.eval(_jax_cfg([*TVSD_RSA, *KENDALL])), trun.main([*CLI, *TVSD_RSA, *KENDALL]))
    seeded = tmp / "nsd_kendall_rows.db"
    jcfg = _jax_cfg([*SYN, *KENDALL])
    for (region, subj), layer in NSD_LAYERS.items():
        jdb.save_results([{"layer": layer, "compare_method": "kendall", "score": 0.3,
                           "ci_low": 0.2, "ci_high": 0.4, "analysis": "rsa",
                           "layer_selection_scores": []}],
                         jcfg.merge({"epoch": -1, "cfg_id": "untrained", "neural_dataset": "nsd",
                                     "analysis": "rsa", "subject_idx": subj, "region": region}),
                         db_path=seeded)
    for name in ("jax_syn_k.db", "torch_syn_k.db"):
        shutil.copy(seeded, tmp / name)
    _use_db(mp, tmp / "jax_syn_k.db", tmp / "torch_syn_k.db")
    synth = (jevals.eval(jcfg), trun.main([*CLI, *SYN, *KENDALL]))
    return {"tvsd": tvsd, "synth": synth}


class TestTvsdAndNsdSynthetic:
    def test_tvsd_kendall(self, world, kendall_evals):
        jax_results, torch_results = kendall_evals["tvsd"]
        assert len(torch_results) == len(jax_results) == 6
        for t, j in zip(torch_results, jax_results):
            assert t["compare_method"] == "kendall" and len(t["layer_selection_scores"]) == 14
            _same_result(t, j)
        tmp = world["tmp"]
        _same_rows(pair_rows(tmp / "torch_tvsd_k.db", "tvsd"),
                   pair_rows(tmp / "jax_tvsd_k.db", "tvsd"))

    def test_nsd_synthetic_kendall(self, world, kendall_evals):
        jax_results, torch_results = kendall_evals["synth"]
        pairs = [(r, s) for r in REGIONS_NSD for s in (0, 1)]
        assert [t["layer"] for t in torch_results] == [j["layer"] for j in jax_results] == \
            [NSD_LAYERS[p] for p in pairs]
        for t, j in zip(torch_results, jax_results):
            assert t["compare_method"] == "kendall"
            _same_result(t, j)
        tmp = world["tmp"]
        _same_rows(pair_rows(tmp / "torch_syn_k.db", "nsd_synthetic"),
                   pair_rows(tmp / "jax_syn_k.db", "nsd_synthetic"))
