"""torchvision-weight import and the reference's torch-zip checkpoints in
the PyTorch port against the JAX package, on the CPU.

State dicts in torchvision's key layout (and the reference CustomCNN's)
come from plain ``torch.nn`` modules with those names
(``visreps_tpu_torch/benchmarks/weights.py``), drawn from a seed. Each
goes through both packages' converters: the port's weights must equal
the JAX package's tree exactly (both are transposes of the same float32
values), and the port's logits must match the plain module's forward
within 1e-4 of the largest logit. Then the missing-file path, the
reference checkpoint through both ``load_checkpoint``, and one NSD RSA
eval of ResNet18 with ``pretrained_dataset=imagenet1k`` read from a
synthetic weight file in both packages (selection, point and bootstrap
scores within 1e-4, as ``tests/test_torch_port_e2e.py`` holds them).
"""
import sqlite3
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visreps_tpu.core.db as jdb
import visreps_tpu.data.neural as jneural
import visreps_tpu.evals as jevals
from visreps_tpu.benchmarks import fixture as jfixture
from visreps_tpu.core.config import Config as JaxConfig
from visreps_tpu.models import resnet as jresnet
from visreps_tpu.models import torch_import as jti
from visreps_tpu.models import vit as jvit
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor
from visreps_tpu.models.zoo import _build_module as jax_build_module
from visreps_tpu.ops.srp import SRPTransform as JaxSRP
from visreps_tpu.train import checkpoint as jckpt

import visreps_tpu_torch.core.db as tdb
import visreps_tpu_torch.evals as tevals
from visreps_tpu_torch.benchmarks import weights
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.models import torch_import as tti
from visreps_tpu_torch.models.convert import params_to_jax, srp_from_jax
from visreps_tpu_torch.models.custom_cnn import CustomCNN
from visreps_tpu_torch.models.resnet import Bottleneck, ResNet
from visreps_tpu_torch.models.vit import ViTBase
from visreps_tpu_torch.models.zoo import MODEL_REGISTRY, init_model
from visreps_tpu_torch.train import checkpoint as tckpt

VIT_SMALL = dict(hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128)
TV_VIT_SMALL = dict(hidden=64, layers=2, heads=4, mlp=128)

# name → (plain torchvision-layout module, JAX module, JAX converter,
#         port module, port converter name, input size); small instances
# where the converter takes the structure.
CASES = {
    "AlexNet": (weights.torchvision_alexnet, lambda n: jax_build_module("AlexNet", n),
                jti.convert_alexnet, lambda n: MODEL_REGISTRY["AlexNet"](n), "AlexNet", 224),
    "VGG16": (weights.torchvision_vgg16, lambda n: jax_build_module("VGG16", n),
              jti.convert_vgg16, lambda n: MODEL_REGISTRY["VGG16"](n), "VGG16", 32),
    "ResNet18": (lambda n: weights.torchvision_resnet((2, 2, 2, 2), False, n),
                 lambda n: jax_build_module("ResNet18", n),
                 lambda sd, n: jti.convert_resnet(sd, (2, 2, 2, 2), n),
                 lambda n: MODEL_REGISTRY["ResNet18"](n), "ResNet18", 64),
    "ResNet50_small": (lambda n: weights.torchvision_resnet((1, 1, 1, 1), True, n),
                       lambda n: jresnet.ResNet((1, 1, 1, 1), jresnet.Bottleneck, n),
                       lambda sd, n: jti.convert_resnet(sd, (1, 1, 1, 1), n),
                       lambda n: ResNet((1, 1, 1, 1), Bottleneck, n), "ResNet50", 64),
    "ViTBase_small": (lambda n: weights.torchvision_vit(n, **TV_VIT_SMALL),
                      lambda n: jvit.ViTBase(num_classes=n, **VIT_SMALL),
                      lambda sd, n: jti.convert_vit(sd, n, 2, 64, 4),
                      lambda n: ViTBase(num_classes=n, **VIT_SMALL), "ViTBase", 224),
    "CustomCNN": (weights.ReferenceCustomCNN, lambda n: jax_build_module("CustomCNN", n),
                  jti.convert_custom_cnn, lambda n: CustomCNN(n), "CustomCNN", 224),
}


def _zeros_template(module, size):
    """The JAX module's variables as zero numpy arrays (the JAX importer
    overlays onto a template; zeros mark what it did not import)."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False, capture=()))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _jax_import(case, sd, n):
    """(params, batch_stats) the JAX package's converter and merge give."""
    _, jmod_fn, convert, _, _, size = CASES[case]
    template = _zeros_template(jmod_fn(n), size)
    params, stats = convert(sd, n)
    merged = jti._merge_into(template["params"], params)
    merged_stats = jti._merge_into(template["batch_stats"], stats) if stats else None
    return merged, merged_stats


def _port_import(case, sd, n):
    """(state before the import, model after) in the port; the model
    starts from zeros (allocated without the constructor's init)."""
    _, _, _, tmod_fn, name, _ = CASES[case]
    with torch.device("meta"):
        model = tmod_fn(n)
    model = model.to_empty(device="cpu")
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    return before, tti.apply_torch_state_dict(model.eval(), name, sd, n)


def _plain(case, n, seed):
    """The seeded torchvision-layout module."""
    return weights.seeded(CASES[case][0], seed, n)


def _leaves(tree):
    return {tuple(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


class TestConverters:
    @pytest.mark.parametrize("case", list(CASES))
    def test_same_weights_as_jax_and_plain_forward(self, case):
        size = CASES[case][-1]
        n = 16 if case == "CustomCNN" else 1000
        tv = _plain(case, n, seed=2)
        sd = tv.state_dict()
        jparams, jstats = _jax_import(case, sd, n)
        _, model = _port_import(case, sd, n)
        params, stats = params_to_jax(model.state_dict(), getattr(model, "num_heads", None))
        ref, got = _leaves(jparams), _leaves(params)
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
            assert np.any(v != 0) or "bias" in k, k  # every leaf was imported
        if jstats:
            ref, got = _leaves(jstats), _leaves(stats)
            assert set(got) == set(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)
        x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            want, logits = tv(x), model(x)[0]
        torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))

    @pytest.mark.parametrize("case", ["AlexNet", "ResNet50_small", "ViTBase_small", "CustomCNN"])
    def test_head_replacement_keeps_fresh_init(self, case):
        """A 1000-class file (64 for CustomCNN) into a 10-class model: the
        head keeps its init in both packages, everything else is imported."""
        sd = _plain(case, 64 if case == "CustomCNN" else 1000, seed=4).state_dict()
        jparams, _ = _jax_import(case, sd, 10)
        before, model = _port_import(case, sd, 10)
        head = {"AlexNet": "fc3", "ResNet50_small": "fc", "ViTBase_small": "head",
                "CustomCNN": "fc3"}[case]
        after = model.state_dict()
        assert torch.equal(after[f"{head}.weight"], before[f"{head}.weight"])
        assert not np.any(np.asarray(jparams[head]["kernel"]))  # the JAX template's zeros
        params, _ = params_to_jax(after, getattr(model, "num_heads", None))
        ref, got = _leaves(jparams), _leaves(params)
        imported = [k for k in ref if k[0] != head]
        assert len(imported) > 4
        for k in imported:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))

    def test_shape_mismatch_raises_in_both(self):
        sd = weights.seeded(weights.torchvision_resnet, 0, (1, 1, 1, 1), True, 10).state_dict()
        with pytest.raises(ValueError, match="Shape mismatch"):
            tti.apply_torch_state_dict(MODEL_REGISTRY["ResNet18"](10), "ResNet18", sd, 10)
        with pytest.raises(ValueError, match="No torch converter"):
            tti.apply_torch_state_dict(MODEL_REGISTRY["ResNet18"](10), "ECTiedNet", sd, 10)


class TestWeightFiles:
    def test_lookup_and_missing_file(self, tmp_path, monkeypatch, capsys):
        """Both packages look in TORCH_WEIGHTS_DIR, then
        ~/.cache/torch/hub/checkpoints; without a file both warn and keep
        the random init (ECTiedNet has no torchvision file at all)."""
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        monkeypatch.setenv("TORCH_WEIGHTS_DIR", str(tmp_path / "none"))
        for name in ("AlexNet", "VGG16", "ResNet18", "ResNet50", "ViTBase", "ECTiedNet"):
            assert tti.find_torch_weight_file(name) is None is jti.find_torch_weight_file(name)
        model = init_model("ResNet18", 1000, seed=1, device="cpu")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        assert tti.load_pretrained_torch(model, "ResNet18", 1000) is model
        assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
        assert "not found locally" in capsys.readouterr().out
        sentinel = object()
        assert jti.load_pretrained_torch(sentinel, "ResNet18", 1000) is sentinel
        assert "not found locally" in capsys.readouterr().out
        cache = tmp_path / "home" / ".cache" / "torch" / "hub" / "checkpoints"
        path = weights.write_torchvision_weights(cache, "ResNet18", seed=0)
        assert tti.find_torch_weight_file("ResNet18") == path == jti.find_torch_weight_file("ResNet18")
        monkeypatch.setenv("TORCH_WEIGHTS_DIR", str(tmp_path / "w"))
        first = weights.write_torchvision_weights(tmp_path / "w", "ResNet18", seed=0)
        assert tti.find_torch_weight_file("ResNet18") == first == jti.find_torch_weight_file("ResNet18")
        assert first.name == "resnet18-f37072fd.pth"


class TestReferenceCheckpoint:
    def test_loads_as_in_jax(self, tmp_path, monkeypatch):
        """A whole-module CustomCNN torch-zip checkpoint (the reference's
        format) through both packages' ``load_checkpoint``: the class
        count from the last 2-D weight, the same weights, its config, and
        logits of the pickled module itself within 1e-4 of the largest."""
        monkeypatch.setenv("VISREPS_INIT_CACHE", "0")
        path = tmp_path / "checkpoint_epoch_20.pth"
        ref = weights.write_reference_checkpoint(path, num_classes=16, seed=5,
                                                 config={"pca_n_classes": 16})
        assert path.read_bytes()[:2] == b"PK"
        model, payload = tckpt.load_checkpoint(path, device="cpu")
        jstate, jpayload = jckpt.load_checkpoint(path)
        assert payload == jpayload == {"config": {"pca_n_classes": 16}}
        assert model.num_classes == 16 and not model.training
        params, stats = params_to_jax(model.state_dict())
        for mine, theirs in ((params, jstate.params), (stats, jstate.batch_stats)):
            ref_leaves, got = _leaves(theirs), _leaves(mine)
            assert set(got) == set(ref_leaves)
            assert all(np.array_equal(got[k], ref_leaves[k]) for k in got)
        x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(6))
        with torch.no_grad():
            want, logits = ref(x), model(x)[0]
        torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))

    def test_through_load_model(self, tmp_path, monkeypatch):
        """The eval's ``load_model_from=checkpoint`` route reaches the
        same file in both packages (``{dir}/cfg{id}{seed letter}/{file}``)
        and gives the same weights."""
        from visreps_tpu.models.zoo import load_model as jax_load_model
        from visreps_tpu_torch.models.zoo import load_model

        monkeypatch.setenv("VISREPS_INIT_CACHE", "0")
        run_dir = tmp_path / "cfg8b"
        run_dir.mkdir()
        weights.write_reference_checkpoint(run_dir / "checkpoint_epoch_3.pth", num_classes=8,
                                           seed=7)
        cfg = {"load_model_from": "checkpoint", "cfg_id": 8, "seed": 2,
               "checkpoint_dir": str(tmp_path), "checkpoint_model": "checkpoint_epoch_3.pth"}
        model = load_model(Config(cfg), device="cpu")
        jstate = jax_load_model(JaxConfig(cfg))
        assert model.num_classes == 8 and not model.training
        params, stats = params_to_jax(model.state_dict())
        for mine, theirs in ((params, jstate.params), (stats, jstate.batch_stats)):
            ref, got = _leaves(theirs), _leaves(mine)
            assert set(got) == set(ref) and all(np.array_equal(got[k], ref[k]) for k in got)


# ── one NSD RSA eval of ResNet18 with imported weights, in both packages ──

# 30 selection and 30 test stimuli, one subject (60 in all): in an RDM
# of 10 block images two entries can lie closer (1.6e-7 seen at block5)
# than the packages' f32 RDMs differ (~3e-7), and one exchanged rank
# moves a 45-entry Spearman score by up to 6e-3; at 30 stimuli (435
# entries) one exchange moves it by < 1e-4.
TINY = {"N_SHARED": 30, "N_UNIQUE": 30, "N_SUBJECTS": 1, "REGIONS": ["early", "ventral"],
        "N_VOXELS": 8, "N_STIMULI": 30 + 30, "IMG_SIZE": 64}
SRP_K = 64


def _eval_cfg(cls):
    return cls({
        "mode": "eval", "seed": 1, "neural_dataset": "nsd", "subject_idx": [0],
        "shared_test_subjects": [0],
        "region": ["early visual stream", "ventral visual stream"],
        "analysis": "rsa", "compare_method": "spearman", "bootstrap": True,
        "n_bootstrap": 8, "n_select": 30, "batchsize": 16, "num_workers": 2,
        "load_model_from": "torchvision", "model_name": "ResNet18",
        "pretrained_dataset": "imagenet1k", "extract_pre_and_post": True, "srp_k": SRP_K,
        "uint8_transfer": True, "log_expdata": True, "use_mesh": False,
    })


def _block_images(path):
    """4 × 4 colour blocks in place of pixel noise (see
    tests/test_torch_port_e2e.py: noise crowds deep-layer RDMs)."""
    import h5py

    with h5py.File(path, "r+") as f:
        brick = f["imgBrick"]
        n, h, w, _ = brick.shape
        colours = np.random.RandomState(7).randint(0, 256, (n, 4, 4, 3)).astype(np.uint8)
        brick[...] = np.kron(colours, np.ones((1, h // 4, w // 4, 1), np.uint8))


@pytest.fixture(scope="module")
def both_evals(tmp_path_factory):
    """Each package loads ResNet18 through its own ``load_model`` (the
    torchvision file under TORCH_WEIGHTS_DIR, every weight imported). As
    in the e2e test, the port draws its own SRP store (checked at rtol
    1e-2) and then selects on the JAX eval's store with the JAX SRP
    matrices."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("import_eval")
    stores, models = {}, {}
    try:
        mp.setattr(jfixture, "FIXTURE_DIR", tmp / "fx")
        mp.setattr(jfixture, "N_JPEG", 1)
        for k, v in TINY.items():
            mp.setattr(jfixture, k, v)
        meta = jfixture.ensure_fixture()
        _block_images(meta["hdf5"])
        mp.setenv("NSD_DATA_DIR", str(Path(meta["pickle"]).parent))
        mp.setenv("VISREPS_INIT_CACHE", "0")
        mp.setenv("TORCH_WEIGHTS_DIR", str(tmp / "weights"))
        weights.write_torchvision_weights(tmp / "weights", "ResNet18", seed=5)

        jload, tload = jevals.load_model, tevals.load_model
        mp.setattr(jevals, "load_model", lambda cfg, **kw: models.setdefault("jax", jload(cfg, **kw)))
        mp.setattr(tevals, "load_model",
                   lambda cfg, **kw: models.setdefault("torch", tload(cfg, **kw)))
        mp.setattr(jneural, "NSD_STIMULI_HDF5", meta["hdf5"])
        mp.setattr(jdb, "RESULTS_DB_PATH", tmp / "jax.db")
        mp.setattr(jevals, "RESULTS_DB_PATH", tmp / "jax.db")
        jax_get_activations = JaxExtractor.get_activations

        def keep_jax_store(self, *args, **kwargs):
            acts, ids = jax_get_activations(self, *args, **kwargs)
            stores["jax"] = ({n: np.asarray(a, np.float32) for n, a in acts.items()}, list(ids))
            return acts, ids

        mp.setattr(JaxExtractor, "get_activations", keep_jax_store)
        jax_results = jevals.eval(_eval_cfg(JaxConfig))

        jax_srp = JaxSRP(k=SRP_K, seed=0)
        configure = tevals.configure_feature_extractor

        def configure_with_jax_srp(cfg, model, device=None, verbose=False):
            ext = configure(cfg, model, device=device, verbose=verbose)
            srp_from_jax(ext.srp, {
                d: tuple(np.asarray(c, np.float32) for c in jax_srp.matrix_chunks(d))
                for d in set(ext.tap_dims.values())})
            own_get_activations = ext.get_activations

            def select_on_jax_store(loader, store="device"):
                acts, ids = own_get_activations(loader, store=store)
                stores["torch"] = ({n: a.float().cpu().numpy() for n, a in acts.items()}, ids)
                jacts, jids = stores["jax"]
                assert [str(i) for i in ids] == [str(i) for i in jids]
                return {n: torch.from_numpy(jacts[n]).to(acts[n].device, acts[n].dtype)
                        for n in acts}, ids

            ext.get_activations = select_on_jax_store
            return ext

        mp.setattr(tevals, "configure_feature_extractor", configure_with_jax_srp)
        mp.setenv("NSD_STIMULI_HDF5", meta["hdf5"])  # the port reads it per call
        mp.setattr(tdb, "RESULTS_DB_PATH", tmp / "torch.db")
        torch_results = tevals.eval(_eval_cfg(Config), device="cpu")
        yield jax_results, torch_results, tmp, stores, models
    finally:
        mp.undo()


def _rows(path):
    with sqlite3.connect(str(path)) as conn:
        return sorted(conn.execute(
            "SELECT run_id, cfg_id, epoch, model_name, region, subject_idx FROM results").fetchall())


def _top_two_gap(result) -> float:
    top2 = sorted(e["score"] for e in result["layer_selection_scores"])[-2:]
    return top2[1] - top2[0]


class TestPretrainedEvalParity:
    def test_both_loaded_the_file(self, both_evals):
        """Both packages' models hold the file's weights (not the random
        init), equal to each other."""
        jstate, model = both_evals[4]["jax"], both_evals[4]["torch"]
        sd = torch.load(Path(both_evals[2]) / "weights" / "resnet18-f37072fd.pth")
        assert torch.equal(model.conv1.weight, sd["conv1.weight"])
        assert torch.equal(model.layer4_1.bn2.running_var, sd["layer4.1.bn2.running_var"])
        params, stats = params_to_jax(model.state_dict())
        for mine, theirs in ((params, jstate.params), (stats, jstate.batch_stats)):
            ref, got = _leaves(jax.tree_util.tree_map(np.asarray, theirs)), _leaves(mine)
            assert set(got) == set(ref) and all(np.array_equal(got[k], ref[k]) for k in got)

    def test_results_db_rows_match(self, both_evals):
        jax_results, torch_results, tmp, _, _ = both_evals
        assert len(torch_results) == len(jax_results) == 2
        trows, jrows = _rows(tmp / "torch.db"), _rows(tmp / "jax.db")
        assert trows == jrows and len(trows) == 2
        assert {r[1:4] for r in trows} == {("pretrained", -1, "ResNet18")}

    def test_srp_store(self, both_evals):
        jacts, jids = both_evals[3]["jax"]
        tacts, tids = both_evals[3]["torch"]
        assert list(tacts) == list(jacts) and len(tacts) == 10
        assert len(tids) == len(jids) == TINY["N_STIMULI"]
        for name, ref in jacts.items():
            np.testing.assert_allclose(tacts[name], ref, rtol=1e-2,
                                       atol=1e-2 * np.abs(ref).max(), err_msg=name)

    def test_selection_scores(self, both_evals):
        jax_results, torch_results = both_evals[:2]
        for j, t in zip(jax_results, torch_results):
            js = {e["layer"]: e["score"] for e in j["layer_selection_scores"]}
            ts = {e["layer"]: e["score"] for e in t["layer_selection_scores"]}
            assert list(ts) == list(js) and len(ts) == 10
            np.testing.assert_allclose([ts[l] for l in js], list(js.values()), atol=1e-4)
            assert t["layer"] == j["layer"] or _top_two_gap(j) <= 1e-4

    def test_point_and_bootstrap_scores(self, both_evals):
        jax_results, torch_results = both_evals[:2]
        same = [(j, t) for j, t in zip(jax_results, torch_results) if t["layer"] == j["layer"]]
        assert same
        for j, t in same:
            assert t["score"] == pytest.approx(j["score"], abs=1e-4)
            assert len(t["bootstrap_scores"]) == len(j["bootstrap_scores"]) == 8
            np.testing.assert_allclose(t["bootstrap_scores"], j["bootstrap_scores"], atol=1e-4)
            assert t["ci_low"] == pytest.approx(j["ci_low"], abs=1e-4)
            assert t["ci_high"] == pytest.approx(j["ci_high"], abs=1e-4)
