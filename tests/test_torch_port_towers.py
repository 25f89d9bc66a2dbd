"""The PyTorch port's CLIP and DINOv2 towers against the JAX package, on
the CPU: every tap with the same weights (the JAX tree, perturbed so no
bias or LayerScale is trivial, carried across by
``models/convert.params_from_jax``), the init families and full-width
parameter counts, the HF converters against config-initialised
``transformers`` models, the position-grid resampling, and the weight
routes of ``load_tower``: the converted-tower pickle the JAX package
writes and an HF snapshot on disk, read in a subprocess that loads no
``jax``, ``flax`` or ``transformers`` module.

Small towers (hidden 32, 2 layers, 4 heads, MLP 64, patch 16, 32 px).
Tolerance: 1e-5 absolute on every tap (the towers' values are O(1–10);
XLA and PyTorch sum convolutions and matmuls in other orders); 2e-5
against HF, as ``tests/test_hf_towers.py`` holds the JAX towers.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visreps_tpu.models import hf_vit as jhf

from visreps_tpu_torch.models import hf_vit as thf
from visreps_tpu_torch.models.convert import params_from_jax, params_to_jax

REPO = Path(__file__).resolve().parents[1]
IMG = 32
SMALL = dict(hidden=32, num_layers=2, heads=4, mlp_dim=64, patch=16)
TOL = 1e-5
HF_TOL = 2e-5
CAPTURE = ("patch_embed", "block1", "block2", "pooled", "embed")
KINDS = {
    "clip": (lambda: jhf.CLIPVisionTower(**SMALL, projection_dim=None),
             lambda: thf.CLIPVisionTower(**SMALL, projection_dim=None, image_size=IMG)),
    "clip_projection": (lambda: jhf.CLIPVisionTower(**SMALL, projection_dim=24),
                        lambda: thf.CLIPVisionTower(**SMALL, projection_dim=24, image_size=IMG)),
    "dinov2": (lambda: jhf.DINOv2Tower(**SMALL), lambda: thf.DINOv2Tower(**SMALL, image_size=IMG)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch():
    return np.random.RandomState(0).randn(2, IMG, IMG, 3).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax_taps(module, params, x):
    out, taps = module.apply({"params": params}, jnp.asarray(x), train=False, capture=CAPTURE)
    return np.asarray(out), {k: np.asarray(v) for k, v in taps.items()}


def _port_taps(model, x):
    with torch.no_grad():
        out, taps = model(_nchw(x), capture=CAPTURE)
    # the conv tap NCHW → the JAX package's NHWC
    return out.numpy(), {k: (v.permute(0, 2, 3, 1) if v.dim() == 4 else v).numpy()
                         for k, v in taps.items()}


def _perturbed(params, seed=3):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        tree, [np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32) for a in leaves])


@pytest.fixture(scope="module", params=list(KINDS))
def pair(request):
    jax_make, port_make = KINDS[request.param]
    module = jax_make()
    params = _perturbed(module.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))["params"])
    model = port_make().eval()
    model.load_state_dict(params_from_jax(params))
    return request.param, module, params, model


class TestTowerParity:
    def test_every_tap_matches_jax(self, pair, batch):
        kind, module, params, model = pair
        jout, jtaps = _jax_taps(module, params, batch)
        tout, ttaps = _port_taps(model, batch)
        assert set(ttaps) == set(jtaps)
        np.testing.assert_allclose(tout, jout, atol=TOL, rtol=0)
        for name in jtaps:
            assert ttaps[name].shape == jtaps[name].shape, name
            np.testing.assert_allclose(ttaps[name], jtaps[name], atol=TOL, rtol=0, err_msg=name)

    def test_names_carry_both_ways(self, pair):
        kind, _, params, model = pair
        back, stats = params_to_jax(model.state_dict())
        assert stats is None
        flat = dict(jax.tree_util.tree_leaves_with_path(params))
        assert len(flat) == len(jax.tree_util.tree_leaves(back))
        jax.tree_util.tree_map(np.testing.assert_array_equal, params, back)

    def test_taps_and_nodes_match_jax(self, pair):
        kind, module, _, model = pair
        from visreps_tpu.analysis.cross_model_rdms import _tower_nodes as jax_nodes

        from visreps_tpu_torch.analysis.cross_model_rdms import _tower_nodes

        assert _tower_nodes(model) == jax_nodes(module)
        assert {k: v for k, v in module.TAPS.items() if k in model.TAPS} == model.TAPS


class TestInitAndSize:
    @pytest.mark.parametrize("kind", ["clip", "dinov2"])
    def test_full_width_parameter_count(self, kind):
        """ViT-L/14 at 224 px: the port's parameters equal the JAX tower's."""
        jmod = jhf.CLIPVisionTower() if kind == "clip" else jhf.DINOv2Tower()
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 224, 224, 3))))
        n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
        with torch.device("meta"):
            model = thf.CLIPVisionTower() if kind == "clip" else thf.DINOv2Tower()
        assert sum(p.numel() for p in model.parameters()) == n_jax
        assert model.hidden == 1024 and model.num_layers == 24 and model.patch_size == 14

    @pytest.mark.parametrize("kind", ["clip", "dinov2"])
    def test_init_families(self, kind):
        model = KINDS[kind][1]()
        model.init_weights(torch.Generator().manual_seed(0))
        sd = model.state_dict()
        cls = "class_embedding" if kind == "clip" else "cls_token"
        for key, t in sd.items():
            if key.endswith("bias"):
                assert torch.count_nonzero(t) == 0, key
            elif key.endswith(("ls1", "ls2")) or ("ln" in key or "norm" in key):
                assert torch.equal(t, torch.ones_like(t)), key
        fc1 = sd["block1.fc1.weight"]  # lecun-normal, truncated at 2σ
        assert fc1.abs().max() <= 2 / np.sqrt(32) / 0.8796256610342398 + 1e-6
        assert abs(fc1.std().item() - 1 / np.sqrt(32)) < 0.02
        assert abs(sd["pos_embedding"].std().item() - 0.02) < 0.005
        assert sd[cls].abs().max() > 0
        again = KINDS[kind][1]()
        again.init_weights(torch.Generator().manual_seed(0))
        assert all(torch.equal(sd[k], again.state_dict()[k]) for k in sd)


class TestPositions:
    def test_downsample_37_to_16_matches_jax(self):
        pos = np.random.RandomState(0).randn(1 + 37 * 37, 64).astype(np.float32)
        want = jhf.interpolate_positions(pos, 16 * 16)
        got = thf.interpolate_positions(pos, 16 * 16).numpy()
        assert got.shape == (257, 64)
        np.testing.assert_array_equal(got[0], pos[0])
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    def test_identity_when_matching(self):
        pos = np.random.RandomState(1).randn(5, 8).astype(np.float32)
        np.testing.assert_array_equal(thf.interpolate_positions(pos, 4).numpy(), pos)


def _hf():
    return pytest.importorskip("transformers")


def _clip_model(seed=1):
    transformers = _hf()
    torch.manual_seed(seed)
    cfg = transformers.CLIPConfig(
        text_config=dict(hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                         num_attention_heads=2, vocab_size=64, max_position_embeddings=8),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=IMG, patch_size=16),
        projection_dim=24)
    return transformers.CLIPModel(cfg).eval()


def _dinov2_model(image_size=IMG, seed=0):
    transformers = _hf()
    torch.manual_seed(seed)
    cfg = transformers.Dinov2Config(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                    num_attention_heads=4, image_size=image_size, patch_size=16,
                                    layerscale_value=0.7)
    return transformers.Dinov2Model(cfg).eval()


class TestHFConverters:
    def test_clip_vision_model(self, batch):
        transformers = _hf()
        torch.manual_seed(0)
        hf = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
            image_size=IMG, patch_size=16)).eval()
        tower = thf.tower_from_hf_clip(hf.config.to_dict(), hf.state_dict())
        assert tower.projection_dim is None and tower.num_layers == 3
        with torch.no_grad():
            ref = hf(pixel_values=_nchw(batch), output_hidden_states=True)
            pooled, taps = tower(_nchw(batch), capture=("block1", "block3"))
        np.testing.assert_allclose(pooled.numpy(), ref.pooler_output.numpy(), atol=HF_TOL)
        np.testing.assert_allclose(taps["block3"].numpy(), ref.hidden_states[3].numpy(),
                                   atol=HF_TOL)
        jmod, jparams = jhf.tower_from_hf_clip(hf, projection=False)
        jpooled, _ = jmod.apply({"params": jparams}, jnp.asarray(batch), capture=())
        np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=TOL, rtol=0)

    def test_clip_projection(self, batch):
        hf = _clip_model()
        tower = thf.tower_from_hf_clip(hf.config.to_dict(), hf.state_dict())
        assert tower.projection_dim == 24
        with torch.no_grad():
            ref = hf.get_image_features(pixel_values=_nchw(batch))
            emb, _ = tower(_nchw(batch))
        ref = getattr(ref, "pooler_output", ref)  # newer transformers return an output object
        np.testing.assert_allclose(emb.numpy(), ref.numpy(), atol=HF_TOL)
        jmod, jparams = jhf.tower_from_hf_clip(hf, projection=True)
        jemb, _ = jmod.apply({"params": jparams}, jnp.asarray(batch), capture=())
        np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=TOL, rtol=0)

    def test_dinov2(self, batch):
        hf = _dinov2_model()
        tower = thf.tower_from_hf_dinov2(hf.config.to_dict(), hf.state_dict(), image_size=IMG)
        with torch.no_grad():
            ref = hf(pixel_values=_nchw(batch), output_hidden_states=True)
            pooled, taps = tower(_nchw(batch), capture=("block2",))
        np.testing.assert_allclose(pooled.numpy(), ref.pooler_output.numpy(), atol=HF_TOL)
        np.testing.assert_allclose(taps["block2"].numpy(), ref.hidden_states[2].numpy(),
                                   atol=HF_TOL)
        jmod, jparams = jhf.tower_from_hf_dinov2(hf)
        jpooled, _ = jmod.apply({"params": jparams}, jnp.asarray(batch), capture=())
        np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=TOL, rtol=0)

    def test_vit_snapshot(self, batch, tmp_path):
        """``vit_representations --backend hf``: an HF ViTModel saved to disk,
        read without transformers into the port's ViT, against the model's
        own ``last_hidden_state[:, 0]``."""
        from visreps_tpu_torch.scripts.extract_representations import vit_representations

        transformers = _hf()
        torch.manual_seed(2)
        hf = transformers.ViTModel(transformers.ViTConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
            image_size=IMG, patch_size=16)).eval()
        hf.save_pretrained(tmp_path)
        snap = thf.hf_snapshot_dir(str(tmp_path))
        model = vit_representations.vit_from_hf(*thf.read_hf_snapshot(snap)).eval()
        got = vit_representations.build_extract_hf(model, torch.device("cpu"))(batch)
        with torch.no_grad():
            ref = hf(pixel_values=_nchw(batch)).last_hidden_state[:, 0]
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=HF_TOL)


_READER = """
import json, sys
import numpy as np
import torch
from visreps_tpu_torch.models.hf_vit import converted_tower_available, load_tower
args = json.loads(sys.argv[1])
x = torch.from_numpy(np.load(args["x"]).transpose(0, 3, 1, 2).copy())
out = {}
for key, name in args["towers"].items():
    assert converted_tower_available(name, args["size"]), name
    tower = load_tower(name, pretrained=True, image_size=args["size"], device="cpu")
    with torch.no_grad():
        out[key] = tower(x)[0].numpy()
np.savez(args["out"], **out)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "transformers",
                                                     "visreps_tpu")]
assert not bad, bad
"""


def _read_in_subprocess(tmp: Path, towers: dict, env: dict, x: np.ndarray) -> dict:
    np.save(tmp / "x.npy", x)
    args = {"x": str(tmp / "x.npy"), "towers": towers, "size": IMG, "out": str(tmp / "out.npz")}
    proc = subprocess.run([sys.executable, "-c", _READER, json.dumps(args)], cwd=REPO,
                          env={**env, "PYTHONPATH": str(REPO)}, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return dict(np.load(tmp / "out.npz"))


class TestWeightRoutes:
    @pytest.fixture(scope="class")
    def snapshots(self, tmp_path_factory, batch):
        """A CLIPModel (safetensors) as a local directory, and a 64 px
        Dinov2Model (pytorch_model.bin) in the hub cache's layout under the
        default ``facebook/dinov2-large`` id; the JAX package's outputs of
        both through its own ``load_tower`` at 32 px, which writes its
        converted-tower pickles."""
        tmp = tmp_path_factory.mktemp("towers")
        clip_dir = tmp / "tiny-clip"
        _clip_model().save_pretrained(clip_dir, safe_serialization=True)
        hub = tmp / "hub"
        snap = hub / "models--facebook--dinov2-large" / "snapshots" / "0123abcd"
        _dinov2_model(image_size=64).save_pretrained(snap, safe_serialization=False)
        (snap.parents[1] / "refs").mkdir()
        (snap.parents[1] / "refs" / "main").write_text("0123abcd")
        assert (clip_dir / "model.safetensors").is_file()
        assert (snap / "pytorch_model.bin").is_file()
        mp = pytest.MonkeyPatch()
        jax_cache = tmp / "jax_cache"
        mp.setenv("VISREPS_TOWER_CACHE", str(jax_cache))
        try:
            want = {}
            for key, name in (("clip", str(clip_dir)), ("dinov2", str(snap))):
                state = jhf.load_tower(name, pretrained=True, image_size=IMG)
                out, _ = state.module.apply({"params": state.params}, jnp.asarray(batch),
                                            capture=())
                want[key] = np.asarray(out)
        finally:
            mp.undo()
        assert sorted(p.name for p in jax_cache.iterdir()) == ["clip_32px.pkl", "dinov2_32px.pkl"]
        return {"tmp": tmp, "clip_dir": clip_dir, "hub": hub, "jax_cache": jax_cache,
                "want": want}

    def test_reads_the_jax_converted_pickles(self, snapshots, batch):
        import os

        env = {**os.environ, "VISREPS_TOWER_CACHE": str(snapshots["jax_cache"])}
        got = _read_in_subprocess(snapshots["tmp"], {"clip": "clip-vit-l14",
                                                     "dinov2": "dinov2-l14"}, env, batch)
        for key in ("clip", "dinov2"):
            np.testing.assert_allclose(got[key], snapshots["want"][key], atol=TOL, rtol=0)

    def test_reads_hf_snapshots_without_transformers(self, snapshots, batch, tmp_path):
        """A local CLIP directory (model.safetensors) and the hub cache's
        dinov2-large snapshot (pytorch_model.bin, 64 px grid resampled to
        32 px), reached from the name "dinov2-l14" as in the JAX package;
        the port writes pickles the JAX package reads back."""
        import os

        port_cache = tmp_path / "port_cache"
        env = {**os.environ, "VISREPS_TOWER_CACHE": str(port_cache),
               "HF_HUB_CACHE": str(snapshots["hub"])}
        got = _read_in_subprocess(tmp_path, {"clip": str(snapshots["clip_dir"]),
                                             "dinov2": "dinov2-l14"}, env, batch)
        for key in ("clip", "dinov2"):
            np.testing.assert_allclose(got[key], snapshots["want"][key], atol=TOL, rtol=0)
        mp = pytest.MonkeyPatch()
        mp.setenv("VISREPS_TOWER_CACHE", str(port_cache))
        try:
            for key, name in (("clip", "clip-vit-l14"), ("dinov2", "dinov2-l14")):
                state = jhf.load_tower(name, pretrained=True, image_size=IMG)
                out, _ = state.module.apply({"params": state.params}, jnp.asarray(batch),
                                            capture=())
                np.testing.assert_allclose(np.asarray(out), snapshots["want"][key], atol=TOL,
                                           rtol=0)
        finally:
            mp.undo()

    def test_missing_weights(self, tmp_path, monkeypatch):
        monkeypatch.setenv("VISREPS_TOWER_CACHE", str(tmp_path / "none"))
        monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
        assert not thf.converted_tower_available("clip-vit-l14")
        with pytest.raises(FileNotFoundError, match="No weights"):
            thf.load_tower("clip-vit-l14", pretrained=True, device="cpu")
