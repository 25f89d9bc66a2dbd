"""The PyTorch port's VGG16, ResNet18/50, ViT-B/16 and ECTiedNet against
the JAX package, on the CPU: every tap with the same weights (a seeded
numpy tree in the Flax layout, carried across by
``models/convert.params_from_jax``), parameter counts, init families,
checkpoints written by either package, the ``nn_ops`` factories, and the
extractor's tap-by-tap memory repair.

Small instances where a constructor allows it (ResNet with one
Bottleneck per stage, a 2-layer ViT of width 64); VGG16 and ECTiedNet
(channels 16) at their own structure. Tap tolerance: rtol 1e-4 with an
absolute floor of 1e-4 × the tap's largest |value| (convolution and
reduction order differ between XLA and PyTorch on the CPU)."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visreps_tpu.models import ecnet as jecnet
from visreps_tpu.models import nn_ops as jnn_ops
from visreps_tpu.models import resnet as jresnet
from visreps_tpu.models import standard as jstandard
from visreps_tpu.models import vit as jvit
from visreps_tpu.models.zoo import TORCHVISION_RETURN_NODES as JAX_NODES
from visreps_tpu.models.zoo import ModelState
from visreps_tpu.models.zoo import _build_module as jax_build_module
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor
from visreps_tpu.train import checkpoint as jckpt

from visreps_tpu_torch.data.loader import make_stimuli_loader
from visreps_tpu_torch.data.transforms import get_transform
from visreps_tpu_torch.models import nn_ops
from visreps_tpu_torch.models.convert import params_from_jax, params_to_jax, srp_from_jax
from visreps_tpu_torch.models.ecnet import ECTiedNet, blur_pool, divisive_norm, gn_groups_for
from visreps_tpu_torch.models.extractor import FeatureExtractor, _flatten_hwc
from visreps_tpu_torch.models.resnet import Bottleneck, ResNet
from visreps_tpu_torch.models.standard import VGG16
from visreps_tpu_torch.models.vit import ViTBase
from visreps_tpu_torch.models.zoo import MODEL_REGISTRY, TORCHVISION_RETURN_NODES, init_model
from visreps_tpu_torch.train import checkpoint as tckpt

VIT_SMALL = dict(num_layers=2, hidden_dim=64, num_heads=4, mlp_dim=128)

# name → (JAX module, port module, input size): small instances where the
# constructor allows it.
FAMILIES = {
    "VGG16": (lambda: jstandard.VGG16(num_classes=10), lambda: VGG16(num_classes=10), 32),
    "ResNet18": (lambda: jresnet.ResNet18(10), lambda: MODEL_REGISTRY["ResNet18"](10), 64),
    "ResNet50_small": (
        lambda: jresnet.ResNet((1, 1, 1, 1), jresnet.Bottleneck, 10),
        lambda: ResNet((1, 1, 1, 1), Bottleneck, 10), 64),
    "ViTBase_small": (lambda: jvit.ViTBase(num_classes=10, **VIT_SMALL),
                      lambda: ViTBase(num_classes=10, **VIT_SMALL), 224),
    "ECTiedNet": (lambda: jecnet.ECTiedNet(num_classes=10, channels=16),
                  lambda: ECTiedNet(num_classes=10, channels=16), 64),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fan_in(path, shape) -> int:
    if len(shape) == 3:  # attention: query/key/value (in, heads, hd), out (heads, hd, in)
        return int(np.prod(shape[:2])) if path[-2] == "out" else shape[0]
    return int(np.prod(shape[:-1]))


def random_variables(module, size: int, seed: int = 0):
    """A seeded numpy (params, batch_stats) tree in ``module``'s Flax
    layout: kernels N(0, 1/fan_in), scales N(1, 0.1²), biases and other
    leaves N(0, 0.1²), layer scale 0.5, running means N(0, 0.1²) and
    variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False, capture=()))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = tuple(p.key for p in path)
        shape, name = leaf.shape, keys[-1]
        if name in ("kernel", "dw_weight"):
            v = rng.randn(*shape) / math.sqrt(_fan_in(keys, shape))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "gamma":
            v = np.full(shape, 0.5)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return tree["params"], tree.get("batch_stats")


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    jmod_fn, tmod_fn, size = FAMILIES[request.param]
    jmod = jmod_fn()
    params, stats = random_variables(jmod, size)
    tmod = tmod_fn()
    tmod.load_state_dict(params_from_jax(params, stats))
    return request.param, jmod, params, stats, tmod.eval(), size


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


class TestTapsMatchJax:
    def test_every_tap(self, family):
        name, jmod, params, stats, tmod, size = family
        points = [p for spec in tmod.TAPS.values() for p in spec]
        x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
        variables = {"params": params, **({"batch_stats": stats} if stats else {})}
        jlogits, jtaps = jmod.apply(variables, jnp.asarray(x), train=False, capture=tuple(points))
        with torch.no_grad():
            logits, taps = tmod(torch.from_numpy(x).permute(0, 3, 1, 2), capture=points)
        assert set(taps) == set(jtaps) and len(taps) >= 4
        for p in taps:
            ref = np.asarray(jtaps[p])
            got = _nhwc(taps[p])
            assert got.shape == ref.shape, p
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max(),
                                       err_msg=f"{name} {p}")
        ref = np.asarray(jlogits)
        np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())

    def test_params_round_trip(self, family):
        """``params_to_jax(params_from_jax(tree))`` gives the tree back
        (3-D attention kernels, depthwise kernels, layer scale, tokens)."""
        _, _, params, stats, tmod, _ = family
        back, back_stats = params_to_jax(tmod.state_dict(), getattr(tmod, "num_heads", None))
        flat = dict(jax.tree_util.tree_leaves_with_path(params))
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert set(flat) == set(got)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], v)
        assert (back_stats is None) == (not stats)


class TestFamilies:
    def test_parameter_counts_and_taps_equal_jax(self):
        """Full-size port models (on the meta device) count the JAX
        models' parameters and name the same taps and return nodes."""
        assert TORCHVISION_RETURN_NODES == JAX_NODES
        for name in JAX_NODES:
            jmod = jax_build_module(name, 1000)
            shapes = jax.eval_shape(lambda: jmod.init(
                jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False, capture=()))
            n_jax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes["params"]))
            with torch.device("meta"):
                model = MODEL_REGISTRY[name](num_classes=1000)
            assert sum(p.numel() for p in model.parameters()) == n_jax, name
            assert model.TAPS == jmod.TAPS, name

    def test_init_families(self):
        """Seeded init: the same seed gives the same weights; ResNet and
        VGG16 lecun-normal convs and xavier heads, ViT zero class token
        and N(0, 0.02) positions, ECTiedNet He-normal fan_out depthwise
        kernels, layer scale 1e-3 and unit GroupNorms."""
        a = init_model("ResNet18", 10, seed=3, device="cpu")
        b = init_model("ResNet18", 10, seed=3, device="cpu")
        assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
        w = a.layer2_0.conv2.weight.detach()
        std = (128 * 9) ** -0.5
        assert float(w.std()) == pytest.approx(std, rel=0.05)
        assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
        assert float(a.fc.weight.detach().abs().max()) <= (6 / (512 + 10)) ** 0.5
        assert float(a.bn1.weight.min()) == 1.0 == float(a.bn1.running_var.max())
        vit = ViTBase(num_classes=10, **VIT_SMALL)
        vit.init_weights(torch.Generator().manual_seed(0))
        assert float(vit.cls_token.abs().max()) == 0.0
        assert float(vit.pos_embedding.std()) == pytest.approx(0.02, rel=0.05)
        assert float(vit.head.weight.abs().max()) <= (6 / (64 + 10)) ** 0.5
        ec = ECTiedNet(num_classes=10, channels=16)
        ec.init_weights(torch.Generator().manual_seed(0))
        assert float(ec.block.dw_weight.std()) == pytest.approx((2 / (16 * 9)) ** 0.5, rel=0.25)
        assert float(ec.block.gamma) == pytest.approx(1e-3)
        assert float(ec.block.gn1.weight.min()) == 1.0 and ec.block.gn1.eps == 1e-6
        assert ec.block.gn1.num_groups == gn_groups_for(16) == jecnet.gn_groups_for(16) == 16

    def test_ecnet_weights_are_tied(self):
        """One ECBlock's parameters serve every iteration: a change to its
        depthwise kernel moves every block tap."""
        model = ECTiedNet(num_classes=10, channels=16).eval()
        model.init_weights(torch.Generator().manual_seed(0))
        model.block.gamma.data.fill_(0.5)
        x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(1))
        points = [f"block{i}" for i in range(1, 5)]
        with torch.no_grad():
            before = model(x, capture=points)[1]
            model.block.dw_weight.mul_(2.0)
            after = model(x, capture=points)[1]
        assert all(not torch.equal(before[p], after[p]) for p in points)
        assert [n for n, _ in model.named_children()].count("block") == 1

    def test_blur_and_divisive_norm_match_jax(self):
        x = np.random.RandomState(2).randn(2, 9, 9, 5).astype(np.float32)
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        for got, ref in ((blur_pool(t), jecnet.blur_pool(jnp.asarray(x))),
                         (divisive_norm(t), jecnet.divisive_norm(jnp.asarray(x)))):
            np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-6)

    def test_trainer_refuses_the_new_families(self, tmp_path):
        """The trainer now takes every family: ResNet50 on a 4-image
        ImageNet layout (PCA labels, 2 classes) builds with Bottleneck
        blocks and a 2-class head, and one epoch gives a finite loss."""
        from visreps_tpu_torch.benchmarks.fixture import write_imagenet_fixture
        from visreps_tpu_torch.core.config import Config
        from visreps_tpu_torch.train.trainer import Trainer

        data = write_imagenet_fixture(tmp_path / "imagenet", 5, n_classes=2, pca_n_classes=2)
        cfg = Config({"seed": 1, "model_class": "standard_model", "model_name": "ResNet50",
                      "dataset": "imagenet", "pca_labels": True, "pca_n_classes": 2,
                      "batchsize": 4, "num_workers": 1, "optimizer": "sgd",
                      "learning_rate": 1e-3, "num_epochs": 1, "data_augment": False, **data})
        trainer = Trainer(cfg, device="cpu")
        assert isinstance(trainer.model, ResNet) and trainer.model.block_cls is Bottleneck
        assert trainer.model.fc.out_features == 2
        loss, _ = trainer.train_epoch(1)
        assert np.isfinite(loss) and len(trainer.history) == 1


class TestCheckpoints:
    @pytest.mark.parametrize("name", ["ResNet50_small", "ViTBase_small", "ECTiedNet"])
    def test_written_by_either_package(self, tmp_path, name):
        """A checkpoint of each new family written by the JAX package
        loads in the port (the same spec, logits within 1e-5 of the
        largest) and the port's loads in the JAX package."""
        jmod_fn, tmod_fn, size = FAMILIES[name]
        jmod = jmod_fn()
        params, stats = random_variables(jmod, size, seed=4)
        state = ModelState(module=jmod, params=params, batch_stats=stats, input_size=size)
        x = np.random.RandomState(5).randn(2, size, size, 3).astype(np.float32)
        ref = np.asarray(state.apply(jnp.asarray(x))[0])
        path = jckpt.save_checkpoint(str(tmp_path), 3, state, {}, {"seed": 1})
        model, payload = tckpt.load_checkpoint(path, device="cpu")
        assert model.spec() == jckpt._module_spec(jmod) == payload["module_spec"]
        with torch.no_grad():
            got = model(torch.from_numpy(x).permute(0, 3, 1, 2))[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
        (tmp_path / "port").mkdir()
        back = tckpt.save_checkpoint(str(tmp_path / "port"), 3, model, {}, {"seed": 1})
        jstate, _ = jckpt.load_checkpoint(back)
        np.testing.assert_allclose(np.asarray(jstate.apply(jnp.asarray(x))[0]), ref,
                                   rtol=1e-5, atol=1e-5 * np.abs(ref).max())


class TestNNOps:
    def test_factories_match_jax(self):
        x = np.random.RandomState(3).randn(2, 8, 8, 6).astype(np.float32)
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        for name in ("relu", "tanh", "sigmoid", "elu", "silu", "gelu", "none"):
            np.testing.assert_allclose(nn_ops.get_nonlinearity(name)(t).permute(0, 2, 3, 1),
                                       np.asarray(jnn_ops.get_nonlinearity(name)(x)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        for name in ("max", "avg", "adaptive"):
            got = nn_ops.get_pooling_fn(name)(t).permute(0, 2, 3, 1)
            np.testing.assert_allclose(got, np.asarray(jnn_ops.get_pooling_fn(name)(x)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        for name in ("instance", "layer", "none"):
            jnorm = jnn_ops.get_normalization(name, 6)
            ref = jnorm.apply(jnorm.init(jax.random.PRNGKey(0), x), x) if name != "none" else x
            got = nn_ops.get_normalization(name, 6)(t).permute(0, 2, 3, 1)
            np.testing.assert_allclose(got.detach(), np.asarray(ref), rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        bn = nn_ops.get_normalization("batch", 6).eval()
        torch.testing.assert_close(bn(t), t / math.sqrt(1 + 1e-5), rtol=1e-6, atol=1e-7)
        for bad in (lambda: nn_ops.get_nonlinearity("x"), lambda: nn_ops.get_pooling_fn("x"),
                    lambda: nn_ops.get_normalization("x", 3), lambda: nn_ops.get_initializer("x")):
            with pytest.raises(ValueError):
                bad()

    @pytest.mark.parametrize("name,std", [("xavier", (2 / (64 + 32)) ** 0.5),
                                          ("kaiming", (2 / 64) ** 0.5),
                                          ("gaussian", 0.02), ("uniform", 0.02 / 12 ** 0.5)])
    def test_initializers(self, name, std):
        w = torch.empty(64, 32)
        nn_ops.get_initializer(name)(w, torch.Generator().manual_seed(0))
        ref = np.asarray(jnn_ops.get_initializer(name)(jax.random.PRNGKey(0), (32, 64)))
        assert float(w.std()) == pytest.approx(std, rel=0.1)
        assert float(ref.std()) == pytest.approx(std, rel=0.1)
        if name == "uniform":
            assert 0.0 <= float(w.min()) and float(w.max()) < 0.02


class TestExtractor:
    @pytest.fixture(scope="class")
    def vit(self):
        jmod = jvit.ViTBase(num_classes=10, **VIT_SMALL)
        params, _ = random_variables(jmod, 224, seed=6)
        model = ViTBase(num_classes=10, **VIT_SMALL)
        model.load_state_dict(params_from_jax(params))
        return ModelState(module=jmod, params=params, input_size=224), model.eval()

    @staticmethod
    def _stimuli(n):
        rng = np.random.RandomState(8)
        return {str(i): rng.randint(0, 256, (64, 64, 3), dtype=np.uint8) for i in range(n)}

    def test_vit_activations_match_jax(self, vit):
        """ViT's token taps through both packages' extractors (same
        weights and SRP matrices): the JAX package's flattening order."""
        state, model = vit
        nodes = ["patch_embed", "block1", "block2", "head"]
        stimuli = self._stimuli(5)
        jext = JaxExtractor(state, nodes, srp_k=64, batch_size=2)
        ref, ref_ids = jext.get_activations(make_stimuli_loader(
            stimuli, get_transform("imgnet", normalize=False), 2, 2), store="host")
        ext = FeatureExtractor(model, nodes, srp_k=64, device="cpu")
        assert ext.tap_dims == jext.tap_dims == {"patch_embed": 196 * 64, "block1": 197 * 64,
                                                 "block2": 197 * 64, "head": 10}
        srp_from_jax(ext.srp, {d: tuple(np.asarray(c, np.float32) for c in
                                        jext.srp.matrix_chunks(d))
                               for d in set(jext.tap_dims.values())})
        got, ids = ext.get_activations(make_stimuli_loader(
            stimuli, get_transform("imgnet", normalize=False), 2, 2), store="host")
        assert ids == ref_ids and list(got) == list(ref)
        for name in ref:
            b = np.asarray(ref[name])
            np.testing.assert_allclose(got[name].numpy(), b, rtol=1e-2,
                                       atol=1e-2 * np.abs(b).max(), err_msg=name)

    def test_tap_by_tap_outputs_unchanged(self, vit):
        """The memory repair computes what the all-taps-alive version
        did: each tap's projection of the flattened batch, bit for bit;
        exact taps written in place equal the flattened taps; rows
        already in order come back as views of the store, other orders
        as gathered copies of the same rows."""
        _, model = vit
        stimuli = self._stimuli(6)
        nodes = ["patch_embed", "block2", "head"]
        ext = FeatureExtractor(model, nodes, srp_k=64, device="cpu")
        loader = make_stimuli_loader(stimuli, get_transform("imgnet"), 4, 2)
        acts, ids = ext.get_activations(loader, store="host")
        x = torch.from_numpy(np.stack([get_transform("imgnet")(stimuli[k]) for k in ids]))
        batches = [x[:4], x[4:]]
        with torch.no_grad():
            taps = [model(b.permute(0, 3, 1, 2), capture=ext.points)[1] for b in batches]
        for p in ext.points:
            ref = torch.cat([ext.srp(_flatten_hwc(t[p])) for t in taps])
            assert torch.equal(acts[p], ref), p
        def stored_rows(t):  # rows of the storage a result lives in
            return t.untyped_storage().nbytes() // (4 * t.shape[1])

        exact, exact_ids = ext.extract_layers_exact(loader, ["block2", "patch_embed"], ids[:5])
        assert exact_ids == ids[:5]
        for p in ("block2", "patch_embed"):
            ref = torch.cat([_flatten_hwc(t[p]) for t in taps])[:5]
            assert stored_rows(exact[p]) == 6 and torch.equal(exact[p], ref), p
        order = [ids[3], ids[0], ids[5]]
        gathered, got_ids = ext.extract_layers_exact(loader, ["block2"], order)
        assert got_ids == order and stored_rows(gathered["block2"]) == 3
        ref = torch.cat([_flatten_hwc(t["block2"]) for t in taps])[[3, 0, 5]]
        assert torch.equal(gathered["block2"], ref)


def test_rdm_row_variances_in_blocks_unchanged(monkeypatch):
    """``compute_rdm`` squares wide rows a block at a time (the memory
    repair for VGG16's 3.2M-wide exact taps): the RDM equals the
    one-block result bit for bit, and the JAX package's within 1e-6."""
    from visreps_tpu.ops.rdm import compute_rdm as jax_compute_rdm
    from visreps_tpu_torch.ops import rdm as rdm_ops

    x = np.random.RandomState(9).randn(37, 300).astype(np.float32)
    whole = rdm_ops.compute_rdm(torch.from_numpy(x))
    monkeypatch.setattr(rdm_ops, "_SQUARE_ELEMS", 2 * 300)  # 2 rows a block: 19 blocks
    blocks = rdm_ops.compute_rdm(torch.from_numpy(x))
    assert torch.equal(blocks, whole)
    np.testing.assert_allclose(blocks.numpy(), np.asarray(jax_compute_rdm(jnp.asarray(x))),
                               atol=1e-6)


def test_chip_smoke_parameter_counts_are_jax():
    """The counts ``chip_smoke.py`` holds the card's models to (it may not
    import JAX) are the JAX models' own."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for name, count in chip_smoke.MODEL_PARAMS.items():
        shapes = jax.eval_shape(lambda: jax_build_module(name, 1000).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False, capture=()))
        assert sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(
            shapes["params"])) == count, name


def test_resnet_stem_pool_pads_with_minus_inf():
    """The stem's 3×3/2 max pool pads with −inf (the JAX package pads
    explicitly): an all-negative map keeps its border values."""
    x = -torch.rand(1, 2, 6, 6) - 1.0
    got = torch.nn.functional.max_pool2d(x, 3, 2, padding=1)
    ref = jax.lax.reduce_window(
        jnp.pad(jnp.asarray(x.numpy()), ((0, 0), (0, 0), (1, 1), (1, 1)),
                constant_values=-jnp.inf), -jnp.inf, jax.lax.max, (1, 1, 3, 3),
        (1, 1, 2, 2), "VALID")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_resnet_init_family_matches_jax():
    """The port's ResNet draws the JAX ResNet's families (Flax's default
    Conv init, lecun-normal truncated; xavier-uniform fc): the same
    spread and bound as the JAX initialisers at the same shapes."""
    model = ResNet((1, 1, 1, 1), num_classes=10)
    model.init_weights(torch.Generator().manual_seed(0))
    key = jax.random.PRNGKey(0)
    jw = np.asarray(jax.nn.initializers.lecun_normal()(key, (3, 3, 128, 128)))
    tw = model.layer2_0.conv2.weight.detach()
    assert float(jw.std()) == pytest.approx(float(tw.std()), rel=0.05)
    assert max(float(np.abs(jw).max()), float(tw.abs().max())) <= \
        2 * (128 * 9) ** -0.5 / 0.8796 + 1e-6
    jfc = np.asarray(jax.nn.initializers.xavier_uniform()(key, (512, 10)))
    assert float(jfc.std()) == pytest.approx(float(model.fc.weight.detach().std()), rel=0.1)
    assert float(model.bn1.weight.min()) == 1.0
