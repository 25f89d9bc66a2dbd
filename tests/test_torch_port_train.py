"""The PyTorch port's training path against the JAX package's, on the
CPU: CustomCNN and its layers, the train step, the optimizer chain and
learning-rate table, the trainer, checkpoints both ways, the data
pipeline, device augmentation and the training CLI. Weights are carried
across with ``models/convert.params_from_jax``; inputs come from numpy
seeds. Each test states its tolerance."""
import json
import os
import pickle
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import visreps_tpu.data.loader as jloader
from visreps_tpu.core.config import Config as JaxConfig
from visreps_tpu.data import obj_cls as jobj
from visreps_tpu.data.augment import augment_batch as jax_augment_batch
from visreps_tpu.data.transforms import get_transform as jax_transform
from visreps_tpu.models.layers import TorchBatchNorm
from visreps_tpu.models.zoo import init_model as jax_init_model
from visreps_tpu.train import checkpoint as jckpt
from visreps_tpu.train.optim import lr_at_epoch as jax_lr_at_epoch
from visreps_tpu.train.optim import make_schedule, setup_optimizer
from visreps_tpu.train.trainer import Trainer as JaxTrainer
from visreps_tpu.train.trainer import make_train_step, optax_global_norm

from visreps_tpu_torch.benchmarks.fixture import write_imagenet_fixture
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.data import obj_cls as tobj
from visreps_tpu_torch.data.augment import apply_augment, augment_params
from visreps_tpu_torch.data.loader import PrefetchLoader
from visreps_tpu_torch.data.transforms import get_transform
from visreps_tpu_torch.models.convert import params_from_jax, params_to_jax
from visreps_tpu_torch.models.custom_cnn import CUSTOM_CNN_TAPS, CustomCNN, TinyCustomCNN
from visreps_tpu_torch.models.layers import BatchNorm1d
from visreps_tpu_torch.models.zoo import init_model
from visreps_tpu_torch.train import checkpoint as tckpt
from visreps_tpu_torch.train import trainer as ttrainer
from visreps_tpu_torch.train.optim import Optimizer, cross_entropy_loss, lr_at_epoch

REPO = Path(__file__).resolve().parents[1]
POINTS = [p for spec in CUSTOM_CNN_TAPS.values() for p in spec]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _perturb_bn(params, stats, seed):
    """Random BN scales, biases and running statistics (init makes them
    1, 0, 0, 1, which would hide a wrong mapping)."""
    rng = np.random.RandomState(seed)
    params, stats = _np_tree(params), _np_tree(stats)
    for name in stats:
        bn, st = params[name]["bn"], stats[name]["bn"]
        f = bn["scale"].shape[0]
        bn["scale"] = (1 + 0.2 * rng.randn(f)).astype(np.float32)
        bn["bias"] = (0.2 * rng.randn(f)).astype(np.float32)
        st["mean"] = (0.2 * rng.randn(f)).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
    return params, stats


def _torch_model(cls, num_classes, params, stats, **kwargs):
    model = cls(num_classes=num_classes, **kwargs)
    model.load_state_dict(params_from_jax(params, stats))
    return model


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy() if t.dim() == 4 else t.detach().numpy()


def _close(got, ref, rtol, err_msg="", floor=0.0):
    """|got − ref| ≤ rtol · max|ref| + floor elementwise (a scale-relative bound)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max() + floor,
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def custom224():
    """CustomCNN (32 classes, dropout 0) with random BN, in both packages."""
    state = jax_init_model("CustomCNN", 32, seed=0, cfg={"arch": {"dropout": 0.0}}, cache=False)
    params, stats = _perturb_bn(state.params, state.batch_stats, 1)
    return state.module, params, stats


class TestCustomCNN:
    @pytest.mark.parametrize("train", [False, True])
    def test_taps_logits_and_stats_match_jax(self, custom224, train):
        """(a) Every tap and the logits at 224 px in eval and train mode
        (dropout 0), and the updated BN statistics in train mode: within
        1e-4 of each tensor's largest value. Batch 4: at batch 2 a dense
        BN divides a feature's two values by their own spread, which
        magnifies f32 rounding where the two nearly coincide."""
        module, params, stats = custom224
        x = np.random.RandomState(2).randn(4, 224, 224, 3).astype(np.float32)
        out = module.apply({"params": params, "batch_stats": stats}, x, train=train,
                           capture=tuple(POINTS), mutable=["batch_stats"] if train else False)
        (jlogits, jtaps), new_stats = (out if train else (out, None))
        model = _torch_model(CustomCNN, 32, params, stats, dropout=0.0).train(train)
        with torch.no_grad():
            logits, taps = model(_nchw(x), capture=POINTS)
        assert sorted(taps) == sorted(POINTS) and len(POINTS) == 15
        for p in POINTS:
            _close(_nhwc(taps[p]), jtaps[p], 1e-4, err_msg=p)
        _close(logits.numpy(), jlogits, 1e-4)
        if train:
            _, got_stats = params_to_jax(model.state_dict())
            ref = _flat(new_stats["batch_stats"])
            got = _flat(got_stats)
            assert set(got) == set(ref) and len(ref) == 14
            for k in ref:
                _close(got[k], ref[k], 1e-4, err_msg=k)

    def test_tiny_shapes_mask_and_frozen_bn(self):
        """TinyCustomCNN's tap shapes match the JAX module's; a frozen
        layer's BN stays in eval mode inside ``model.train()``."""
        jstate = jax_init_model("TinyCustomCNN", 10, seed=0, cache=False,
                                cfg={"arch": {"conv_trainable": "00111", "fc_trainable": "101"}})
        model = TinyCustomCNN(num_classes=10, conv_trainable="00111", fc_trainable="101")
        assert model.trainable_mask() == jstate.module.trainable_mask()
        assert model.spec() == jckpt._module_spec(jstate.module)
        x = np.zeros((1, 64, 64, 3), np.float32)
        _, jtaps = jstate.apply(x, capture=tuple(POINTS))
        with torch.no_grad():
            _, taps = model.eval()(_nchw(x), capture=POINTS)
        assert {p: _nhwc(t).shape for p, t in taps.items()} == \
            {p: np.asarray(t).shape for p, t in jtaps.items()}
        model.train()
        assert [m.training for m in (model.conv1.bn, model.conv2.bn, model.conv3.bn,
                                     model.fc1.bn, model.fc2.bn)] == [False, False, True, True, False]
        assert model.fc1.fc.training and model.conv1.training

    def test_dropout_is_seeded_and_scaled(self):
        model = CustomCNN(num_classes=4).train()
        model.init_weights(torch.Generator().manual_seed(0))
        x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1))
        a, _ = model(x, generator=torch.Generator().manual_seed(5))
        b, _ = model(x, generator=torch.Generator().manual_seed(5))
        c, _ = model(x, generator=torch.Generator().manual_seed(6))
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="Generator"):
            model(x)

    def test_init_family(self):
        """He-normal fan_out kernels, N(0, 1/√fan_in) head, zero biases,
        BN at (1, 0, 0, 1); the same seed gives the same weights."""
        a = init_model("TinyCustomCNN", 10, seed=3, device="cpu")
        b = init_model("TinyCustomCNN", 10, seed=3, device="cpu")
        assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                    b.state_dict().values()))
        w = a.conv4.conv.weight.detach()
        assert float(w.std()) == pytest.approx((2 / (512 * 9)) ** 0.5, rel=0.05)
        assert float(a.fc1.fc.weight.detach().std()) == pytest.approx((2 / 2048) ** 0.5, rel=0.05)
        assert float(a.fc3.weight.detach().std()) == pytest.approx(2048 ** -0.5, rel=0.05)
        assert not a.fc1.fc.bias.any() and not a.fc3.bias.any()
        assert a.conv1.conv.bias is None and torch.equal(a.fc2.bn.weight, torch.ones(2048))


class TestTrainStep:
    def test_one_step_matches_make_train_step(self):
        """(b) TinyCustomCNN, 64 px, bs 8, dropout 0, AdamW + clip: the
        loss and gradient norm within rtol 1e-5, every gradient and BN
        running statistic within 1e-4 of the tensor's largest value (and
        1e-7 absolute: a dense bias before BN has a gradient of 0 up to
        rounding);
        updated parameters within 1e-6 for ≥ 99 % of elements and within
        2 · lr everywhere (Adam's first update is ≈ lr · sign(g), so a
        gradient within rounding of 0 may flip)."""
        n_cls, lr = 10, 1e-3
        state = jax_init_model("TinyCustomCNN", n_cls, seed=0, cache=False,
                               cfg={"arch": {"dropout": 0.0}})
        params, stats = _perturb_bn(state.params, state.batch_stats, 2)
        rng = np.random.RandomState(3)
        x = rng.randn(8, 64, 64, 3).astype(np.float32)
        y = rng.randint(0, n_cls, 8)
        cfg = {"optimizer": "adamw", "learning_rate": lr, "weight_decay": 1e-3, "grad_clip": 1.0,
               "lr_scheduler": "cosineannealinglr", "num_epochs": 10, "warmup_epochs": 0}

        def loss_fn(p):
            (logits, _), upd = state.module.apply(
                {"params": p, "batch_stats": stats}, x, train=True, capture=(),
                rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
            from visreps_tpu.train.optim import cross_entropy_loss as jce
            return jce(logits, y, 0.1), upd

        (jloss, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        tx, _ = setup_optimizer(params, JaxConfig(cfg), steps_per_epoch=5)
        step = make_train_step(state.module, tx)
        jp, js, _, jloss2, jgn = step(params, stats, tx.init(params), jnp.asarray(x),
                                      jnp.asarray(y), jax.random.PRNGKey(0))

        model = _torch_model(TinyCustomCNN, n_cls, params, stats, dropout=0.0)
        opt = Optimizer(model, Config(cfg), 5, model.trainable_mask())
        model.train()
        logits, _ = model(_nchw(x))
        loss = cross_entropy_loss(logits, torch.from_numpy(y))
        loss.backward()
        grads = {k: v.grad.clone() for k, v in model.named_parameters()}
        gn = opt.step(0)

        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        assert float(jloss2) == pytest.approx(float(jloss), rel=1e-6)
        assert float(gn) == pytest.approx(float(jgn), rel=1e-5)
        ref_grads = _flat(_np_tree(jgrads))
        got_grads = _flat(params_to_jax(grads)[0])
        assert set(got_grads) == set(ref_grads) and len(ref_grads) == 25
        for k in ref_grads:
            _close(got_grads[k], ref_grads[k], 1e-4, err_msg=k, floor=1e-7)
        new_params, new_stats = params_to_jax(model.state_dict())
        for k, ref in _flat(_np_tree(js)).items():
            _close(_flat(new_stats)[k], ref, 1e-4, err_msg=k)
        got, ref = _flat(new_params), _flat(_np_tree(jp))
        diff = {k: np.abs(got[k] - ref[k]).ravel() for k in ref}
        diff = np.concatenate(list(diff.values()))
        assert diff.max() <= 2 * lr and (diff > 1e-6).mean() < 0.01

    @pytest.mark.parametrize("where", ["layer", "model"])
    def test_dense_batchnorm_on_one_row(self, where):
        """(c) A training batch of one row: torch's BatchNorm1d raises;
        the port returns the JAX package's output (exactly ``bias`` at
        the layer; within 1e-5 of the largest logit through the whole
        model) and the same running statistics (1e-6 at the layer, 1e-5
        of each tensor's largest value through the model's convolutions)."""
        rng = np.random.RandomState(4)
        if where == "layer":
            f = 6
            x = rng.randn(1, f).astype(np.float32)
            variables = {"params": {"scale": rng.randn(f).astype(np.float32),
                                    "bias": rng.randn(f).astype(np.float32)},
                         "batch_stats": {"mean": rng.randn(f).astype(np.float32),
                                         "var": rng.uniform(0.5, 2, f).astype(np.float32)}}
            ref, upd = TorchBatchNorm(use_running_average=False).apply(
                variables, x, mutable=["batch_stats"])
            bn = BatchNorm1d(f)
            with torch.no_grad():
                bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
                bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
                bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
                bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
            with pytest.raises(ValueError):
                torch.nn.BatchNorm1d(f).train()(torch.from_numpy(x))
            xt = torch.from_numpy(x).requires_grad_()
            out = bn.train()(xt)
            out.sum().backward()
            assert torch.equal(out.detach()[0], bn.bias.detach())
            np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
            assert float(xt.grad.abs().max()) == 0.0
            got = {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
            ref_stats = _np_tree(upd["batch_stats"])
        else:
            state = jax_init_model("TinyCustomCNN", 5, seed=0, cache=False,
                                   cfg={"arch": {"dropout": 0.0}})
            params, stats = _perturb_bn(state.params, state.batch_stats, 5)
            x = rng.randn(1, 64, 64, 3).astype(np.float32)
            (ref, _), upd = state.module.apply({"params": params, "batch_stats": stats}, x,
                                               train=True, capture=(), mutable=["batch_stats"])
            model = _torch_model(TinyCustomCNN, 5, params, stats, dropout=0.0).train()
            with torch.no_grad():
                out, _ = model(_nchw(x))
            _close(out.numpy(), ref, 1e-5)
            got = _flat(params_to_jax(model.state_dict())[1])
            ref_stats = _flat(_np_tree(upd["batch_stats"]))
        for k in ref_stats:
            _close(got[k], ref_stats[k], 1e-6 if where == "layer" else 1e-5, err_msg=k)


def _synthetic_grads(params, scale, seed):
    """Random gradients of global norm ≈ ``scale``, each leaf ≈ scale / √leaves."""
    rng = np.random.RandomState(seed)
    per_leaf = scale / np.sqrt(len(jax.tree_util.tree_leaves(params)))
    return jax.tree_util.tree_map(
        lambda p: (per_leaf * rng.randn(*np.shape(p)) / np.sqrt(np.size(p))).astype(np.float32),
        params)


class _Small(torch.nn.Module):
    """Every parameter kind of CustomCNN (conv kernel, BN scale and bias,
    dense kernel and bias, head) at a size the chain runs fast on."""

    def __init__(self):
        super().__init__()
        from visreps_tpu_torch.models.layers import ConvBNReLU, DenseBNReLU

        self.conv1 = ConvBNReLU(3, 4, 3)
        self.fc1 = DenseBNReLU(8, 5)
        self.fc3 = torch.nn.Linear(5, 3)


def _run_chains(cfg, model, mask, scales, steps=3):
    """The JAX chain (``setup_optimizer``) and the port's ``Optimizer``
    over ``model``'s parameters for ``steps`` synthetic gradients.
    Returns (JAX params, port params, JAX grad norms, port grad norms)."""
    params = params_to_jax(model.state_dict())[0]
    tx, _ = setup_optimizer(params, JaxConfig(cfg), steps_per_epoch=2, trainable_mask=mask)
    opt = Optimizer(model, Config(cfg), 2, mask)
    jparams, opt_state = params, tx.init(params)
    jnorms, tnorms = [], []
    for i in range(steps):
        grads = _synthetic_grads(params, scales(i), seed=10 + i)
        jnorms.append(float(optax_global_norm(grads)))
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), jparams, updates)
        gstate = params_from_jax(grads)
        for name, p in model.named_parameters():
            p.grad = gstate[name].clone()
        tnorms.append(float(opt.step(i)))
    return _flat(jparams), _flat(params_to_jax(model.state_dict())[0]), jnorms, tnorms


class TestOptimizer:
    @pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
    @pytest.mark.parametrize("scale", [0.3, 30.0], ids=["below_clip", "above_clip"])
    def test_chain_matches_setup_optimizer(self, name, scale):
        """(d) Three updates on synthetic gradients (global norm ≈ scale,
        clip 1.0), crossing an epoch boundary of the lr table: parameters
        within 1e-6 + 1e-5 relative, reported norms within rtol 1e-5."""
        cfg = {"optimizer": name, "learning_rate": 1e-2, "weight_decay": 0.05, "grad_clip": 1.0,
               "lr_scheduler": "cosineannealinglr", "num_epochs": 4, "warmup_epochs": 1}
        torch.manual_seed(0)
        jp, tp, jn, tn = _run_chains(cfg, _Small(), None, lambda i: scale * (1 + i))
        np.testing.assert_allclose(tn, jn, rtol=1e-5)
        assert (max(jn) < 1.0) == (scale < 1.0)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-6, err_msg=k)

    def test_frozen_layers_and_the_two_norms(self):
        """(d) conv_trainable="00111": frozen parameters do not move, the
        clip sees only the trainable gradients (19 of 25 leaves: their
        norm ≈ 0.96 is under clip 1.0 while the norm of all ≈ 1.1 is
        above it), and the reported norm spans all gradients. Tolerances
        as above."""
        cfg = {"optimizer": "adamw", "learning_rate": 1e-2, "weight_decay": 0.05,
               "grad_clip": 1.0, "lr_scheduler": "cosineannealinglr", "num_epochs": 4,
               "warmup_epochs": 0}
        model = init_model("TinyCustomCNN", 10, seed=0, device="cpu",
                           arch={"conv_trainable": "00111"})
        init = _flat(params_to_jax(model.state_dict())[0])
        jp, tp, jn, tn = _run_chains(cfg, model, model.trainable_mask(), lambda i: 1.1, steps=2)
        np.testing.assert_allclose(tn, jn, rtol=1e-5)
        assert min(jn) > 1.0
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-6, err_msg=k)
            frozen = k.startswith(("conv1/", "conv2/"))
            assert np.array_equal(tp[k], init[k]) == frozen, k

    def test_frozen_bn_statistics_do_not_move(self):
        model = init_model("TinyCustomCNN", 10, seed=0, device="cpu",
                           arch={"conv_trainable": "00111", "dropout": 0.0})
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = Optimizer(model, Config({"optimizer": "adamw", "learning_rate": 1e-2,
                                       "num_epochs": 1, "grad_clip": 1.0}), 1,
                        model.trainable_mask())
        x = torch.randn(4, 3, 64, 64, generator=torch.Generator().manual_seed(0))
        ttrainer.train_step(model, opt, x, torch.tensor([0, 1, 2, 3]), None, 0)
        after = model.state_dict()
        for k in before:
            if k.endswith("num_batches_tracked"):
                continue
            moved = not torch.equal(before[k], after[k])
            assert moved == (not k.startswith(("conv1.", "conv2."))), k


class TestSchedule:
    @pytest.mark.parametrize("scheduler", ["steplr", "multisteplr", "cosineannealinglr"])
    @pytest.mark.parametrize("warmup", [0, 3])
    def test_lr_table(self, scheduler, warmup):
        """(e) lr_at_epoch equals the JAX function exactly; the per-step
        rate equals the JAX schedule (a float32 table) within rtol 1e-7."""
        cfg = {"learning_rate": 0.002, "num_epochs": 25, "warmup_epochs": warmup,
               "lr_scheduler": scheduler, "optimizer": "adamw"}
        for e in range(26):
            assert lr_at_epoch(Config(cfg), e) == jax_lr_at_epoch(JaxConfig(cfg), e)
        schedule = make_schedule(JaxConfig(cfg), steps_per_epoch=3)
        opt = Optimizer(torch.nn.Linear(2, 2), Config(cfg), 3)
        steps = np.arange(0, 3 * 27)
        np.testing.assert_allclose([opt.lr_at_step(int(s)) for s in steps],
                                   [float(schedule(s)) for s in steps], rtol=1e-7)


@pytest.fixture(scope="module")
def tiny_imagenet(tmp_path_factory):
    """Tiny-ImageNet layout: 3 classes × 8 class-coloured 64 px JPEGs in
    train/ and 3 × 2 in val/. The pixel noise is strong: on near-flat
    images whole channels die behind ReLU, their gradients are 0 up to
    rounding, and Adam's first update (≈ lr · sign(g)) turns that
    rounding into ±lr steps that differ between the two packages."""
    root = tmp_path_factory.mktemp("tinyds")
    rng = np.random.RandomState(0)
    for split, n in (("train", 8), ("val", 2)):
        for c in range(3):
            d = root / split / f"class{c:02d}"
            d.mkdir(parents=True)
            for i in range(n):
                img = np.full((64, 64, 3), (60 + 70 * c, 200 - 60 * c, 90), np.int64)
                img = np.clip(img + rng.randint(-100, 100, img.shape), 0, 255).astype(np.uint8)
                Image.fromarray(img).save(d / f"img{i}.jpg")
    return str(root)


def _train_cfg(cls, path, **kw):
    base = {"mode": "train", "seed": 1, "dataset": "tiny-imagenet", "dataset_path": path,
            "data_augment": False, "optimizer": "adamw", "learning_rate": 3e-3,
            "weight_decay": 1e-3, "grad_clip": 1.0, "lr_scheduler": "cosineannealinglr",
            "num_epochs": 2, "warmup_epochs": 0, "log_interval": 1, "checkpoint_interval": 1,
            "batchsize": 8, "num_workers": 2, "log_checkpoints": False,
            "checkpoint_dir": "ckpt", "use_wandb": False, "pca_labels": False,
            "pca_n_classes": 2, "model_class": "custom_model", "model_name": "TinyCustomCNN",
            "arch": {"conv_trainable": "11111", "fc_trainable": "111", "pooling_type": "max",
                     "dropout": 0.0}}
    base.update(kw)
    return cls(base)


def test_trainer_matches_jax_trainer(tiny_imagenet, monkeypatch):
    """(f) Three steps (24 train images, bs 8) of the port's Trainer and
    the JAX Trainer from the same weights: the same batches in the same
    order (images equal, labels equal), losses within rtol 1e-4, and the
    same accuracies on both splits afterwards.
    SGD: Adam's update g / √(g²) is ill-conditioned where gradients are
    small, so after two Adam steps the packages' trajectories part by
    ~1e-3 (the optimizers themselves are compared exactly above)."""
    monkeypatch.setenv("VISREPS_INIT_CACHE", "0")
    jtr = JaxTrainer(_train_cfg(JaxConfig, tiny_imagenet, optimizer="sgd", learning_rate=1e-2))
    init = params_from_jax(_np_tree(jtr.state.params), _np_tree(jtr.state.batch_stats))
    jseen = []
    jstep = jtr.train_step

    def jrecord(params, stats, opt, images, labels, key):
        seen = (np.asarray(images), np.asarray(labels))
        out = jstep(params, stats, opt, images, labels, key)
        jseen.append((*seen, float(out[3])))
        return out

    jtr.train_step = jrecord
    jtr.train_epoch(1)

    ttr = ttrainer.Trainer(_train_cfg(Config, tiny_imagenet, optimizer="sgd", learning_rate=1e-2),
                           device="cpu")
    ttr.model.load_state_dict(init)
    tseen = []
    tstep = ttrainer.train_step

    def trecord(model, optimizer, images, labels, *args):
        out = tstep(model, optimizer, images, labels, *args)
        tseen.append((_nhwc(images), labels.numpy(), float(out[0])))
        return out

    monkeypatch.setattr(ttrainer, "train_step", trecord)
    ttr.train_epoch(1)
    assert len(tseen) == len(jseen) == 3 == ttr.steps_per_epoch
    for i, ((ti, tl, tloss), (ji, jl, jloss)) in enumerate(zip(tseen, jseen)):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(ti, ji)
        assert tloss == pytest.approx(jloss, rel=1e-4)
    assert [h["loss"] for h in ttr.history] == [s[2] for s in tseen]
    for split in ("test", "train"):  # 3 classes: top-5 is "" in both
        assert ttr.evaluate(split) == jtr.evaluate(split)


def test_trainer_device_augment(tiny_imagenet, monkeypatch):
    """``device_augment``: the host loaders run without augmentation and
    the trainer flips and rotates each batch from its own generator."""
    cfg = _train_cfg(Config, tiny_imagenet, data_augment=True, device_augment=True)
    tr = ttrainer.Trainer(cfg, device="cpu")
    assert not any(ds.transform.spec["augment"] for ds in tr.datasets.values())
    seen = []
    augment = ttrainer.augment_batch

    def record(images, gen):
        out = augment(images, gen)
        seen.append((images, out))
        return out

    monkeypatch.setattr(ttrainer, "augment_batch", record)
    tr.train_epoch(1)
    assert len(seen) == 3 and all(not torch.equal(a, b) for a, b in seen)
    assert all(np.isfinite(h["loss"]) for h in tr.history)


class TestCheckpoint:
    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_checkpoints_load_in_the_other_package(self, tmp_path, writer):
        """(g) A checkpoint written by one package loads in the other:
        the same logits (within 1e-5 of the largest), the same spec and
        epoch; both packages' config.json count the same parameters."""
        arch = {"conv_trainable": "01111", "fc_trainable": "110", "dropout": 0.2}
        cfg = {"seed": 2, "dataset": "tiny-imagenet", "pca_labels": True, "pca_n_classes": 4,
               "model_name": "TinyCustomCNN", "arch": arch}
        state = jax_init_model("TinyCustomCNN", 4, seed=0, cfg={"arch": arch}, cache=False)
        state.params, state.batch_stats = _perturb_bn(state.params, state.batch_stats, 6)
        model = _torch_model(TinyCustomCNN, 4, state.params, state.batch_stats,
                             conv_trainable="01111", fc_trainable="110", dropout=0.2).eval()
        jdir, jcfg = jckpt.setup_checkpoint_dir(
            JaxConfig({**cfg, "checkpoint_dir": str(tmp_path / "jax")}), state)
        tdir, tcfg = tckpt.setup_checkpoint_dir(
            Config({**cfg, "checkpoint_dir": str(tmp_path / "torch")}), model)
        assert Path(tdir) == tmp_path / "torch" / "cfg4b" and Path(jdir).name == "cfg4b"
        assert (tcfg["total_params"], tcfg["trainable_params"]) == \
            (jcfg["total_params"], jcfg["trainable_params"])
        assert json.loads((Path(tdir) / "config.json").read_text()) == tcfg
        x = np.random.RandomState(7).randn(3, 64, 64, 3).astype(np.float32)
        if writer == "jax":
            path = jckpt.save_checkpoint(jdir, 5, state, {"test_acc": 1.5}, jcfg)
            loaded, payload = tckpt.load_checkpoint(path, device="cpu")
            with torch.no_grad():
                got = loaded(_nchw(x))[0].numpy()
            ref = np.asarray(state.apply(x)[0])
            assert loaded.spec() == payload["module_spec"] and not loaded.training
        else:
            path = tckpt.save_checkpoint(tdir, 5, model, {"test_acc": 1.5}, tcfg)
            jstate, payload = jckpt.load_checkpoint(path)
            got = np.asarray(jstate.apply(x)[0])
            with torch.no_grad():
                ref = model(_nchw(x))[0].numpy()
            assert jckpt._module_spec(jstate.module) == model.spec()
            assert payload["input_size"] == jstate.input_size == 64
        assert payload["epoch"] == 5 and payload["metrics"] == {"test_acc": 1.5}
        _close(got, ref, 1e-5)

    def test_round_trip_is_exact_and_foreign_files_raise(self, tmp_path):
        model = init_model("CustomCNN", 8, seed=1, device="cpu")
        path = tckpt.save_checkpoint(str(tmp_path), 2, model, {}, {"seed": 1})
        loaded, payload = tckpt.load_checkpoint(path, device="cpu")
        a, b = model.state_dict(), loaded.state_dict()
        assert set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in a if not k.endswith("num_batches_tracked"))
        with open(path, "rb") as f:
            raw = pickle.load(f)
        assert type(raw["params"]["conv1"]["conv"]["kernel"]) is np.ndarray
        assert raw["params"]["conv1"]["conv"]["kernel"].shape == (11, 11, 3, 96)
        assert raw["batch_stats"]["fc2"]["bn"]["var"].shape == (4096,)
        zipped = tmp_path / "ref.pth"  # the zip magic takes the reference-checkpoint route
        zipped.write_bytes(b"PK\x03\x04rest")
        with pytest.raises(RuntimeError, match="zip archive"):
            tckpt.load_checkpoint(zipped, device="cpu")
        raw["module_spec"] = {"class": "NoSuchNet", "num_classes": 8}
        other = tmp_path / "unknown.pth"
        other.write_bytes(pickle.dumps(raw))
        with pytest.raises(ValueError, match="Unknown module class"):
            tckpt.load_checkpoint(other, device="cpu")


class TestData:
    @pytest.fixture(scope="class")
    def imagenet(self, tmp_path_factory):
        return write_imagenet_fixture(tmp_path_factory.mktemp("imagenet"), 60, n_classes=6,
                                      pca_n_classes=4)

    def test_imagenet_split_and_pca_labels(self, imagenet, monkeypatch):
        """(h) The flat-folder ImageNet's seeded 80/20 split,
        ``train_fraction`` and PCA labels (csv reader vs pandas): the
        same samples in the same order."""
        for split, frac in (("train", 1.0), ("test", 1.0), ("train", 0.5), ("all", 1.0)):
            kw = dict(split=split, train_fraction=frac, label_file=imagenet["label_file"])
            t = tobj.ImageNetDataset(imagenet["dataset_path"], **kw)
            j = jobj.ImageNetDataset(imagenet["dataset_path"], **kw)
            assert t.samples == j.samples and len(t.samples) > 0
        csv_path = os.path.join(imagenet["pca_labels_folder"], "n_classes_4.csv")
        tp = tobj.PCADataset(t, csv_path, 4)
        jp = jobj.PCADataset(j, csv_path, 4)
        assert tp.samples == jp.samples and len(tp.samples) == 60
        assert {s[1] for s in tp.samples} == {0, 1, 2, 3}

        cfg = {"dataset": "imagenet", "pca_labels": True, "pca_n_classes": 4, "batchsize": 16,
               "num_workers": 2, "seed": 3, "data_augment": False, **imagenet}
        tds, tl = tobj.get_obj_cls_loader(Config(cfg))
        jds, jl = jobj.get_obj_cls_loader(JaxConfig(cfg))
        assert list(tds) == list(jds) == ["train", "test"]
        for split in tds:
            assert tds[split].samples == jds[split].samples
            (tx, ty), (jx, jy) = next(iter(tl[split])), next(iter(jl[split]))
            np.testing.assert_array_equal(tx, jx)
            assert list(ty) == list(jy)

    @pytest.mark.parametrize("body,match", [
        ("img,pca_label\na.JPEG,1\n", "must include 'image'"),
        ("image,pca_label\na.JPEG,-1\n", "non-negative integers"),
        ("image,pca_label\na.JPEG,1.5\n", "non-negative integers"),
    ])
    def test_pca_csv_checks(self, tmp_path, body, match):
        path = tmp_path / "n_classes_2.csv"
        path.write_text(body)
        base = tobj.ImageNetDataset.__new__(tobj.ImageNetDataset)
        base.samples, base.transform = [], None
        jbase = jobj.ImageNetDataset.__new__(jobj.ImageNetDataset)
        jbase.samples, jbase.transform = [], None
        for cls, ds in ((tobj.PCADataset, base), (jobj.PCADataset, jbase)):
            with pytest.raises(ValueError, match=match):
                cls(ds, str(path), 2)

    def test_shuffled_loader_order(self):
        """(h) Shuffled passes take RandomState(seed + pass) orders, as
        the JAX loader does: the same batches over three passes."""
        class Items:
            def __len__(self):
                return 11

            def __getitem__(self, i):
                return np.full((2, 2, 3), i, np.float32), int(i)

        t = PrefetchLoader(Items(), batch_size=4, num_workers=2, shuffle=True, seed=5)
        j = jloader.PrefetchLoader(Items(), batch_size=4, num_workers=2, shuffle=True, seed=5)
        assert len(t) == len(j) == 3
        for _ in range(3):
            tb, jb = list(t), list(j)
            assert [m for _, m in tb] == [list(m) for _, m in jb]
            assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(tb, jb))
        assert [m for _, m in t][0] != [m for _, m in PrefetchLoader(
            Items(), batch_size=4, shuffle=True, seed=5)][0]

    @pytest.mark.parametrize("stats,size", [("imgnet", 224), ("tiny-imagenet", 64)])
    def test_host_augmentation_with_one_seeded_rng(self, imagenet, stats, size):
        """(h) Flip + rotate with a ``random.Random`` passed to both
        packages' transforms: bit-identical arrays."""
        folder = Path(imagenet["dataset_path"]) / "n00000001"
        paths = sorted(str(p) for p in folder.iterdir())[:6]
        t = get_transform(stats, data_augment=True, rng=random.Random(11))
        j = jax_transform(stats, data_augment=True, rng=random.Random(11))
        plain = get_transform(stats)
        outs = [t(p) for p in paths]
        for p, out in zip(paths, outs):
            np.testing.assert_array_equal(out, j(p))
            assert out.shape == (size, size, 3) and out.dtype == np.float32
        assert any(not np.array_equal(o, plain(p)) for p, o in zip(paths, outs))


class TestDeviceAugment:
    def test_matches_jax_given_its_draws(self):
        """(i) The flips and angles JAX's ``augment_batch`` draws from its
        key, applied by the port to NHWC and NCHW batches: the same
        pixels (nearest-neighbour, so exact)."""
        key = jax.random.PRNGKey(3)
        images = np.random.RandomState(8).randn(6, 20, 24, 3).astype(np.float32)
        ref = np.asarray(jax_augment_batch(key, jnp.asarray(images)))
        k_flip, k_rot = jax.random.split(key)
        flip = torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5, (6,))))
        angles = torch.from_numpy(np.array(
            jax.random.uniform(k_rot, (6,), minval=-10.0, maxval=10.0)))
        assert 0 < int(flip.sum()) < 6
        got = apply_augment(torch.from_numpy(images), flip, angles, channels_last=True)
        np.testing.assert_array_equal(got.numpy(), ref)
        nchw = apply_augment(torch.from_numpy(images).permute(0, 3, 1, 2), flip, angles)
        np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), ref)

    def test_draws_are_seeded(self):
        a = augment_params(torch.Generator().manual_seed(4), 1000)
        b = augment_params(torch.Generator().manual_seed(4), 1000)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        flip, angles = a
        assert 0.45 < float(flip.float().mean()) < 0.55
        assert -10 <= float(angles.min()) < -9 and 9 < float(angles.max()) <= 10


class TestCLI:
    def test_train_cli_writes_checkpoints(self, tiny_imagenet, tmp_path):
        """(k) ``python -m visreps_tpu_torch.run --mode train --device
        cpu`` writes checkpoint_epoch_{0,1}.pth, config.json and the
        metrics CSV in the JAX package's layout."""
        ckpt_dir = tmp_path / "ck"
        overrides = ["dataset=tiny-imagenet", f"dataset_path={tiny_imagenet}",
                     "model_name=TinyCustomCNN", "num_epochs=1", "warmup_epochs=0",
                     "batchsize=8", "num_workers=2", "log_interval=1", "checkpoint_interval=1",
                     "log_checkpoints=true", f"checkpoint_dir={ckpt_dir}", "data_augment=false"]
        proc = subprocess.run(
            [sys.executable, "-m", "visreps_tpu_torch.run", "--mode", "train", "--device", "cpu",
             "--override", *overrides], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        run_dir = ckpt_dir / "cfg200a"
        assert sorted(p.name for p in run_dir.iterdir()) == [
            "checkpoint_epoch_0.pth", "checkpoint_epoch_1.pth", "config.json",
            "training_metrics.csv"]
        meta = json.loads((run_dir / "config.json").read_text())
        assert meta["model_name"] == "TinyCustomCNN" and meta["total_params"] > 1e6
        assert meta["trainable_params"] == meta["total_params"]
        rows = (run_dir / "training_metrics.csv").read_text().splitlines()
        assert rows[0] == "epoch,train_loss,train_acc,train_top5,test_acc,test_top5,learning_rate"
        assert len(rows) == 2 and rows[1].startswith("1,")

    def test_validation_and_out_of_slice_options(self, tiny_imagenet, tmp_path):
        from visreps_tpu_torch import run as trun
        from visreps_tpu_torch.core.config import load_config

        def cfg(*overrides):
            return load_config(REPO / "configs/train/base.json", [*overrides, "mode=train"])

        ok = trun.validate_config(cfg("pca_labels=true", "pca_n_classes=32"))
        assert ok.model_name == "CustomCNN" and "standard_model" not in ok
        for bad in (["dataset=cifar"], ["pca_labels=true", "pca_n_classes=12"],
                    ["pca_labels=true", "pca_n_classes=1"], ["arch.conv_trainable=\"1012\""],
                    ["model_class=other"]):
            with pytest.raises(ValueError):
                trun.validate_config(cfg(*bad))
        with pytest.raises(ValueError, match="Checkpoint not found"):
            trun.validate_config(load_config(REPO / "configs/eval/base.json", [
                "mode=eval", f"checkpoint_dir={tmp_path}", "load_model_from=checkpoint"]))
        base = _train_cfg(Config, tiny_imagenet)
        # Resume acts under log_checkpoints only, as in the JAX package;
        # bf16 compute is an option of the step; other dtypes are refused.
        resumed = ttrainer.Trainer(base.merge({"resume_from_epoch": 2}), device="cpu")
        assert (resumed.start_epoch, resumed.global_step) == (1, 0)
        bf16 = ttrainer.Trainer(base.merge({"train_compute_dtype": "bf16"}), device="cpu")
        assert bf16.compute_dtype == torch.bfloat16 and resumed.compute_dtype == torch.float32
        with pytest.raises(ValueError, match="train_compute_dtype"):
            ttrainer.Trainer(base.merge({"train_compute_dtype": "fp16"}), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                ttrainer.Trainer(base)
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                trun.main(["--mode", "train", "--override", "dataset=tiny-imagenet",
                           f"dataset_path={tiny_imagenet}", "model_name=TinyCustomCNN"])
