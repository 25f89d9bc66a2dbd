"""Training every model family in the PyTorch port against the JAX
package, on the CPU: one train step of VGG16, ResNet18, ResNet50, ViT-B
and ECTiedNet in float32 and in bfloat16 (``train_compute_dtype=bf16``)
from the same weights and batch, the trained checkpoints read back by the
JAX package, the optimizer chain over each family's parameters, and
dropout. (IMAGENET1K fine-tuning through the CLI: ``test_torch_port_resume.py``.)

Small instances through the constructor fields both packages share
(ResNet50 with one Bottleneck per stage, a 2-layer ViT of width 64,
ECTiedNet with 16 channels) and the smallest inputs (VGG16 at 32 px);
seeded numpy weights in the Flax layout (``test_torch_port_models.
random_variables``) carried across with ``models/convert.params_from_jax``.
Dropout is 0 in the step comparisons (the packages draw masks from
different generators; ``TestDropout`` holds the masks on their own). The
steps are SGD so an update is −lr · g: Adam's first update ≈ lr · sign(g)
would turn rounding of near-zero gradients into ±lr steps.
``TestOptimizerOverFamilies`` holds the AdamW and Adam chains. Each test
states its tolerance.

This file keeps torch's default thread count (no one-thread fixture):
ResNet50's f32 step parts from the JAX step by 1.7e-5 in its gradient
norm on one thread and agrees to 3e-7 on two or more. The cause is one
ReLU kink, not an op: ``TestThreadCount`` shows it.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visreps_tpu.core.config import Config as JaxConfig
from visreps_tpu.models import ecnet as jecnet
from visreps_tpu.models import resnet as jresnet
from visreps_tpu.models import standard as jstandard
from visreps_tpu.models import vit as jvit
from visreps_tpu.train import checkpoint as jckpt
from visreps_tpu.train.optim import _decay_mask, setup_optimizer
from visreps_tpu.train.trainer import make_train_step

from test_torch_port_models import random_variables
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.models.convert import params_from_jax, params_to_jax
from visreps_tpu_torch.models.ecnet import ECTiedNet
from visreps_tpu_torch.models.layers import dropout
from visreps_tpu_torch.models.resnet import Bottleneck, ResNet, ResNet18
from visreps_tpu_torch.models.standard import VGG16
from visreps_tpu_torch.models.vit import ViTBase
from visreps_tpu_torch.train import checkpoint as tckpt
from visreps_tpu_torch.train.optim import Optimizer
from visreps_tpu_torch.train.trainer import train_step

VIT_SMALL = dict(num_layers=2, hidden_dim=64, num_heads=4, mlp_dim=128)
N_CLASSES, BATCH = 10, 4
SGD = {"optimizer": "sgd", "learning_rate": 0.1, "num_epochs": 2, "warmup_epochs": 0,
       "grad_clip": 0}

# name → (JAX module, port module, input size), dropout 0.
FAMILIES = {
    "VGG16": (lambda: jstandard.VGG16(num_classes=N_CLASSES, dropout=0.0),
              lambda: VGG16(num_classes=N_CLASSES, dropout=0.0), 32),
    "ResNet18": (lambda: jresnet.ResNet18(N_CLASSES), lambda: ResNet18(N_CLASSES), 64),
    "ResNet50_small": (lambda: jresnet.ResNet((1, 1, 1, 1), jresnet.Bottleneck, N_CLASSES),
                       lambda: ResNet((1, 1, 1, 1), Bottleneck, N_CLASSES), 64),
    "ViTBase_small": (lambda: jvit.ViTBase(num_classes=N_CLASSES, **VIT_SMALL),
                      lambda: ViTBase(num_classes=N_CLASSES, **VIT_SMALL), 224),
    "ECTiedNet": (lambda: jecnet.ECTiedNet(num_classes=N_CLASSES, channels=16, dropout=0.0),
                  lambda: ECTiedNet(num_classes=N_CLASSES, channels=16, dropout=0.0), 64),
}
# Per-tensor tolerance on the f32 updates, as a fraction of the tensor's
# largest |update|: f32 summation order (XLA vs PyTorch convolutions and
# reductions) compounds with depth, up to 2.1e-4 observed in VGG16's
# 16 layers; 1e-4 elsewhere, as the CustomCNN step test has it.
UPDATE_RTOL = {"VGG16": 1e-3}


def blur_pool_in_input_dtype(x, stride: int = 2):
    """``visreps_tpu.models.ecnet.blur_pool`` with its kernel in x's dtype.
    The JAX package's own builds the kernel in f32, and
    ``lax.conv_general_dilated`` refuses a bf16 input beside it, so its
    bf16 ECTiedNet step raises; the binomial taps (1, 2, 4)/16 are exact
    in bf16, as in the port's blur."""
    c = x.shape[-1]
    k1 = jnp.array([1.0, 2.0, 1.0], x.dtype)
    k2 = jnp.outer(k1, k1) / 16.0
    return jax.lax.conv_general_dilated(
        x, jnp.tile(k2[:, :, None, None], (1, 1, 1, c)), (stride, stride), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=c)


# The families whose bf16 step is held against the JAX package's here:
# BatchNorm (ResNet), attention and LayerNorm (ViT), GroupNorm, the blur
# and divisive normalisation (ECTiedNet). VGG16's and ResNet18's plain
# convolutions and dense layers in bf16 run on the card (chip_smoke.py).
BF16_FAMILIES = ("ResNet50_small", "ViTBase_small", "ECTiedNet")


@functools.lru_cache(maxsize=None)
def _variables(name: str):
    """The family's JAX module and seeded (params, batch_stats), drawn once."""
    jmod_fn, _, size = FAMILIES[name]
    jmod = jmod_fn()
    return (jmod, *random_variables(jmod, size))


def _flat(tree, prefix=()):
    out = {}
    for k, v in (tree or {}).items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _jax_step(jmod, params, stats, x, y, compute_dtype):
    tx, _ = setup_optimizer(params, JaxConfig(SGD), steps_per_epoch=5)
    step = make_train_step(jmod, tx, compute_dtype=compute_dtype)
    tree = jax.tree_util.tree_map(jnp.asarray, (params, stats))
    p, s, _, loss, gn = step(*tree, tx.init(params), jnp.asarray(x), jnp.asarray(y),
                             jax.random.PRNGKey(0))
    return {"loss": float(loss), "grad_norm": float(gn), "params": _flat(p), "stats": _flat(s)}


def _port_step(tmod_fn, params, stats, x, y, compute_dtype):
    model = tmod_fn()
    model.load_state_dict(params_from_jax(params, stats))
    opt = Optimizer(model, Config(SGD), 5)
    loss, gn = train_step(model, opt, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                          torch.from_numpy(y), None, 0, compute_dtype)
    p, s = params_to_jax(model.state_dict(), getattr(model, "num_heads", None))
    return {"loss": float(loss), "grad_norm": float(gn), "params": _flat(p), "stats": _flat(s),
            "model": model, "optimizer": opt}


@functools.lru_cache(maxsize=None)
def _steps(name: str) -> dict:
    """One SGD step of the family in both packages, f32 (and bf16 for
    ``BF16_FAMILIES``), from the same seeded weights and batch (4 images)."""
    _, tmod_fn, size = FAMILIES[name]
    jmod, params, stats = _variables(name)
    rng = np.random.RandomState(1)
    x = rng.randn(BATCH, size, size, 3).astype(np.float32)
    y = rng.randint(0, N_CLASSES, BATCH)
    out = {"name": name, "params": _flat(params), "stats": _flat(stats), "jmod": jmod,
           "x": x, "size": size}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jecnet, "blur_pool", blur_pool_in_input_dtype)
        for dt, tdt in ((None, torch.float32), ("bf16", torch.bfloat16)):
            if dt == "bf16" and name not in BF16_FAMILIES:
                continue
            out["jax", dt] = _jax_step(jmod, params, stats, x, y, dt)
            out["port", dt] = _port_step(tmod_fn, params, stats, x, y, tdt)
    return out


def _update_gap(got: dict, ref: dict, start: dict) -> float:
    """‖Δgot − Δref‖ / ‖Δref‖ over every parameter (Δ = after − start)."""
    num = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in start)
    den = sum(float(((ref[k] - start[k]) ** 2).sum()) for k in start)
    return (num / den) ** 0.5


def _stats_gap(got: dict, ref: dict) -> float:
    return max([float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref] or [0.0])


class TestStep:
    @pytest.mark.parametrize("name", list(FAMILIES))
    def test_f32_step_matches_make_train_step(self, name):
        """Loss and gradient norm within rtol 1e-5; every updated
        parameter: |Δport − Δjax| ≤ rtol · max|Δjax| of the tensor (rtol
        1e-4, VGG16 1e-3: see ``UPDATE_RTOL``) + 1e-6 · the largest update
        of the model (ViT's attention key biases have a gradient of 0 up
        to rounding: softmax ignores a shift of every key); ResNet's
        updated BatchNorm running statistics within 1e-4 of each tensor's
        largest value."""
        steps = _steps(name)
        ref, got, start = steps["jax", None], steps["port", None], steps["params"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-5)
        assert set(got["params"]) == set(ref["params"]) == set(start)
        deltas = {k: ref["params"][k] - start[k] for k in start}
        floor = 1e-6 * max(float(np.abs(d).max()) for d in deltas.values())
        rtol = UPDATE_RTOL.get(steps["name"], 1e-4)
        for k, d in deltas.items():
            np.testing.assert_allclose(got["params"][k] - start[k], d, rtol=0,
                                       atol=rtol * np.abs(d).max() + floor, err_msg=k)
        assert set(got["stats"]) == set(ref["stats"])
        assert bool(ref["stats"]) == steps["name"].startswith("ResNet")
        for k, r in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][k], r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                       err_msg=k)

    @pytest.mark.parametrize("name", BF16_FAMILIES)
    def test_bf16_step_tracks_the_jax_bf16_step(self, name):
        """bf16 compute rounds differently in the two packages (the port's
        BatchNorm takes its statistics in f32; XLA and PyTorch order their
        bf16 sums differently), so each package's bf16 step is held
        against the f32 step: the port's loss, gradient norm, update
        (‖Δbf16 − Δf32‖ / ‖Δf32‖ over all parameters) and BatchNorm
        statistics may stray from the f32 step's by at most twice what the
        JAX package's bf16 step strays, plus 1e-3 (a random ResNet's bf16
        gradients at batch 4 stray by ~40 % in both). The two bf16 losses
        also agree within 2e-2. Parameters, running statistics and SGD's
        momentum stay float32. ResNet50, ViT and ECTiedNet (see
        ``BF16_FAMILIES``)."""
        steps = _steps(name)
        f32, jbf, tbf = steps["jax", None], steps["jax", "bf16"], steps["port", "bf16"]
        start = steps["params"]
        for key in ("loss", "grad_norm"):
            allowed = 2 * abs(jbf[key] - f32[key]) + 1e-3 * abs(f32[key])
            assert abs(tbf[key] - f32[key]) <= allowed, (key, tbf[key], jbf[key], f32[key])
        allowed = 2 * _update_gap(jbf["params"], f32["params"], start) + 1e-3
        assert _update_gap(tbf["params"], f32["params"], start) <= allowed
        assert _stats_gap(tbf["stats"], f32["stats"]) <= 2 * _stats_gap(jbf["stats"],
                                                                        f32["stats"]) + 1e-3
        assert tbf["loss"] == pytest.approx(jbf["loss"], rel=2e-2)
        model, opt = tbf["model"], tbf["optimizer"]
        assert {v.dtype for v in model.state_dict().values()} <= {torch.float32, torch.int64}
        assert all(s["momentum_buffer"].dtype == torch.float32 for s in opt.opt.state.values())

    @pytest.mark.parametrize("name", list(FAMILIES))
    def test_trained_checkpoint_loads_in_jax(self, name, tmp_path):
        """The port's model after its f32 step, saved by the port and
        loaded by ``visreps_tpu.train.checkpoint.load_checkpoint``: the
        JAX package's eval-mode logits within 1e-5 of the port's largest."""
        steps = _steps(name)
        model = steps["port", None]["model"].eval()
        path = tckpt.save_checkpoint(str(tmp_path), 1, model, {}, {"seed": 1})
        state, payload = jckpt.load_checkpoint(path)
        assert payload["module_spec"] == model.spec() == jckpt._module_spec(steps["jmod"])
        x = steps["x"]
        with torch.no_grad():
            ref = model(torch.from_numpy(x).permute(0, 3, 1, 2))[0].numpy()
        got = np.asarray(state.apply(jnp.asarray(x))[0])
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _synthetic_grads(tree: dict, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (0.1 * rng.randn(*np.shape(p))).astype(np.float32), tree)


class TestThreadCount:
    def test_resnet50_step_parts_at_one_relu_kink(self):
        """Why the ResNet50 f32 step follows torch's thread count. The
        forward's f32 values part from an f64 forward by roundoff (≈ 1e-6
        of the activations) on any thread count, but oneDNN sums the
        convolutions in another order on one thread than on two or more.
        ``layer2_0``'s residual sum before its ReLU, s[1, 411, 6, 3], is
        2.99e-6 in f64 (the tensor's median |s| is 0.94): on one thread it
        is +1.07e-6 and the ReLU passes its gradient (−4.29e-4, a third
        of the largest there), on two threads −1.49e-7 and the ReLU stops
        it. That one element is the only sign that differs between the
        thread counts, it lies inside the f32 forward's error, and it
        moves the gradient norm by 1.7e-5 relative; the JAX (XLA) step
        lands on the multi-threaded side. So the step is held to the JAX
        package on the default thread count, at unchanged tolerances."""
        name = "ResNet50_small"
        _, params, stats = _variables(name)
        _, tmod_fn, size = FAMILIES[name]
        rng = np.random.RandomState(1)  # the batch of ``_steps``
        x = rng.randn(BATCH, size, size, 3).astype(np.float32)

        def residual_sum(dtype, threads):
            """layer2_0's bn3 output + its downsample branch, before the ReLU."""
            saved = torch.get_num_threads()
            torch.set_num_threads(threads)
            try:
                model = tmod_fn()
                model.load_state_dict(params_from_jax(params, stats))
                model.to(dtype).train()
                out = {}
                block = model.layer2_0
                hooks = [m.register_forward_hook(lambda m, i, o, k=k: out.__setitem__(k, o))
                         for k, m in (("y", block.bn3), ("x", block.downsample_bn))]
                with torch.no_grad():
                    model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype))
                for h in hooks:
                    h.remove()
                return (out["y"] + out["x"]).double()
            finally:
                torch.set_num_threads(saved)

        s64 = residual_sum(torch.float64, 1)
        s1, s2 = residual_sum(torch.float32, 1), residual_sum(torch.float32, 2)
        flips = ((s1 > 0) != (s2 > 0)).nonzero().tolist()
        assert flips == [[1, 411, 6, 3]]
        kink = tuple(flips[0])
        f32_error = max(float((s1 - s64).abs().max()), float((s2 - s64).abs().max()))
        assert float(s64[kink]) == pytest.approx(2.99e-6, rel=1e-2)
        assert abs(float(s64[kink])) < f32_error
        assert float(s64.abs().median()) > 0.5


class TestOptimizerOverFamilies:
    @pytest.mark.parametrize("name", BF16_FAMILIES)
    @pytest.mark.parametrize("optimizer", ["adamw", "adam"])
    def test_chain_matches_setup_optimizer(self, name, optimizer):
        """Two steps of the port's ``Optimizer`` and the optax chain of
        ``setup_optimizer`` (clip 1.0, weight decay 0.05, no trainable
        mask) on synthetic gradients over the family's parameters: the
        same weight-decay split (ndim > 1 in the Flax layout: not the norm
        scales, the layer scale or most biases, but a ViT's query/key/value
        biases, (heads, head_dim) there, and its (1, 1, H) class token and
        (1, T, H) positions) and every parameter within 1e-6 + 1e-5
        relative, as the CustomCNN chain test holds it."""
        _, params, stats = _variables(name)
        cfg = {"optimizer": optimizer, "learning_rate": 1e-2, "weight_decay": 0.05,
               "grad_clip": 1.0, "num_epochs": 4, "warmup_epochs": 1}
        tx, _ = setup_optimizer(params, JaxConfig(cfg), steps_per_epoch=1)
        model = FAMILIES[name][1]()
        model.load_state_dict(params_from_jax(params, stats))
        opt = Optimizer(model, Config(cfg), 1)
        if optimizer == "adamw":
            leaf = {"kernel": "weight", "scale": "weight"}
            decayed = {".".join([*(k.key for k in path[:-1]),
                                 leaf.get(path[-1].key, path[-1].key)])
                       for path, flag in jax.tree_util.tree_leaves_with_path(_decay_mask(params))
                       if flag}
            by_id = {id(p): n for n, p in model.named_parameters()}
            assert {by_id[id(p)] for p in opt.opt.param_groups[0]["params"]} == decayed
            assert all(p.ndim == 1 for p in opt.opt.param_groups[1]["params"])
        state, jparams, update = tx.init(params), params, jax.jit(tx.update)
        for step in range(2):
            grads = _synthetic_grads(params, seed=step)
            upd, state = update(grads, state, jparams)
            jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
            torch_grads = params_from_jax(grads)
            opt.zero_grad()
            for n, p in model.named_parameters():
                p.grad = torch_grads[n].clone()
            opt.step(step)
        got = _flat(params_to_jax(model.state_dict(), getattr(model, "num_heads", None))[0])
        for k, ref in _flat(jparams).items():
            np.testing.assert_allclose(got[k], ref, rtol=1e-5, atol=1e-6, err_msg=k)


class TestDropout:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_masks_are_seeded_and_scaled(self, dtype):
        """The same generator seed gives the same mask, another seed
        another; 30 % of 200,000 elements dropped (±1 %) and kept ones
        scaled by 1 / 0.7 in the input's dtype (the uniforms are f32)."""
        x = torch.ones(200_000, dtype=dtype)
        a = dropout(x, 0.3, torch.Generator().manual_seed(4))
        b = dropout(x, 0.3, torch.Generator().manual_seed(4))
        c = dropout(x, 0.3, torch.Generator().manual_seed(5))
        assert torch.equal(a, b) and not torch.equal(a, c) and a.dtype == dtype
        assert abs(float((a == 0).float().mean()) - 0.3) < 0.01
        assert set(a.unique().tolist()) == {0.0, float(torch.tensor(1 / 0.7, dtype=dtype))}

    @pytest.mark.parametrize("name", ["VGG16", "ECTiedNet"])
    def test_families_draw_from_the_generator(self, name):
        """VGG16 and ECTiedNet in training mode with their own dropout (0.5,
        0.3): seeded logits, in f32 and through the bf16 step's forward."""
        from visreps_tpu_torch.train.trainer import forward_logits

        size = FAMILIES[name][2]
        model = (VGG16(num_classes=N_CLASSES) if name == "VGG16"
                 else ECTiedNet(num_classes=N_CLASSES, channels=16))
        model.load_state_dict(params_from_jax(*_variables(name)[1:]))
        model.train()
        x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(1))
        for dt in (torch.float32, torch.bfloat16):
            with torch.no_grad():
                a, b, c = (forward_logits(model, x, torch.Generator().manual_seed(s), dt)
                           for s in (7, 7, 8))
            assert torch.equal(a, b) and not torch.equal(a, c)

    def test_vgg16_drops_after_its_relus_as_jax(self):
        """At rate 1 every dropped activation is 0 in both packages: VGG16's
        fc1_pre and fc1_post taps are the undropped ones (JAX's within
        1e-5 of the largest), and fc2_pre is fc2's bias: dropout sits after
        fc1's ReLU, before fc2, in both."""
        jmod = jstandard.VGG16(num_classes=N_CLASSES, dropout=1.0)
        params = _variables("VGG16")[1]
        x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
        points = ("fc1_pre", "fc1_post", "fc2_pre")
        _, jtaps = jmod.apply({"params": params}, jnp.asarray(x), train=True, capture=points,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        model = VGG16(num_classes=N_CLASSES, dropout=1.0)
        model.load_state_dict(params_from_jax(params))
        with torch.no_grad():
            _, taps = model.train()(torch.from_numpy(x).permute(0, 3, 1, 2), capture=points,
                                    generator=torch.Generator().manual_seed(0))
        for p in points:
            ref = np.asarray(jtaps[p])
            np.testing.assert_allclose(taps[p].numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=p)
        assert float(np.abs(np.asarray(jtaps["fc1_post"])).max()) > 0
        np.testing.assert_array_equal(taps["fc2_pre"].numpy(),
                                      np.broadcast_to(params["fc2"]["bias"], (2, 4096)))
