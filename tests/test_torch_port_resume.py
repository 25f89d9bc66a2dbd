"""Mid-training resume, the training CLI for the standard families and
wandb logging in the PyTorch port, against the JAX package on the CPU:

  * the port resumes from the JAX package's own epoch-1 files
    (``checkpoint_epoch_1.pth`` and the optax pickle
    ``resume_epoch_1.pkl``) and runs epoch 2 as a JAX resume from the same
    files does;
  * each optax state the JAX package pickles (SGD's trace, Adam's and
    AdamW's moments, frozen layers' ``multi_transform`` partition) maps
    onto ``torch.optim`` state, and the next update equals optax's;
  * the port's own resume files restore its optimizer exactly and never
    make the JAX package fail;
  * ``python -m visreps_tpu_torch.run --mode train`` with
    ``model_class=standard_model``, IMAGENET1K weights, bf16 compute,
    resume state and wandb (a stub module: neither machine has wandb);
  * ``MetricsLogger``'s wandb calls equal the JAX package's.

Each test states its tolerance.
"""
import pickle
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from visreps_tpu.core.config import Config as JaxConfig
from visreps_tpu.core.logging import MetricsLogger as JaxMetricsLogger
from visreps_tpu.models.zoo import init_model as jax_init_model
from visreps_tpu.train import checkpoint as jckpt
from visreps_tpu.train.optim import setup_optimizer
from visreps_tpu.train.trainer import Trainer as JaxTrainer

from visreps_tpu_torch import run as trun
from visreps_tpu_torch.benchmarks.weights import write_torchvision_weights
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.logging import MetricsLogger
from visreps_tpu_torch.models.convert import params_from_jax, params_to_jax
from visreps_tpu_torch.models.custom_cnn import TinyCustomCNN
from visreps_tpu_torch.train import checkpoint as tckpt
from visreps_tpu_torch.train import trainer as ttrainer
from visreps_tpu_torch.train.optim import Optimizer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: under a parallel test run every
    worker's default of one thread per core oversubscribes the machine and
    each op waits on descheduled threads (the CLI test took 3.5 s alone
    and 111 s in a 6-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_imagenet(tmp_path_factory):
    """Tiny-ImageNet layout: 3 classes × 8 noisy class-coloured 64 px JPEGs
    in train/ and 3 × 2 in val/ (3 steps of 8 per epoch)."""
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


def _cfg(cls, path, checkpoint_dir, **kw):
    base = {"mode": "train", "seed": 1, "dataset": "tiny-imagenet", "dataset_path": path,
            "data_augment": False, "optimizer": "sgd", "learning_rate": 1e-3,
            "weight_decay": 1e-3, "grad_clip": 1.0, "lr_scheduler": "cosineannealinglr",
            "num_epochs": 2, "warmup_epochs": 0, "log_interval": 10, "checkpoint_interval": 1,
            "batchsize": 8, "num_workers": 2, "log_checkpoints": True,
            "checkpoint_dir": str(checkpoint_dir), "save_resume_state": True,
            "use_wandb": False, "pca_labels": False, "pca_n_classes": 2,
            "model_class": "standard_model", "model_name": "ResNet18",
            "pretrained_dataset": "none"}
    base.update(kw)
    return cls(base)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    out = {}
    for k, v in (tree or {}).items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _strip_masked(tree: dict) -> dict:
    """An optax moment tree as numpy, without its MaskedNode leaves (and
    the subtrees they empty)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _strip_masked(v)
            if v:
                out[k] = v
        elif type(v).__name__ != "MaskedNode":
            out[k] = np.asarray(v)
    return out


def _record_jax_losses(trainer) -> list:
    losses, step = [], trainer.train_step

    def record(*args):
        out = step(*args)
        losses.append(float(out[3]))
        return out

    trainer.train_step = record
    return losses


def test_port_resumes_jax_files_like_jax(tiny_imagenet, tmp_path, monkeypatch):
    """ResNet18 (3 classes, 64 px), SGD with momentum: the JAX Trainer
    trains 2 epochs and saves its resume state. From copies of its epoch-1
    files a JAX Trainer and the port's Trainer each resume
    (``resume_from_epoch=1``): the port's momentum buffers equal the
    pickled traces exactly, both start at step 3 of epoch 2, the 3 epoch-2
    losses agree within rtol 1e-4 (as the trainer test holds 3 steps),
    and epoch 2's weight updates within 1e-3 of their norm
    (‖Δport − Δjax‖ / ‖Δjax‖ over all parameters: f32 rounding grows
    through BatchNorm over the steps). Learning rate 1e-3: at 1e-2 the
    two packages' third losses part by 1.7e-4 from f32 rounding alone."""
    monkeypatch.setenv("VISREPS_INIT_CACHE", "0")
    first = tmp_path / "first"
    JaxTrainer(_cfg(JaxConfig, tiny_imagenet, first)).train()
    run_dir = first / "cfg200a"
    assert {"resume_epoch_1.pkl", "checkpoint_epoch_1.pth"} <= {p.name for p in run_dir.iterdir()}
    for name in ("jax", "port"):
        shutil.copytree(first, tmp_path / name)

    jtr = JaxTrainer(_cfg(JaxConfig, tiny_imagenet, tmp_path / "jax", resume_from_epoch=1))
    jlosses = _record_jax_losses(jtr)
    jtr.train()

    ttr = ttrainer.Trainer(_cfg(Config, tiny_imagenet, tmp_path / "port", resume_from_epoch=1),
                           device="cpu")
    assert (ttr.start_epoch, ttr.global_step) == (jtr.start_epoch, 3) == (2, 3)
    with open(run_dir / "resume_epoch_1.pkl", "rb") as f:
        traces = tckpt.named_state_from_optax(tckpt._OptaxUnpickler(f).load(), "sgd")
    state = ttr.optimizer.named_state()
    assert set(state) == set(traces) == {n for n, _ in ttr.model.named_parameters()}
    for name, entry in state.items():
        assert torch.equal(entry["momentum_buffer"], traces[name]["momentum_buffer"]), name
    ttr.train()
    tlosses = [h["loss"] for h in ttr.history]
    assert len(tlosses) == len(jlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    start, _ = jckpt.load_checkpoint(run_dir / "checkpoint_epoch_1.pth")
    ref, _ = jckpt.load_checkpoint(tmp_path / "jax" / "cfg200a" / "checkpoint_epoch_2.pth")
    got, _ = tckpt.load_checkpoint(tmp_path / "port" / "cfg200a" / "checkpoint_epoch_2.pth",
                                   device="cpu")
    start, ref = _flat(_np_tree(start.params)), _flat(_np_tree(ref.params))
    got = _flat(params_to_jax(got.state_dict())[0])
    gap = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in ref)
    moved = sum(float(((ref[k] - start[k]) ** 2).sum()) for k in ref)
    assert (gap / moved) ** 0.5 <= 1e-3


@pytest.mark.parametrize("optimizer,conv_trainable", [
    ("sgd", "11111"), ("adamw", "11111"), ("adamw", "01111"), ("adam", "00111")])
def test_optax_state_maps_onto_torch_optim(tmp_path, optimizer, conv_trainable):
    """TinyCustomCNN (frozen conv layers where ``conv_trainable`` has a 0:
    optax's ``multi_transform`` partition with ``MaskedNode`` leaves), one
    optax update on synthetic gradients, its state pickled by the JAX
    package's ``save_checkpoint`` and read back by the port's
    ``load_resume_state``: every moment equal to optax's after the layout
    change (exactly), Adam's ``step`` its ``count``, no state for frozen
    layers; then one more update in both from the same gradients:
    parameters within 1e-6 + 1e-5 relative (the chain test's tolerance)."""
    cfg = {"optimizer": optimizer, "learning_rate": 1e-2, "weight_decay": 0.05,
           "grad_clip": 1.0, "num_epochs": 4, "warmup_epochs": 1}
    arch = {"conv_trainable": conv_trainable, "dropout": 0.0}
    state = jax_init_model("TinyCustomCNN", 6, seed=0, cfg={"arch": arch}, cache=False)
    params = _np_tree(state.params)
    mask = state.module.trainable_mask()
    tx, _ = setup_optimizer(params, JaxConfig(cfg), steps_per_epoch=2, trainable_mask=mask)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(3)
    grads = [jax.tree_util.tree_map(lambda p: (0.05 * rng.randn(*p.shape)).astype(np.float32),
                                    params) for _ in range(2)]
    upd, opt_state = update(grads[0], tx.init(params), params)
    params = _np_tree(jax.tree_util.tree_map(lambda p, u: p + u, params, upd))
    state.params = params
    jckpt.save_checkpoint(str(tmp_path), 1, state, {}, {}, opt_state=opt_state)

    model = TinyCustomCNN(num_classes=6, conv_trainable=conv_trainable, dropout=0.0)
    model.load_state_dict(params_from_jax(params, _np_tree(state.batch_stats)))
    opt = Optimizer(model, Config(cfg), 2, model.trainable_mask())
    loaded = tckpt.load_resume_state(str(tmp_path), 1, optimizer)
    opt.load_named_state(loaded)
    trainable = {n for n, _ in model.named_parameters() if mask.get(n.split(".")[0], True)}
    assert set(opt.named_state()) == trainable
    frozen = "0" in conv_trainable
    assert (len(trainable) < len(list(model.parameters()))) == frozen
    with open(tmp_path / "resume_epoch_1.pkl", "rb") as f:
        raw = f.read()
    assert (b"PartitionState" in raw) == frozen and (b"MaskedNode" in raw) == frozen
    cls = "TraceState" if optimizer == "sgd" else "ScaleByAdamState"
    (found,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: type(x).__name__ == cls) if type(s).__name__ == cls]
    if optimizer == "sgd":
        ref = {n: {"momentum_buffer": t}
               for n, t in params_from_jax(_strip_masked(found.trace)).items()}
    else:
        mu, nu = (params_from_jax(_strip_masked(t)) for t in (found.mu, found.nu))
        assert int(found.count) == 1
        ref = {n: {"step": torch.tensor(1.0), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
               for n in mu}
    assert set(ref) == trainable
    for n, entry in opt.named_state().items():
        assert set(entry) == set(ref[n])
        for k, v in ref[n].items():
            assert torch.equal(entry[k], v), (n, k)

    upd, _ = update(grads[1], opt_state, params)
    jparams = _flat(jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, upd))
    torch_grads = params_from_jax(grads[1])
    for n, p in model.named_parameters():
        p.grad = torch_grads[n].clone()
    opt.step(1)
    got = _flat(params_to_jax(model.state_dict())[0])
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_port_resume_files(tiny_imagenet, tmp_path, monkeypatch):
    """The port's Trainer (ResNet18, SGD) writes ``resume_epoch_{1,2}.pt``
    beside its checkpoints and no ``.pkl``: the JAX package's
    ``load_resume_state`` finds nothing there, and its Trainer resumes
    epoch 2 from the port's checkpoint with a fresh optimizer. The port
    resumes from its own file with exactly the saved state (step 3,
    epoch 2), and refuses a file of another optimizer."""
    monkeypatch.setenv("VISREPS_INIT_CACHE", "0")
    ttrainer.Trainer(_cfg(Config, tiny_imagenet, tmp_path), device="cpu").train()
    run_dir = tmp_path / "cfg200a"
    names = {p.name for p in run_dir.iterdir()}
    assert {"resume_epoch_1.pt", "resume_epoch_2.pt"} <= names
    assert not any(n.endswith(".pkl") for n in names)
    assert jckpt.load_resume_state(str(run_dir), 1) is None
    jtr = JaxTrainer(_cfg(JaxConfig, tiny_imagenet, tmp_path, resume_from_epoch=1))
    jlosses = _record_jax_losses(jtr)
    jtr.train()
    assert len(jlosses) == 3 and all(np.isfinite(jlosses))

    saved = torch.load(run_dir / "resume_epoch_1.pt", weights_only=True)
    assert saved["optimizer"] == "sgd"
    resumed = ttrainer.Trainer(_cfg(Config, tiny_imagenet, tmp_path, resume_from_epoch=1),
                               device="cpu")
    assert (resumed.start_epoch, resumed.global_step) == (2, 3)
    state = resumed.optimizer.named_state()
    assert set(state) == set(saved["state"])
    for n, entry in state.items():
        assert torch.equal(entry["momentum_buffer"], saved["state"][n]["momentum_buffer"]), n
    with pytest.raises(ValueError, match="holds sgd state"):
        ttrainer.Trainer(_cfg(Config, tiny_imagenet, tmp_path, resume_from_epoch=1,
                              optimizer="adamw"), device="cpu")


class WandbStub(types.ModuleType):
    """A ``wandb`` module that records ``init`` / ``log`` / ``finish``."""

    def __init__(self, fail: bool = False):
        super().__init__("wandb")
        self.calls, self.fail = [], fail

    def init(self, **kwargs):
        if self.fail:
            raise RuntimeError("offline")
        self.calls.append(("init", kwargs))

    def log(self, data):
        self.calls.append(("log", data))

    def finish(self):
        self.calls.append(("finish",))


@pytest.mark.parametrize("pca_labels", [False, True])
def test_wandb_calls_equal_jax(monkeypatch, capsys, pca_labels):
    """The same config and metrics through both packages' MetricsLogger
    with a stub wandb: the same init arguments, logged keys and values,
    and finish; an init that raises warns and turns wandb off in both."""
    cfg = {"dataset": "imagenet", "seed": 2, "model_name": "ResNet50",
           "model_class": "standard_model", "use_wandb": True, "pca_labels": pca_labels,
           "num_epochs": 3}
    metrics = {"epoch": 1, "epoch_metrics": {"learning_rate": 0.1}, "test_acc": 12.5,
               "test_top5": 40.0, "train_acc": 20.0, "train_top5": 50.0}
    calls = []
    for cls, config in ((JaxMetricsLogger, JaxConfig), (MetricsLogger, Config)):
        stub = WandbStub()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        logger = cls(config(cfg))
        logger.log_metrics(1, 2.5, metrics)
        logger.finish()
        calls.append(stub.calls)
    assert calls[0] == calls[1]
    assert [c[0] for c in calls[1]] == ["init", "log", "finish"]
    assert calls[1][0][1]["name"] == "ResNet50_standard_model"
    assert ("training/test-top5" in calls[1][1][1]) == (not pca_labels)
    for cls, config in ((JaxMetricsLogger, JaxConfig), (MetricsLogger, Config)):
        monkeypatch.setitem(sys.modules, "wandb", WandbStub(fail=True))
        logger = cls(config(cfg))
        assert not logger.use_wandb
        logger.log_metrics(1, 2.5, metrics)
        logger.finish()
    assert capsys.readouterr().out.count("W&B initialization failed: offline") == 2


def test_train_cli_standard_model(tiny_imagenet, tmp_path, monkeypatch, capsys):
    """``python -m visreps_tpu_torch.run --mode train --device cpu`` (in
    process) with ``model_class=standard_model model_name=ResNet18
    pretrained_dataset=imagenet1k`` from a seeded torchvision-layout file,
    ``train_compute_dtype=bf16``, ``save_resume_state`` and ``use_wandb``
    (stub): the import is reported and the epoch-0 checkpoint holds the
    file's stem convolution exactly; 2 epochs of finite losses; the
    checkpoints, resume files and metrics CSV; wandb init, one log per
    epoch and finish. Then ``resume_from_epoch=1``: 3 steps of epoch 2
    only, and wandb finished again."""
    path = write_torchvision_weights(tmp_path / "weights", "ResNet18", seed=2)
    monkeypatch.setenv("TORCH_WEIGHTS_DIR", str(path.parent))
    stub = WandbStub()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    ckpt_dir = tmp_path / "ck"
    overrides = ["model_class=standard_model", "model_name=ResNet18",
                 "pretrained_dataset=imagenet1k", "dataset=tiny-imagenet",
                 f"dataset_path={tiny_imagenet}", "num_epochs=2", "warmup_epochs=0",
                 "batchsize=8", "num_workers=2", "log_interval=1", "checkpoint_interval=1",
                 "log_checkpoints=true", f"checkpoint_dir={ckpt_dir}", "data_augment=false",
                 "train_compute_dtype=bf16", "save_resume_state=true", "use_wandb=true"]
    trainer = trun.main(["--mode", "train", "--device", "cpu", "--override", *overrides])
    assert "Imported torchvision weights" in capsys.readouterr().out
    assert trainer.compute_dtype == torch.bfloat16 and len(trainer.history) == 6
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in trainer.history)
    run_dir = ckpt_dir / "cfg200a"
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "checkpoint_epoch_0.pth", "checkpoint_epoch_1.pth", "checkpoint_epoch_2.pth",
        "config.json", "resume_epoch_1.pt", "resume_epoch_2.pt", "training_metrics.csv"]
    with open(run_dir / "checkpoint_epoch_0.pth", "rb") as f:
        epoch0 = pickle.load(f)
    stem = torch.load(path, weights_only=True)["conv1.weight"].numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(epoch0["params"]["conv1"]["kernel"], stem)
    assert [c[0] for c in stub.calls] == ["init", "log", "log", "finish"]

    stub.calls.clear()
    resumed = trun.main(["--mode", "train", "--device", "cpu", "--override", *overrides,
                         "resume_from_epoch=1"])
    assert [h["step"] for h in resumed.history] == [4, 5, 6]
    assert [c[0] for c in stub.calls] == ["init", "log", "finish"]
    assert (run_dir / "checkpoint_epoch_2.pth").is_file()
