"""The PyTorch port's AlexNet and extractor against the JAX package, on
the CPU, with the JAX weights and projections carried across."""
import numpy as np
import pytest
import torch
from torch import nn

import jax

from visreps_tpu.data.loader import make_stimuli_loader as jax_loader
from visreps_tpu.data.transforms import get_transform as jax_transform
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor
from visreps_tpu.models.standard import ALEXNET_TAPS as JAX_TAPS
from visreps_tpu.models.zoo import init_model as jax_init_model
from visreps_tpu_torch.data.loader import make_stimuli_loader
from visreps_tpu_torch.data.transforms import get_transform
from visreps_tpu_torch.models.convert import params_from_jax, srp_from_jax
from visreps_tpu_torch.models.extractor import FeatureExtractor, expand_return_nodes
from visreps_tpu_torch.models.standard import ALEXNET_TAPS, AlexNet
from visreps_tpu_torch.models.layers import init_like_flax as _init_like_flax
from visreps_tpu_torch.models.zoo import TORCHVISION_RETURN_NODES

POINTS = [p for spec in ALEXNET_TAPS.values() for p in spec]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_state():
    return jax_init_model("AlexNet", 1000, seed=0, cache=False)


@pytest.fixture(scope="module")
def torch_model(jax_state):
    model = AlexNet()
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jax_state.params)))
    return model.eval()


def test_taps_match_jax(jax_state, torch_model):
    x = np.random.RandomState(0).randn(2, 224, 224, 3).astype(np.float32)
    _, jtaps = jax_state.apply(x, capture=tuple(POINTS))
    with torch.no_grad():
        logits, ttaps = torch_model(torch.from_numpy(x).permute(0, 3, 1, 2), capture=POINTS)
    assert len(ttaps) == len(POINTS) == 15  # the 14 taps of the 7 return nodes, and fc3
    for p in POINTS:
        ref = np.asarray(jtaps[p])
        got = ttaps[p]
        if got.dim() == 4:
            got = got.permute(0, 2, 3, 1)  # NCHW → the JAX package's NHWC
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4, err_msg=p)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jtaps["fc3"]), rtol=1e-4, atol=1e-4)


def test_tap_names_match_jax():
    assert ALEXNET_TAPS == JAX_TAPS
    points, alias = expand_return_nodes(ALEXNET_TAPS, TORCHVISION_RETURN_NODES["AlexNet"])
    assert len(points) == 14 and alias == {p: p for p in points}
    points, alias = expand_return_nodes(ALEXNET_TAPS, ["conv1", "fc3"], extract_pre_and_post=False)
    assert points == ["conv1_post", "fc3"] and alias == {"conv1_post": "conv1", "fc3": "fc3"}


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 11)
        self.fc1 = nn.Linear(50, 40)
        self.fc3 = nn.Linear(40, 10)


@torch.no_grad()
def test_init_is_seeded_flax_family():
    a, b, c = _Tiny(), _Tiny(), _Tiny()
    _init_like_flax(a, torch.Generator().manual_seed(3))
    _init_like_flax(b, torch.Generator().manual_seed(3))
    _init_like_flax(c, torch.Generator().manual_seed(4))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    std = (3 * 11 * 11) ** -0.5
    assert float(a.conv1.weight.std()) == pytest.approx(std, rel=0.1)  # lecun normal
    assert float(a.conv1.weight.abs().max()) <= 2 * std / 0.8796 + 1e-6  # truncated at 2σ
    assert float(a.conv1.bias.abs().max()) == 0.0 == float(a.fc3.bias.abs().max())
    assert float(a.fc3.weight.abs().max()) <= (6 / (40 + 10)) ** 0.5  # xavier-uniform head


def test_get_activations_match_jax(jax_state, torch_model):
    rng = np.random.RandomState(1)
    stimuli = {str(i): rng.randint(0, 256, (256, 256, 3), dtype=np.uint8) for i in range(5)}
    nodes = TORCHVISION_RETURN_NODES["AlexNet"]
    jext = JaxExtractor(jax_state, nodes, srp_k=64, batch_size=2)
    ref, ref_ids = jext.get_activations(
        jax_loader(stimuli, jax_transform("imgnet", normalize=False), 2, 2), store="host")

    text = FeatureExtractor(torch_model, nodes, srp_k=64, device="cpu")
    assert text.tap_dims == jext.tap_dims
    srp_from_jax(text.srp, {d: tuple(np.asarray(c, np.float32) for c in jext.srp.matrix_chunks(d))
                            for d in set(jext.tap_dims.values())})
    got, ids = text.get_activations(
        make_stimuli_loader(stimuli, get_transform("imgnet", normalize=False), 2, 2), store="host")
    assert ids == ref_ids and list(got) == list(ref)
    for name in ref:
        a, b = got[name].numpy(), np.asarray(ref[name])
        assert a.shape == b.shape == (5, 64)
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2 * np.abs(b).max(), err_msg=name)


def test_extract_layers_exact_orders_rows(torch_model):
    rng = np.random.RandomState(2)
    stimuli = {str(i): rng.randint(0, 256, (256, 256, 3), dtype=np.uint8) for i in range(4)}
    ext = FeatureExtractor(torch_model, ["conv5", "fc2"], srp_k=64, device="cpu")
    loader = make_stimuli_loader(stimuli, get_transform("imgnet"), 3, 2)
    acts, ids = ext.extract_layers_exact(loader, ["fc2_post", "conv5_pre"], ["3", "0", "9"])
    assert ids == ["3", "0"]
    assert acts["conv5_pre"].shape == (2, 13 * 13 * 256) and acts["fc2_post"].shape == (2, 4096)
    x = np.stack([get_transform("imgnet")(stimuli[k]) for k in ids])
    with torch.no_grad():
        _, taps = torch_model(torch.from_numpy(x).permute(0, 3, 1, 2), capture=["conv5_pre"])
    ref = taps["conv5_pre"].permute(0, 2, 3, 1).reshape(2, -1)
    torch.testing.assert_close(acts["conv5_pre"], ref, rtol=1e-5, atol=1e-5)
