"""The PyTorch port's per-pair bootstrap and PCA routes on an NVIDIA GPU:
tensors on the card are scored and reconstructed there, and agree with
the same call on the CPU.

Marked ``cuda``; each test skips without a CUDA device. The module
imports no JAX, so it also runs on a machine without it (the test
configuration in ``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: reconstructions 1e-5 of the largest magnitude, covariance
eigenvalues 1e-5, bootstrap scores 1e-6 (f32 scores of the same counts).
"""
import numpy as np
import pytest
import torch

from visreps_tpu_torch.ops import bootstrap as tboot
from visreps_tpu_torch.ops import pca as tpca
from visreps_tpu_torch.ops.rdm import compute_rdm

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(seed, n, d):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0)


def test_reconstruction_stays_on_the_card(cuda):
    x = _rows(0, 40, 300)
    got = tpca.reconstruct_from_pcs({"a": torch.from_numpy(x).to(cuda)}, 2)["a"]
    ref = tpca.reconstruct_from_pcs({"a": x}, 2, device="cpu")["a"]
    assert got.device.type == "cuda"
    _close(got.cpu().numpy(), ref, 1e-5)


def test_covariance_stays_on_the_card(cuda):
    x = _rows(1, 90, 24)
    vecs, vals, mean, total = tpca.fit_pca_covariance(
        (torch.from_numpy(x[i:i + 30]).to(cuda) for i in range(0, 90, 30)), 24, 4)
    assert {t.device.type for t in (vecs, vals, mean, total)} == {"cuda"}
    _close(vals.cpu().numpy(), tpca.fit_pca_covariance([x], 24, 4, device="cpu")[1].numpy(), 1e-5)


@pytest.mark.parametrize("method", ["spearman", "kendall", "pearson"])
def test_bootstrap_runs_on_the_card(cuda, method, monkeypatch):
    seen = []
    for name in ("spearman_fast_scores", "bootstrap_kendall_fast", "gathered_scores",
                 "grouped_core"):
        fn = getattr(tboot, name)
        monkeypatch.setattr(tboot, name,
                            lambda a, *rest, fn=fn, **kw: seen.append(a.device.type) or
                            fn(a, *rest, **kw))
    a, b = (compute_rdm(torch.from_numpy(_rows(s, 30, 8)).to(cuda)) for s in (2, 3))
    idx = tboot.bootstrap_indices(30, 16, seed=42)
    got = tboot.bootstrap_rdm_correlation(a, b, method=method, indices=idx)
    ref = tboot.bootstrap_rdm_correlation(a.cpu(), b.cpu(), method=method, indices=idx)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    grouped = tboot.bootstrap_rdm_correlation_grouped({"L": a}, {"p": b}, {"p": "L"}, idx)
    assert seen == ["cuda", "cpu", "cuda"]
    assert grouped["p"].shape == (16,)
