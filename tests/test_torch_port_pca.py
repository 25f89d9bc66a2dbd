"""PCA and the low-rank reconstruction control of the PyTorch port
against the JAX package's, on the CPU: ``fit_pca`` (wide and tall
matrices: the port's f64 Gram eigh against the JAX package's f32 SVD),
``PCATransform``, ``reconstruct_from_pcs`` (arrays and tensors, dtypes,
flattening) and ``fit_pca_covariance``.

Reconstructions and subspaces are compared, not components: signs and
the basis of a repeated eigenvalue are arbitrary in both packages.
Tolerances, of each array's largest magnitude: reconstructions 1e-5
(f32 products of the two packages' top-k subspaces, on spectra with
gaps of ≥ 5 %), variances and eigenvalues 1e-5, subspaces 1e-4
(|cos| of each component pair).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visreps_tpu.analysis import reconstruct_from_pcs as jrecon_mod
from visreps_tpu.ops import pca as jpca

from visreps_tpu_torch.analysis import reconstruct_from_pcs as trecon_mod
from visreps_tpu_torch.ops import pca as tpca


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(seed, n, d, offset=1.0):
    """(n, d) f32 rows with a decaying spectrum (gaps ≥ 5 %) and a mean."""
    rng = np.random.RandomState(seed)
    scales = 3.0 * 0.9 ** np.arange(min(n, d))
    u = np.linalg.qr(rng.randn(n, min(n, d)))[0]
    v = np.linalg.qr(rng.randn(d, min(n, d)))[0]
    return (u @ np.diag(scales * np.sqrt(n)) @ v.T + offset * rng.randn(d)).astype(np.float32)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0)


def _same_subspace(got, ref, tol=1e-4):
    """Rows of ``got`` and ``ref`` equal up to sign."""
    cos = np.abs(np.sum(np.asarray(got, np.float64) * np.asarray(ref, np.float64), axis=1))
    np.testing.assert_allclose(cos, 1.0, atol=tol)


class TestFitPca:
    @pytest.mark.parametrize("n,d", [(30, 200), (200, 30), (25, 25)])
    @pytest.mark.parametrize("k", [1, 4])
    def test_matches_jax(self, n, d, k):
        x = _rows(n + d, n, d)
        got = tpca.fit_pca(torch.from_numpy(x), k)
        ref = jpca.fit_pca(jnp.asarray(x), k)
        assert got.components.shape == (k, d) and got.components.dtype == torch.float32
        _close(got.mean.numpy(), np.asarray(ref.mean), 1e-6)
        _close(got.explained_variance.numpy(), np.asarray(ref.explained_variance), 1e-5)
        _same_subspace(got.components.numpy(), np.asarray(ref.components))
        xt = torch.from_numpy(x)
        _close(got.reconstruct(xt).numpy(), np.asarray(ref.reconstruct(jnp.asarray(x))), 1e-5)
        z = got.transform(xt)
        assert z.shape == (n, k)
        _close(got.inverse_transform(z).numpy(), got.reconstruct(xt).numpy(), 1e-6)

    def test_full_rank_k_reconstructs_the_rows(self):
        """k = n on n < d centred rows (rank n − 1): the null direction's
        variance is roundoff, its component finite, and the rows come back
        whole, as from JAX's SVD; rows that are all equal (every variance
        0) get zero components and reconstruct to their mean."""
        x = _rows(1, 12, 40)
        got = tpca.fit_pca(torch.from_numpy(x), 12)
        assert got.components.shape == (12, 40) and bool(torch.isfinite(got.components).all())
        var = got.explained_variance.numpy()
        assert var[-1] <= 1e-10 * var[0]
        same = tpca.fit_pca(torch.ones((5, 7)), 2)
        assert float(same.components.abs().max()) == 0.0
        np.testing.assert_array_equal(same.reconstruct(torch.ones((5, 7))).numpy(), 1.0)
        _close(got.reconstruct(torch.from_numpy(x)).numpy(), x, 1e-5)
        _close(got.reconstruct(torch.from_numpy(x)).numpy(),
               np.asarray(jpca.fit_pca(jnp.asarray(x), 12).reconstruct(jnp.asarray(x))), 1e-5)


class TestReconstructFromPcs:
    def test_arrays_and_tensors_match_jax(self):
        acts = {"conv": _rows(2, 20, 48).reshape(20, 4, 4, 3), "fc": _rows(3, 20, 10)}
        ref = jrecon_mod.reconstruct_from_pcs(acts, 3)
        got = trecon_mod.reconstruct_from_pcs(acts, 3, device="cpu")
        assert tpca.reconstruct_from_pcs is trecon_mod.reconstruct_from_pcs
        for name in acts:
            assert isinstance(got[name], np.ndarray) and got[name].dtype == np.float32
            assert got[name].shape == np.asarray(ref[name]).shape == (20, acts[name][0].size)
            _close(got[name], np.asarray(ref[name]), 1e-5)
        as_tensors = tpca.reconstruct_from_pcs({n: torch.from_numpy(a) for n, a in acts.items()},
                                               3)
        for name in acts:
            assert isinstance(as_tensors[name], torch.Tensor)
            np.testing.assert_array_equal(as_tensors[name].numpy(), got[name])

    def test_dtype_kept_and_k_capped(self):
        x = _rows(4, 16, 6)
        bf16 = tpca.reconstruct_from_pcs({"a": torch.from_numpy(x).to(torch.bfloat16)}, 2)["a"]
        ref = jpca.reconstruct_from_pcs({"a": jnp.asarray(x, jnp.bfloat16)}, 2)["a"]
        assert bf16.dtype == torch.bfloat16
        _close(bf16.float().numpy(), np.asarray(ref, np.float32), 1e-2)
        wide_k = tpca.reconstruct_from_pcs({"a": x}, 50, device="cpu")["a"]  # k > features: all kept
        _close(wide_k, x, 1e-5)
        with pytest.raises(ValueError, match="2-D"):
            tpca.reconstruct_from_pcs({"v": np.zeros(5, np.float32)}, 1, device="cpu")

    def test_arrays_need_a_device(self):
        """An array names no device: without ``device=`` it raises, as the
        port's other entry points do; a tensor runs where it lies."""
        x = _rows(4, 16, 6)
        with pytest.raises(ValueError, match="device="):
            tpca.reconstruct_from_pcs({"a": x}, 2)
        assert tpca.reconstruct_from_pcs({"a": torch.from_numpy(x)}, 2)["a"].device.type == "cpu"


class TestFitPcaCovariance:
    def test_matches_jax(self):
        x = _rows(5, 90, 24)
        batches = [x[i:i + 32] for i in range(0, 90, 32)]
        vecs, vals, mean, total = tpca.fit_pca_covariance(batches, 24, 5, device="cpu")
        jvecs, jvals, jmean, jtotal = jpca.fit_pca_covariance(batches, 24, 5)
        assert vecs.shape == (24, 5) and vals.shape == (5,)
        _close(vals.numpy(), np.asarray(jvals), 1e-5)
        _close(mean.numpy(), np.asarray(jmean), 1e-6)
        assert float(total) == pytest.approx(float(jtotal), rel=1e-5)
        _same_subspace(vecs.numpy().T, np.asarray(jvecs).T)
        assert np.all(np.diff(vals.numpy()) <= 0)
        tensors = tpca.fit_pca_covariance([torch.from_numpy(b) for b in batches], 24, 5)
        np.testing.assert_array_equal(tensors[1].numpy(), vals.numpy())

    def test_array_batches_need_a_device(self):
        """The device is the first batch's; array batches without
        ``device=`` raise, and a generator of batches is read once."""
        x = _rows(6, 40, 8)
        with pytest.raises(ValueError, match="device="):
            tpca.fit_pca_covariance([x[:20], x[20:]], 8, 2)
        gen = (torch.from_numpy(x[i:i + 10]) for i in range(0, 40, 10))
        vecs, vals, mean, _ = tpca.fit_pca_covariance(gen, 8, 2)
        ref = tpca.fit_pca_covariance([x], 8, 2, device="cpu")
        assert vecs.device.type == "cpu"
        _close(vals.numpy(), ref[1].numpy(), 1e-5)
        _close(mean.numpy(), ref[2].numpy(), 1e-6)
