"""Kendall and Pearson scoring and the dense-rank bootstrap of the
PyTorch port against the JAX package's, on the CPU: Kendall tau-a
(tie-free and heavily tied, batched, and against scipy's tau-b converted
to tau-a), the block-contraction Kendall bootstrap at a block width that
gives several blocks, the gathered (Pearson) and both Spearman bootstrap
bodies, ``bootstrap_rdm_correlation`` and its grouped variant, Kendall
and Pearson selection, the unfused ``compute_rsa`` on tied RDMs, and the
whole NSD eval with ``bootstrap_exact_ties=false``.

Tolerances: Kendall tau-a 1e-6 (the port counts in int64 and combines in
f64; the JAX package sums its counts in f32, and scipy in f64); the
bootstrap bodies 1e-6 (Kendall: exact integer counts on both sides) or
1e-5 (rank correlations: f32 sums in other orders); selection 1e-5; the
whole eval 1e-4, as tests/test_torch_port_e2e.py (whose ``nsd_world``
fixture it runs on).
"""
import numpy as np
import pytest
import scipy.stats
import torch

import jax.numpy as jnp

from test_torch_port_e2e import _top_two_gap, nsd_world  # noqa: F401  (a fixture)
from visreps_tpu.analysis import rsa as jrsa
from visreps_tpu.ops import bootstrap as jboot
from visreps_tpu.ops import kendall as jkendall
from visreps_tpu.ops import rdm as jrdm
from visreps_tpu.ops import stats as jstats

from visreps_tpu_torch.analysis import alignment as talign
from visreps_tpu_torch.analysis import rsa as trsa
from visreps_tpu_torch.ops import bootstrap as tboot
from visreps_tpu_torch.ops import kendall as tkendall
from visreps_tpu_torch.ops import stats as tstats

N_BOOT = 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tied(rng, n, levels):
    """Values drawn from ``levels`` distinct numbers: heavy ties."""
    return rng.randint(0, levels, n).astype(np.float32) / 7.0


def _tau_a_scipy(x, y) -> float:
    """scipy's tau-b converted to tau-a, as the reference converts it."""
    n0 = len(x) * (len(x) - 1) / 2

    def ties(v):
        _, c = np.unique(v, return_counts=True)
        return float((c * (c - 1) / 2).sum())

    tau_b = scipy.stats.kendalltau(x, y).statistic
    return tau_b * np.sqrt((n0 - ties(x)) * (n0 - ties(y))) / n0


def _rdm(rng, n, d=6, tied=False):
    """A correlation RDM of random rows; ``tied`` rounds it to thirds
    (many exact ties, 0 and 2 among them)."""
    r = np.array(jrdm.compute_rdm(rng.randn(n, d).astype(np.float32)))
    return (np.round(r * 3) / 3).astype(np.float32) if tied else r


class TestKendallTauA:
    @pytest.mark.parametrize("kind", ["tie_free", "x_ties", "y_ties", "joint_ties"])
    @pytest.mark.parametrize("n", [2, 3, 37, 600])
    def test_matches_jax_and_scipy(self, kind, n):
        rng = np.random.RandomState(n)
        x, y = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
        if kind in ("x_ties", "joint_ties"):
            x = _tied(rng, n, 4)
        if kind in ("y_ties", "joint_ties"):
            y = _tied(rng, n, 3)
        got = float(tstats.kendall_tau_a(torch.from_numpy(x), torch.from_numpy(y)))
        assert got == pytest.approx(float(jstats.kendall_tau_a(x, y)), abs=1e-6)
        if kind == "tie_free" or np.unique(x).size > 1 and np.unique(y).size > 1:
            assert got == pytest.approx(_tau_a_scipy(x, y), abs=1e-6)

    def test_batched_rows_and_degenerate_inputs(self):
        rng = np.random.RandomState(1)
        x = rng.randn(3, 4, 50).astype(np.float32)
        y = _tied(rng, 50, 5)[None, None]
        got = tstats.kendall_tau_a(torch.from_numpy(x), torch.from_numpy(y))
        assert got.shape == (3, 4) and got.dtype == torch.float32
        ref = [[float(jstats.kendall_tau_a(x[i, j], y[0, 0])) for j in range(4)] for i in range(3)]
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
        assert np.isnan(float(tstats.kendall_tau_a(torch.ones(1), torch.ones(1))))
        const = float(tstats.kendall_tau_a(torch.ones(5), torch.arange(5.0)))
        assert const == float(jstats.kendall_tau_a(jnp.ones(5), jnp.arange(5.0))) == 0.0


class TestBootstrapBodies:
    @pytest.mark.parametrize("tied", [False, True])
    @pytest.mark.parametrize("block", [64, 1024])
    def test_kendall_fast(self, tied, block):
        """nb = 8 blocks at block 64 (M = 435 → P = 512); a last chunk of 4."""
        rng = np.random.RandomState(2)
        a, b = _rdm(rng, 30, tied=tied), _rdm(rng, 30, tied=tied)
        idx = jboot.bootstrap_indices(30, N_BOOT, seed=42)
        got = tkendall.bootstrap_kendall_fast(torch.from_numpy(a), torch.from_numpy(b), idx,
                                              chunk=10, block=block)
        assert got.shape == (N_BOOT,) and got.dtype == torch.float32
        ref = jkendall.bootstrap_kendall_fast(jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx), 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
        per_iter = tboot.gathered_scores(torch.from_numpy(a), torch.from_numpy(b),
                                         torch.from_numpy(idx).long(), "kendall")
        np.testing.assert_array_equal(got.numpy(), per_iter.numpy())
        pre = tkendall.kendall_precompute(torch.from_numpy(a[np.triu_indices(30, 1)]),
                                          torch.from_numpy(b[np.triu_indices(30, 1)]), block)
        assert pre["nb"] == 512 // min(block, 512) and pre["A"].shape[1:] == (pre["B"],) * 2

    @pytest.mark.parametrize("tied", [False, True])
    def test_spearman_bodies_and_gathered_pearson(self, tied):
        rng = np.random.RandomState(3)
        a, b = _rdm(rng, 28, tied=tied), _rdm(rng, 28, tied=tied)
        idx = jboot.bootstrap_indices(28, N_BOOT, seed=42)
        ta, tb, ti = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(idx).long()
        ja, jb, ji = jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx)
        np.testing.assert_allclose(tboot.spearman_fast_scores(ta, tb, ti, chunk=10).numpy(),
                                   np.asarray(jboot._bootstrap_spearman_fast(ja, jb, ji, 10)),
                                   atol=1e-5)
        np.testing.assert_allclose(tboot.spearman_exact_scores(ta, tb, ti, chunk=10).numpy(),
                                   np.asarray(jboot._bootstrap_spearman_exact(ja, jb, ji, 10)),
                                   atol=1e-5)
        for method in ("pearson", "spearman", "kendall"):
            np.testing.assert_allclose(
                tboot.gathered_scores(ta, tb, ti, method, chunk=10).numpy(),
                np.asarray(jboot._bootstrap_scores(ja, jb, ji, method, 10)), atol=1e-5,
                err_msg=method)

    @pytest.mark.parametrize("method,exact_ties", [
        ("spearman", False), ("spearman", True), ("pearson", False), ("kendall", False)])
    def test_bootstrap_rdm_correlation(self, method, exact_ties):
        rng = np.random.RandomState(4)
        a, b = _rdm(rng, 26, tied=True), _rdm(rng, 26)
        kw = dict(n_bootstrap=N_BOOT, seed=7, method=method, exact_ties=exact_ties)
        got = tboot.bootstrap_rdm_correlation(torch.from_numpy(a), b, **kw)
        ref = jboot.bootstrap_rdm_correlation(a, b, **kw)
        assert got.dtype == np.float64 and got.shape == (N_BOOT,)
        np.testing.assert_allclose(got, ref, atol=1e-5)
        idx = jboot.bootstrap_indices(26, 5, seed=42)
        np.testing.assert_allclose(
            tboot.bootstrap_rdm_correlation(a, b, method=method, exact_ties=exact_ties,
                                            indices=idx, device="cpu"),
            jboot.bootstrap_rdm_correlation(a, b, method=method, exact_ties=exact_ties,
                                            indices=idx), atol=1e-5)

    def test_arrays_need_a_device(self):
        """Arrays name no device: the per-pair routes raise without
        ``device=``, as the port's other entry points do."""
        rng = np.random.RandomState(4)
        a, b = _rdm(rng, 12), _rdm(rng, 12)
        idx = jboot.bootstrap_indices(12, 3, seed=42)
        with pytest.raises(ValueError, match="device="):
            tboot.bootstrap_rdm_correlation(a, b, indices=idx)
        with pytest.raises(ValueError, match="device="):
            tboot.bootstrap_rdm_correlation_grouped({"L": a}, {"p": b}, {"p": "L"}, idx)
        with pytest.raises(ValueError, match="device="):
            tboot.single_pair_scoring(a, b, idx)

    def test_grouped_variant(self):
        rng = np.random.RandomState(5)
        model = {"L1": _rdm(rng, 24, tied=True), "L2": _rdm(rng, 24)}
        neural = {("r", s): _rdm(rng, 24, tied=s == 0) for s in range(3)}
        layer = {("r", 0): "L2", ("r", 1): "L1", ("r", 2): "L2"}
        idx = jboot.bootstrap_indices(24, N_BOOT, seed=42)
        got = tboot.bootstrap_rdm_correlation_grouped(
            {k: torch.from_numpy(v) for k, v in model.items()}, neural, layer, idx, chunk=10)
        ref = jboot.bootstrap_rdm_correlation_grouped(model, neural, layer, idx, chunk=10)
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].dtype == np.float64
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5)
            single = tboot.bootstrap_rdm_correlation(model[layer[k]], neural[k], method="spearman",
                                                     exact_ties=True, indices=idx, device="cpu")
            np.testing.assert_allclose(got[k], single, atol=1e-6)


class TestSelectionAndComputeRsa:
    @pytest.mark.parametrize("method", ["kendall", "pearson"])
    def test_select_scores_multipair(self, method):
        rng = np.random.RandomState(6)
        taps = rng.randn(4, 22, 16).astype(np.float32)
        taps[2, :, :4] = np.round(taps[2, :, :4])  # tied entries in one layer's RDM
        neural = np.stack([np.asarray(jrdm.compute_rdm(rng.randn(22, v).astype(np.float32)))
                           for v in (5, 9, 3)])
        got = trsa.select_scores_multipair([torch.from_numpy(t) for t in taps],
                                           torch.from_numpy(neural), method)
        ref = jrsa._select_scores_multipair(jnp.asarray(taps), jnp.asarray(neural), method)
        assert got.shape == (3, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    @pytest.mark.parametrize("cfg", [{"compare_method": "kendall"},
                                     {"compare_method": "pearson"},
                                     {"compare_method": "spearman", "bootstrap_exact_ties": False}])
    def test_compute_rsa_unfused_on_tied_rdms(self, cfg):
        """Layers of ±1 rows: their RDMs are tied (every correlation k/8)."""
        rng = np.random.RandomState(7)
        signs = lambda n, d: np.sign(rng.randn(n, d)).astype(np.float32)
        acts = {f"L{i}": signs(40, 8) for i in range(3)}
        neural = acts["L2"][:, :6] + 0.5 * rng.randn(40, 6).astype(np.float32)
        split = [talign.AlignmentData({l: a[sl] for l, a in acts.items()}, neural[sl])
                 for sl in (slice(0, 16), slice(16, 40))]
        kw = dict(n_select=12, bootstrap=True, n_bootstrap=N_BOOT)
        got = trsa.compute_rsa(cfg, *split, **kw, device="cpu")[0]
        ref = jrsa.compute_rsa(cfg, *split, **kw)[0]
        assert set(got) == set(ref) and got["layer"] == ref["layer"]
        assert got["bootstrap_exact_ties"] is ref["bootstrap_exact_ties"] is False
        np.testing.assert_allclose([e["score"] for e in got["layer_selection_scores"]],
                                   [e["score"] for e in ref["layer_selection_scores"]], atol=1e-5)
        assert got["score"] == pytest.approx(ref["score"], abs=1e-5)
        np.testing.assert_allclose(got["bootstrap_scores"], ref["bootstrap_scores"], atol=1e-5)
        assert (got["ci_low"], got["ci_high"]) == pytest.approx((ref["ci_low"], ref["ci_high"]),
                                                                abs=1e-5)


class TestDenseBootstrapEval:
    def test_nsd_eval_with_dense_ranks(self, nsd_world):
        """The whole NSD eval with bootstrap_exact_ties=false (the per-pair
        route's dense-rank bootstraps) in both packages."""
        ref, got = nsd_world["run"]({"bootstrap_exact_ties": False}, name="dense")
        assert len(got) == len(ref) == 4
        for t, j in zip(got, ref):
            np.testing.assert_allclose([e["score"] for e in t["layer_selection_scores"]],
                                       [e["score"] for e in j["layer_selection_scores"]],
                                       atol=1e-4)
            if t["layer"] != j["layer"]:
                assert _top_two_gap(j) <= 1e-4
                continue
            assert t["score"] == pytest.approx(j["score"], abs=1e-4)
            np.testing.assert_allclose(t["bootstrap_scores"], j["bootstrap_scores"], atol=1e-4)
            assert (t["ci_low"], t["ci_high"]) == pytest.approx((j["ci_low"], j["ci_high"]),
                                                                abs=1e-4)
