"""The encoding-score eval of the PyTorch port against the JAX package's,
on the CPU: z-norms, every ridge function on both solver routes, the
bootstrap over cached predictions, the per-pair and subject-batched
encoding functions, and the whole eval on a tiny on-disk NSD fixture.

Tolerances: 1e-6 for z-norms and Pearson r; ridge weights, predictions
and scores at rtol 1e-4 relative to each array's largest magnitude
(``_close``). The two packages' eigendecompositions (LAPACK in both, but
other builds) differ in the last bits, and so do their f32 sums.

The per-fold-eigh route is taken where a fold's train block has fewer
rows than columns, so each fold Gram has a null space whose eigenvalues
are f32 roundoff (~1e-5 of the largest): at alpha α the fold's CV R²
then carries ~1e-5/α of roundoff in either package (measured: 1.7e10 at
α = 1e-10, 2.5e-6 at α = 3.4), and a voxel whose CV argmax lands below
α ≈ 1 has a roundoff-decided alpha and weights in BOTH packages (at
n_fit 16, d 64 their selection scores part by up to 0.18). So on that
route ``ridge_cv``'s CV scores are compared for α ≥ 1 and its selected
alphas where the top two CV scores differ by more than 1e-4, and every
other function runs on the protocol's alphas ≥ 1 (``DETERMINED``, by
argument or by patching both packages' ``default_alphas``); the Woodbury
route runs on all 20.
"""
import json
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
from visreps_tpu.analysis import alignment as jalign
from visreps_tpu.analysis import encoding as jenc
from visreps_tpu.analysis.alignment import AlignmentData as JaxAlignmentData
from visreps_tpu.benchmarks import fixture as jfixture
from visreps_tpu.core.config import Config as JaxConfig
from visreps_tpu.models.extractor import FeatureExtractor as JaxExtractor
from visreps_tpu.models.zoo import init_model as jax_init_model
from visreps_tpu.ops import ridge as jridge
from visreps_tpu.ops.znorm import znorm as jax_znorm, znorm_fit as jax_znorm_fit

import visreps_tpu_torch.core.db as tdb
import visreps_tpu_torch.evals as tevals
from visreps_tpu_torch import run as trun
from visreps_tpu_torch.analysis import encoding as tenc
from visreps_tpu_torch.analysis.alignment import (
    AlignmentData,
    align_stimulus_level,
    compute_traintest_alignment,
)
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.models.convert import params_from_jax
from visreps_tpu_torch.models.standard import AlexNet
from visreps_tpu_torch.ops import ridge as tridge
from visreps_tpu_torch.ops import znorm as tznorm

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-4
ALPHAS = jridge.default_alphas()
DETERMINED = ALPHAS[ALPHAS >= 1]  # where the per-fold-eigh route is not roundoff-decided


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _determined_alphas(mp) -> None:
    """Both packages' default alphas → DETERMINED (the eigh route's tests)."""
    for mod in (jridge, tridge, jenc, tenc):
        mp.setattr(mod, "default_alphas", lambda n=20: DETERMINED.copy())


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _regression(seed, n, d, v, noise=2.0):
    """z-normed (x, y): y a noisy linear readout of x."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = x @ rng.randn(d, v).astype(np.float32) + noise * rng.randn(n, v).astype(np.float32)
    z = lambda a: ((a - a.mean(0)) / (a.std(0, ddof=1) + 1e-8)).astype(np.float32)
    return z(x), z(y)


def _subject(seed, n_train, n_test, d, n_layers=3, signal=2, voxels=(8, 5)):
    """One subject's raw layers and two regions' targets, planted on
    layer ``signal``."""
    rng = np.random.RandomState(seed)
    names = [f"tap{i + 1}" for i in range(n_layers)]
    tr = {l: rng.randn(n_train, d).astype(np.float32) for l in names}
    te = {l: rng.randn(n_test, d).astype(np.float32) for l in names}
    y_tr, y_te = {}, {}
    for r, v in zip(("regA", "regB"), voxels):
        w = rng.randn(d, v).astype(np.float32) / np.sqrt(d)
        y_tr[r] = tr[names[signal]] @ w + 0.5 * rng.randn(n_train, v).astype(np.float32)
        y_te[r] = te[names[signal]] @ w + 0.5 * rng.randn(n_test, v).astype(np.float32)
    return tr, te, y_tr, y_te


def _top_two_gap(result) -> float:
    top2 = sorted(e["score"] for e in result["layer_selection_scores"])[-2:]
    return top2[1] - top2[0]


def _same_result(got, ref, n_boot):
    """One result dict of each package: selection, layer, point score,
    CIs and bootstrap scores at 1e-4."""
    gsel = {e["layer"]: e["score"] for e in got["layer_selection_scores"]}
    rsel = {e["layer"]: e["score"] for e in ref["layer_selection_scores"]}
    assert list(gsel) == list(rsel)
    np.testing.assert_allclose(list(gsel.values()), list(rsel.values()), atol=RTOL)
    assert got["analysis"] == ref["analysis"] == "encoding_score"
    assert got["compare_method"] == ref["compare_method"] == "pearson"
    if got["layer"] != ref["layer"]:
        assert _top_two_gap(ref) <= RTOL
        return
    assert got["score"] == pytest.approx(ref["score"], abs=RTOL)
    if n_boot:
        assert len(got["bootstrap_scores"]) == len(ref["bootstrap_scores"]) == n_boot
        np.testing.assert_allclose(got["bootstrap_scores"], ref["bootstrap_scores"], atol=RTOL)
        assert got["ci_low"] == pytest.approx(ref["ci_low"], abs=RTOL)
        assert got["ci_high"] == pytest.approx(ref["ci_high"], abs=RTOL)
    else:
        assert got["ci_low"] is got["ci_high"] is None and "bootstrap_scores" not in got


class TestZnormAndScores:
    def test_znorm_fit_and_znorm(self):
        rng = np.random.RandomState(0)
        x = (3.0 * rng.randn(40, 6) + 1.5).astype(np.float32)
        x[:, 2] = 2.0  # constant column: std 0 + 1e-8, normed 0
        other = rng.randn(10, 6).astype(np.float32)
        jn, jm, js = jax_znorm_fit(jnp.asarray(x))
        tn, tm, ts = tznorm.znorm_fit(torch.from_numpy(x))
        for got, ref in ((tn, jn), (tm, jm), (ts, js)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tznorm.znorm(torch.from_numpy(other), tm, ts).numpy(),
                                   np.asarray(jax_znorm(jnp.asarray(other), jm, js)),
                                   rtol=1e-6, atol=1e-6)
        assert not tn[:, 2].any()

    def test_correlation_score_and_r2(self):
        rng = np.random.RandomState(1)
        y = rng.randn(30, 5).astype(np.float32)
        p = (y + rng.randn(30, 5)).astype(np.float32)
        y[:, 1] = 1.0  # zero variance: r = 0, R² with ss = 1
        p[:, 3] = 4.0
        r = tridge.correlation_score(torch.from_numpy(y), torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(r, np.asarray(jridge.correlation_score(y, p)), atol=1e-6)
        assert r[1] == r[3] == 0.0
        np.testing.assert_allclose(
            tridge._r2_per_target(torch.from_numpy(y), torch.from_numpy(p)).numpy(),
            np.asarray(jridge._r2_per_target(jnp.asarray(y), jnp.asarray(p))), atol=1e-6)

    def test_folds_and_gate(self):
        for n in (5, 23, 40, 41, 7200):
            assert tridge._kfold_bounds(n, 5) == jridge._kfold_bounds(n, 5)
            for d in (16, 32, 33, 4096):
                assert tridge._woodbury_ok(n, d, 5) == jridge._woodbury_ok(n, d, 5)
        np.testing.assert_array_equal(tridge.default_alphas(), ALPHAS)

    def test_numpy_inputs_need_a_device(self):
        x, y = _regression(0, 30, 4, 2)
        with pytest.raises(ValueError, match="device"):
            tridge.ridge_cv(x, y)
        assert tridge.ridge_cv(torch.from_numpy(x), y).weights.device.type == "cpu"
        with pytest.raises(ValueError, match="precision"):
            tridge.ridge_cv_selection_val_r(np.stack([x]), y, np.arange(24), np.arange(24, 30),
                                            precision="fast", device="cpu")


# (n, d, solver) → route: Woodbury, per-fold eigh (auto: 50 − 10 < 45), and
# per-fold eigh forced on a well-posed problem.
RIDGE_CASES = [(120, 16, "auto", True), (50, 45, "auto", False), (120, 16, "eigh", False)]


class TestRidge:
    @pytest.mark.parametrize("n,d,solver,wood", RIDGE_CASES)
    def test_ridge_cv(self, n, d, solver, wood):
        x, y = _regression(n + d, n, d, 6)
        assert tridge._use_wood(solver, n, d, 5) == wood
        j = jridge.ridge_cv(x, y, solver=solver)
        t = tridge.ridge_cv(x, y, solver=solver, device="cpu")
        _close(t.weights, j.weights)
        xt = np.random.RandomState(9).randn(7, d).astype(np.float32)
        _close(t.predict(torch.from_numpy(xt)), j.predict(jnp.asarray(xt)))
        keep = ALPHAS >= (1.0 if solver == "auto" and not wood else 0.0)
        jc, tc = np.asarray(j.cv_scores), t.cv_scores.numpy()
        _close(tc[keep], jc[keep])
        srt = np.sort(jc, axis=0)
        decided = srt[-1] - srt[-2] > RTOL
        np.testing.assert_array_equal(t.best_alphas.numpy()[decided],
                                      np.asarray(j.best_alphas)[decided])

    @pytest.mark.parametrize("n,d,wood", [(120, 16, True), (50, 45, False)])
    def test_val_scores_batched(self, n, d, wood):
        rng = np.random.RandomState(3)
        xs = rng.randn(3, n, d).astype(np.float32)
        xv = rng.randn(3, 20, d).astype(np.float32)
        w = rng.randn(d, 5).astype(np.float32)
        y, yv = xs[1] @ w + rng.randn(n, 5), xv[1] @ w + rng.randn(20, 5)
        alphas = None if wood else DETERMINED
        j = jridge.ridge_cv_val_scores_batched(xs, y, xv, yv, alphas=alphas)
        t = tridge.ridge_cv_val_scores_batched(xs, y, xv, yv, alphas=alphas, device="cpu")
        _close(t, j)

    @pytest.mark.parametrize("precision", ["highest", "high"])
    @pytest.mark.parametrize("n,d,wood", [(150, 16, True), (40, 48, False)])
    def test_selection_val_r(self, n, d, wood, precision):
        rng = np.random.RandomState(4)
        xs = (2.0 * rng.randn(4, n, d) + 0.3).astype(np.float32)
        y = (xs[2] @ rng.randn(d, 7) / np.sqrt(d) + 0.5 * rng.randn(n, 7)).astype(np.float32)
        perm = np.random.RandomState(42).permutation(n)
        fit, val = perm[:int(0.8 * n)], perm[int(0.8 * n):]
        assert tridge._woodbury_ok(len(fit), d, 5) == wood
        alphas = None if wood else DETERMINED
        j = jridge.ridge_cv_selection_val_r(xs, y, fit, val, alphas=alphas, precision=precision)
        t = tridge.ridge_cv_selection_val_r(torch.from_numpy(xs), y, fit, val, alphas=alphas,
                                            precision=precision)
        assert t.shape == (4, 7)
        _close(t, j)

    @pytest.mark.parametrize("n,d,wood", [(120, 16, True), (50, 45, False)])
    def test_refit_predict(self, n, d, wood):
        rng = np.random.RandomState(5)
        x_tr, x_te = rng.randn(n, d).astype(np.float32), rng.randn(30, d).astype(np.float32)
        w = rng.randn(d, 6).astype(np.float32)
        y_tr = (x_tr @ w + 2 * rng.randn(n, 6) + 1.0).astype(np.float32)
        y_te = (x_te @ w + 2 * rng.randn(30, 6) + 1.0).astype(np.float32)
        alphas = None if wood else DETERMINED
        j = jridge.ridge_cv_refit_predict(x_tr, y_tr, x_te, y_te, alphas=alphas)
        t = tridge.ridge_cv_refit_predict(x_tr, y_tr, x_te, y_te, alphas=alphas, device="cpu")
        for got, ref in zip(t, j):
            _close(got, ref)

    def test_refit_grouped_mixed_routes(self, monkeypatch):
        """Woodbury and per-fold-eigh jobs in one call, with explicit and
        per-region targets; each equals its own refit."""
        _determined_alphas(monkeypatch)
        rng = np.random.RandomState(6)
        jobs = []
        for n, parts in ((120, 1), (18, 2), (90, 2), (50, 1)):  # 18: 14 < 16 rows → eigh
            x_tr, x_te = rng.randn(n, 16).astype(np.float32), rng.randn(25, 16).astype(np.float32)
            w = rng.randn(16, 4 * parts).astype(np.float32)
            y_tr = (x_tr @ w + rng.randn(n, 4 * parts)).astype(np.float32)
            y_te = (x_te @ w + rng.randn(25, 4 * parts)).astype(np.float32)
            job = {"x_tr": x_tr, "x_te": x_te}
            if parts == 1:
                job.update(y_tr=y_tr, y_te=y_te)
            else:
                job.update(y_tr_parts=[y_tr[:, :4], y_tr[:, 4:]],
                           y_te_parts=[y_te[:, :4], y_te[:, 4:]])
            jobs.append(job)
        j = jridge.ridge_cv_refit_predict_grouped(jobs)
        tjobs = [{k: ([torch.from_numpy(p) for p in v] if isinstance(v, list)
                      else torch.from_numpy(v)) for k, v in job.items()} for job in jobs]
        t = tridge.ridge_cv_refit_predict_grouped(tjobs)
        assert [tridge._woodbury_ok(job["x_tr"].shape[0], 16, 5) for job in jobs] == [
            True, False, True, True]
        for tj, jj in zip(t, j):
            for got, ref in zip(tj, jj):
                _close(got, ref)
        single = tridge.ridge_cv_refit_predict(tjobs[0]["x_tr"], tjobs[0]["y_tr"],
                                               tjobs[0]["x_te"], tjobs[0]["y_te"])
        _close(t[0][0], single[0], rtol=1e-5)
        assert tridge.ridge_cv_refit_predict_grouped([]) == []


class TestEncodingFunctions:
    @pytest.mark.parametrize("n_boot,chunk", [(40, 64), (40, 16), (37, 8)])
    def test_bootstrap_pred_scores(self, n_boot, chunk):
        rng = np.random.RandomState(7)
        y = rng.randn(30, 9).astype(np.float32)
        p = (y + rng.randn(30, 9)).astype(np.float32)
        p[:, 4] = 1.0
        idx = np.stack([rng.choice(30, 27, replace=False) for _ in range(n_boot)]).astype(np.int32)
        j = jenc._bootstrap_pred_scores(jnp.asarray(y), jnp.asarray(p), jnp.asarray(idx),
                                        chunk=chunk)
        t = tenc._bootstrap_pred_scores(torch.from_numpy(y), torch.from_numpy(p),
                                        torch.from_numpy(idx).long(), chunk=chunk)
        assert t.shape == (n_boot,)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)

    @pytest.mark.parametrize("n_train,d", [(120, 30), (40, 48)])
    def test_compute_encoding_score(self, n_train, d, monkeypatch):
        if not tridge._woodbury_ok(int(0.8 * n_train), d, 5):
            _determined_alphas(monkeypatch)
        tr, te, y_tr, y_te = _subject(8, n_train, 40, d)
        j = jenc.compute_encoding_score(JaxAlignmentData(tr, y_tr["regA"]),
                                        JaxAlignmentData(te, y_te["regA"]), n_bootstrap=16)[0]
        t = tenc.compute_encoding_score(AlignmentData(tr, y_tr["regA"]),
                                        AlignmentData(te, y_te["regA"]), n_bootstrap=16,
                                        device="cpu")[0]
        assert t["layer"] == j["layer"] == "tap3"
        _same_result(t, j, 16)

    @pytest.mark.parametrize("n_train,d", [(120, 30), (40, 48)])
    def test_subject_batched(self, n_train, d, monkeypatch):
        if not tridge._woodbury_ok(int(0.8 * n_train), d, 5):
            _determined_alphas(monkeypatch)
        tr, te, y_tr, y_te = _subject(9, n_train, 40, d)
        j = jenc.compute_encoding_scores_subject(tr, te, y_tr, y_te, n_bootstrap=16)
        t = tenc.compute_encoding_scores_subject(tr, te, y_tr, y_te, n_bootstrap=16,
                                                 device="cpu")
        assert list(t) == list(j) == ["regA", "regB"]
        for r in t:
            assert t[r][0]["layer"] == "tap3"
            _same_result(t[r][0], j[r][0], 16)

    def test_subject_batched_matches_per_pair(self):
        """All regions in one batched pass = compute_encoding_score per
        (region, subject), inside the port (tolerances of the JAX
        package's own test of the same contract)."""
        tr, te, y_tr, y_te = _subject(10, 120, 40, 30)
        batched = tenc.compute_encoding_scores_subject(
            {l: torch.from_numpy(a) for l, a in tr.items()}, te, y_tr, y_te, n_bootstrap=8)
        for region in ("regA", "regB"):
            ref = tenc.compute_encoding_score(AlignmentData(tr, y_tr[region]),
                                              AlignmentData(te, y_te[region]), n_bootstrap=8,
                                              device="cpu")[0]
            got = batched[region][0]
            assert got["layer"] == ref["layer"] == "tap3"
            for key in ("score", "ci_low", "ci_high"):
                assert got[key] == pytest.approx(ref[key], abs=2e-4)
            np.testing.assert_allclose(got["bootstrap_scores"], ref["bootstrap_scores"],
                                       atol=2e-4)
            for g, r in zip(got["layer_selection_scores"], ref["layer_selection_scores"]):
                assert g["layer"] == r["layer"]
                assert g["score"] == pytest.approx(r["score"], abs=2e-3)

    @pytest.mark.parametrize("precision", ["highest", "high"])
    def test_subjects_grouped_refits(self, precision, monkeypatch):
        """Two subjects, one of them on each solver route, refit in one
        grouped call; also equal to per-subject calls."""
        _determined_alphas(monkeypatch)
        inputs = {0: _subject(11, 120, 40, 16, signal=1), 1: _subject(12, 18, 40, 16)}
        j = jenc.compute_encoding_scores_subjects(inputs, n_bootstrap=16,
                                                  cv_precision=precision)
        t = tenc.compute_encoding_scores_subjects(inputs, n_bootstrap=16,
                                                  cv_precision=precision, device="cpu")
        assert set(tenc.LAST_PHASE_TIMES) == {"selection_s", "refit_s", "assemble_bootstrap_s"}
        for subj in (0, 1):
            assert list(t[subj]) == ["regA", "regB"]
            single = tenc.compute_encoding_scores_subject(*inputs[subj], n_bootstrap=16,
                                                          cv_precision=precision, device="cpu")
            for r in ("regA", "regB"):
                _same_result(t[subj][r][0], j[subj][r][0], 16)
                assert t[subj][r][0]["score"] == pytest.approx(single[r][0]["score"], abs=1e-6)
        assert t[0]["regA"][0]["layer"] == "tap2"

    def test_no_bootstrap_and_4d_layers(self):
        rng = np.random.RandomState(13)
        tr = {"conv": rng.randn(60, 2, 3, 4).astype(np.float32)}
        te = {"conv": rng.randn(20, 2, 3, 4).astype(np.float32)}
        w = rng.randn(24, 3).astype(np.float32)
        y_tr = {"r": tr["conv"].reshape(60, -1) @ w}
        y_te = {"r": te["conv"].reshape(20, -1) @ w}
        j = jenc.compute_encoding_scores_subject(tr, te, y_tr, y_te, bootstrap=False)
        t = tenc.compute_encoding_scores_subject(tr, te, y_tr, y_te, bootstrap=False,
                                                 device="cpu")
        _same_result(t["r"][0], j["r"][0], 0)
        assert t["r"][0]["score"] > 0.95

    def test_out_of_slice_and_invalid_inputs_raise(self, monkeypatch):
        """``reconstruct_pca_k`` (train-fitted PCA reconstruction of the
        selected layer) and the RSA branch's dense-rank bootstrap
        (``bootstrap_exact_ties=false``) agree with the JAX package at
        1e-4, on the alphas ≥ 1: the reconstructed rank-5 features leave a
        null space whose roundoff decides the smaller alphas (see the module
        docstring). Invalid inputs raise."""
        _determined_alphas(monkeypatch)
        tr, te, y_tr, y_te = _subject(14, 40, 20, 8)
        train, test = AlignmentData(tr, y_tr["regA"]), AlignmentData(te, y_te["regA"])
        jtrain, jtest = JaxAlignmentData(tr, y_tr["regA"]), JaxAlignmentData(te, y_te["regA"])
        kw = {"reconstruct_pca_k": 5, "n_bootstrap": 16}
        _same_result(tenc.compute_encoding_score(train, test, device="cpu", **kw)[0],
                     jenc.compute_encoding_score(jtrain, jtest, **kw)[0], 16)
        got = tenc.compute_encoding_scores_subject(tr, te, y_tr, y_te, device="cpu", **kw)
        ref = jenc.compute_encoding_scores_subject(tr, te, y_tr, y_te, **kw)
        many = tenc.compute_encoding_scores_subjects({0: (tr, te, y_tr, y_te)}, device="cpu",
                                                     **kw)
        for r in ("regA", "regB"):
            _same_result(got[r][0], ref[r][0], 16)
            assert many[0][r][0]["score"] == pytest.approx(got[r][0]["score"], abs=1e-6)
        cfg = {"analysis": "encoding_score", "reconstruct_from_pcs": True, "pca_k": 5,
               "n_bootstrap": 16}
        _same_result(compute_traintest_alignment(Config(cfg), train, test, device="cpu")[0],
                     jalign.compute_traintest_alignment(JaxConfig(cfg), jtrain, jtest)[0], 16)
        with pytest.raises(ValueError, match="things-behavior"):
            compute_traintest_alignment(Config({"analysis": "encoding_score",
                                                "neural_dataset": "things-behavior"}),
                                        train, test, device="cpu")
        cfg = {"analysis": "rsa", "bootstrap_exact_ties": False, "n_bootstrap": 16}
        dense = compute_traintest_alignment(Config(cfg), train, test, device="cpu")[0]
        jdense = jalign.compute_traintest_alignment(JaxConfig(cfg), jtrain, jtest)[0]
        assert dense["layer"] == jdense["layer"] and dense["bootstrap_exact_ties"] is False
        assert dense["score"] == pytest.approx(jdense["score"], abs=RTOL)
        np.testing.assert_allclose(dense["bootstrap_scores"], jdense["bootstrap_scores"], atol=RTOL)
        rsa = compute_traintest_alignment(Config({"analysis": "rsa", "bootstrap": False}),
                                          train, test, device="cpu")
        assert len(rsa) == 1 and rsa[0]["layer"] in tr and rsa[0]["analysis"] == "rsa"
        with pytest.raises(ValueError, match="Unknown analysis"):
            compute_traintest_alignment(Config({"analysis": "cka"}), train, test, device="cpu")
        with pytest.raises(ValueError, match="device"):
            tenc.compute_encoding_score(train, test)

    def test_align_keeps_the_store_where_it_is(self):
        acts = {"a": torch.arange(12.0).reshape(6, 2).to(torch.bfloat16),
                "b": np.arange(12.0, dtype=np.float32).reshape(6, 2)}
        targets = {"3": np.ones(4), "1": np.zeros(4), "9": np.ones(4)}
        got, neural, ids = align_stimulus_level(acts, targets, [0, 1, 2, 3, 4, 5])
        assert ids == ["1", "3"] and neural.shape == (2, 4) and neural.dtype == np.float32
        assert isinstance(got["a"], torch.Tensor) and got["a"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["a"].float().numpy(), [[2, 3], [6, 7]])
        np.testing.assert_array_equal(got["b"], [[2, 3], [6, 7]])


# ── The whole eval, JAX package against the port ──

TINY = {"N_SHARED": 12, "N_SUBJECTS": 2, "REGIONS": ["early", "ventral"], "N_VOXELS": 8,
        "IMG_SIZE": 64}
N_BOOT = 16
# (srp_k, N_UNIQUE): 38 fit rows − 8 ≥ 16 takes Woodbury; 16 − 4 < 64 per-fold eigh.
EVAL_CASES = {"woodbury": (16, 48), "eigh": (64, 20)}


def _eval_cfg(srp_k) -> dict:
    return {
        "mode": "eval", "seed": 1, "neural_dataset": "nsd", "subject_idx": [0, 1],
        "shared_test_subjects": [0, 1],
        "region": ["early visual stream", "ventral visual stream"],
        "analysis": "encoding_score", "bootstrap": True, "n_bootstrap": N_BOOT,
        "batchsize": 16, "num_workers": 2, "load_model_from": "torchvision",
        "model_name": "AlexNet", "pretrained_dataset": "none", "extract_pre_and_post": True,
        "srp_k": srp_k, "uint8_transfer": True, "log_expdata": True, "use_mesh": False,
    }


@pytest.fixture(scope="module", params=list(EVAL_CASES))
def both_evals(request, tmp_path_factory):
    """Both packages' encoding eval on one tiny on-disk fixture (the JAX
    bench's HDF5 fixture), with the same AlexNet weights. The port runs
    through its CLI (``run.main --device cpu``) and selects on the JAX
    eval's SRP store (the two packages' stores differ by bf16 rounding
    of taps that differ by ~1e-6; tests/test_torch_port_e2e.py holds the
    port's own store), then once more with ``encoding_batched=false``.
    The eigh case runs both packages on the alphas ≥ 1 (module docstring)."""
    srp_k, n_unique = EVAL_CASES[request.param]
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp(f"enc_{request.param}")
    stores = {}
    try:
        if request.param == "eigh":
            _determined_alphas(mp)
        mp.setattr(jfixture, "FIXTURE_DIR", tmp / "fx")
        mp.setattr(jfixture, "N_JPEG", 1)
        for k, v in {**TINY, "N_UNIQUE": n_unique,
                     "N_STIMULI": TINY["N_SHARED"] + TINY["N_SUBJECTS"] * n_unique}.items():
            mp.setattr(jfixture, k, v)
        meta = jfixture.ensure_fixture()
        mp.setenv("NSD_DATA_DIR", str(Path(meta["pickle"]).parent))
        mp.setenv("VISREPS_INIT_CACHE", "0")

        state = jax_init_model("AlexNet", 1000, seed=1, cache=False)
        mp.setattr(jevals, "load_model", lambda cfg, verbose=False: state)
        mp.setattr(jneural, "NSD_STIMULI_HDF5", meta["hdf5"])
        mp.setattr(jdb, "RESULTS_DB_PATH", tmp / "jax.db")
        mp.setattr(jevals, "RESULTS_DB_PATH", tmp / "jax.db")
        jax_get_activations = JaxExtractor.get_activations

        def keep_jax_store(self, *args, **kwargs):
            acts, ids = jax_get_activations(self, *args, **kwargs)
            stores["jax"] = ({n: np.asarray(a, np.float32) for n, a in acts.items()}, list(ids))
            return acts, ids

        mp.setattr(JaxExtractor, "get_activations", keep_jax_store)
        jax_results = jevals.eval(JaxConfig(_eval_cfg(srp_k)))

        params = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))

        def load_model(cfg, device=None):
            model = AlexNet()
            model.load_state_dict(params)
            return model.to(device).eval()

        configure = tevals.configure_feature_extractor

        def configure_on_jax_store(cfg, model, device=None, verbose=False):
            ext = configure(cfg, model, device=device, verbose=verbose)
            own_get_activations = ext.get_activations

            def select_on_jax_store(loader, store="device", retain_ids=None):
                acts, ids = own_get_activations(loader, store=store, retain_ids=retain_ids)
                stores["torch_store"] = store
                jacts, jids = stores["jax"]
                assert [str(i) for i in ids] == [str(i) for i in jids]
                return {n: torch.from_numpy(jacts[n]).to(acts[n].device, acts[n].dtype)
                        for n in acts}, ids

            ext.get_activations = select_on_jax_store
            return ext

        mp.setattr(tevals, "load_model", load_model)
        mp.setattr(tevals, "configure_feature_extractor", configure_on_jax_store)
        mp.setenv("NSD_STIMULI_HDF5", meta["hdf5"])
        mp.setattr(tdb, "RESULTS_DB_PATH", tmp / "torch.db")
        overrides = [f"{k}={json.dumps(v)}" for k, v in _eval_cfg(srp_k).items() if k != "mode"]
        torch_results = trun.main(["--mode", "eval", "--device", "cpu", "--config",
                                   str(REPO / "configs/eval/base.json"), "--override",
                                   *overrides])
        phases = dict(tevals.LAST_PHASE_TIMES)
        mp.setattr(tdb, "RESULTS_DB_PATH", tmp / "per_pair.db")
        per_pair = tevals.eval(Config({**_eval_cfg(srp_k), "encoding_batched": False}),
                               device="cpu")
        yield {"jax": jax_results, "torch": torch_results, "per_pair": per_pair,
               "phases": phases, "tmp": tmp, "store": stores["torch_store"],
               "n_train": n_unique, "srp_k": srp_k}
    finally:
        mp.undo()


def _db(path):
    with sqlite3.connect(str(path)) as conn:
        return conn.execute("SELECT region, subject_idx, analysis, compare_method, layer, score "
                            "FROM results ORDER BY region, subject_idx").fetchall()


class TestEvalParity:
    def test_route(self, both_evals):
        n_fit = int(0.8 * both_evals["n_train"])
        expect = "woodbury" if both_evals["srp_k"] == 16 else "eigh"
        assert tridge._woodbury_ok(n_fit, both_evals["srp_k"], 5) == (expect == "woodbury")
        assert both_evals["store"] == "host"

    def test_results_and_db_rows(self, both_evals):
        jax_results, torch_results = both_evals["jax"], both_evals["torch"]
        assert len(torch_results) == len(jax_results) == 4
        jrows, trows = _db(both_evals["tmp"] / "jax.db"), _db(both_evals["tmp"] / "torch.db")
        assert len(trows) == len(jrows) == 4
        for t, j in zip(trows, jrows):
            assert t[:5] == j[:5] and t[2:4] == ("encoding_score", "pearson")
            assert t[5] == pytest.approx(j[5], abs=RTOL)
        assert set(both_evals["phases"]) == {
            "model_load_s", "data_load_s", "extraction_s", "extraction_loader_s", "encoding_s",
            "encoding_selection_s", "encoding_refit_s", "encoding_assemble_bootstrap_s"}

    def test_scores(self, both_evals):
        for t, j in zip(both_evals["torch"], both_evals["jax"]):
            assert len(t["layer_selection_scores"]) == 14
            _same_result(t, j, N_BOOT)

    def test_per_pair_path_matches_batched(self, both_evals):
        """encoding_batched=false: region-major results, one row each,
        equal to the batched path's (subject-major) results."""
        batched = both_evals["torch"]
        per_pair = both_evals["per_pair"]
        assert len(per_pair) == 4 and len(_db(both_evals["tmp"] / "per_pair.db")) == 4
        order = [0, 2, 1, 3]  # (region, subject) ← (subject, region)
        for got, ref in zip(per_pair, [batched[i] for i in order]):
            assert got["layer"] == ref["layer"]
            for key in ("score", "ci_low", "ci_high"):
                assert got[key] == pytest.approx(ref[key], abs=2e-4)
            np.testing.assert_allclose([e["score"] for e in got["layer_selection_scores"]],
                                       [e["score"] for e in ref["layer_selection_scores"]],
                                       atol=2e-3)
