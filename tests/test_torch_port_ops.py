"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages;
the port runs on CPU tensors, so its RDM goes through the kernel's plain
version (ops/rdm_kernel.rdm_from_centered_reference).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visreps_tpu.analysis.rsa import _select_scores_multipair
from visreps_tpu.ops import bootstrap as jboot
from visreps_tpu.ops import rdm as jrdm
from visreps_tpu.ops import srp as jsrp
from visreps_tpu.ops import stats as jstats
from visreps_tpu.ops.rdm_pallas import compute_rdm_pallas
from visreps_tpu_torch.analysis.rsa import select_best_layer, select_scores_multipair
from visreps_tpu_torch.models.convert import srp_from_jax
from visreps_tpu_torch.ops import bootstrap as tboot
from visreps_tpu_torch.ops import rdm as trdm
from visreps_tpu_torch.ops import rdm_kernel
from visreps_tpu_torch.ops import srp as tsrp
from visreps_tpu_torch.ops import stats as tstats


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(kind: str) -> np.ndarray:
    rng = np.random.RandomState(1)
    if kind == "random":
        return rng.randn(40, 30).astype(np.float32)
    if kind == "tied":
        return rng.randint(0, 3, (30, 20)).astype(np.float32)
    x = rng.randn(24, 16).astype(np.float32)
    if kind == "clamped":  # exact ±1 correlations, which the clamp pins
        x[1] = 2.0 * x[0] + 1.0
        x[2] = -x[0]
        x[3] = x[0]
    elif kind == "zero_variance":
        x[0] = 0.0
        x[5] = 3.5
    return x


def _as_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _centered(x: np.ndarray, correction: float = 1e-12):
    """compute_rdm's row preparation, for feeding the kernel directly."""
    t = torch.from_numpy(x)
    xc = t - t.mean(dim=1, keepdim=True)
    std = torch.sqrt((xc * xc).mean(dim=1) + correction)
    return xc, torch.where(std < correction * 10, torch.ones_like(std), std)


class TestComputeRDM:
    @pytest.mark.parametrize("kind", ["random", "tied", "clamped", "zero_variance"])
    @pytest.mark.parametrize("correlation", ["pearson", "spearman"])
    def test_matches_jax(self, kind, correlation):
        x = _rows(kind)
        ref = np.asarray(jrdm.compute_rdm(x, correlation=correlation))
        got = _as_np(trdm.compute_rdm(torch.from_numpy(x), correlation=correlation))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_upper_triangle_order(self):
        x = np.arange(36, dtype=np.float32).reshape(6, 6)
        np.testing.assert_array_equal(_as_np(trdm.upper_triangle(torch.from_numpy(x))),
                                      np.asarray(jrdm.upper_triangle(x)))

    def test_tie_count(self):
        for kind in ("random", "clamped"):
            x = _rows(kind)
            assert trdm.triangle_tie_count(trdm.compute_rdm(torch.from_numpy(x))) == \
                int(jrdm.triangle_tie_count(jrdm.compute_rdm(x)))

    def test_rejects_unknown_correlation(self):
        with pytest.raises(ValueError):
            trdm.compute_rdm(torch.zeros(3, 3), correlation="kendall")


class TestKernelPlainVersion:
    """The kernel's plain version against the Pallas kernel it replaces,
    run in Pallas interpret mode as tests/test_rdm_pallas.py runs it."""

    @pytest.mark.parametrize("n,d", [(64, 128), (130, 513)])
    def test_f32_matches_pallas(self, rng, n, d):
        x = rng.randn(n, d).astype(np.float32)
        ref = np.asarray(compute_rdm_pallas(x, interpret=True, bf16=False,
                                            block_n=64, block_k=128))
        xc, std = _centered(x)
        got = _as_np(rdm_kernel.rdm_from_centered_reference(xc, std))
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_bf16_close_to_pallas(self, rng):
        x = rng.randn(200, 400).astype(np.float32)
        ref = np.asarray(compute_rdm_pallas(x, interpret=True, bf16=True,
                                            block_n=64, block_k=128))
        xc, std = _centered(x)
        got = _as_np(rdm_kernel.rdm_from_centered_reference(xc.to(torch.bfloat16), std))
        assert np.abs(got - ref).max() < 3e-3

    def test_diagonal_zero_and_symmetric(self, rng):
        x = rng.randn(96, 100).astype(np.float32)
        got = _as_np(rdm_kernel.rdm_from_centered_reference(*_centered(x)))
        np.testing.assert_allclose(np.diag(got), 0.0, atol=1e-6)
        np.testing.assert_allclose(got, got.T, atol=1e-5)

    def test_cpu_tensors_take_the_plain_version(self, rng):
        xc, std = _centered(rng.randn(10, 7).astype(np.float32))
        before = rdm_kernel.LAUNCHES
        got = rdm_kernel.rdm_from_centered(xc, std)
        assert rdm_kernel.LAUNCHES == before  # counts kernel launches only
        np.testing.assert_array_equal(_as_np(got),
                                      _as_np(rdm_kernel.rdm_from_centered_reference(xc, std)))

    def test_other_devices_raise(self):
        xc = torch.zeros((4, 3), device="meta")
        with pytest.raises(ValueError):
            rdm_kernel.rdm_from_centered(xc, torch.ones(4, device="meta"))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does: add half an ulp to the
    magnitude bits, then clear the 13 dropped bits."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rdm_3xtf32(xc: torch.Tensor, std: torch.Tensor, correction: float = 1e-12,
                part: int = 512) -> torch.Tensor:
    """The kernel's f32 arithmetic in plain torch: hi = tf32(x),
    lo = tf32(x − hi), lo·hiᵀ + hi·loᵀ + hi·hiᵀ per 512 of d, each part
    added into an f32 total, then compute_rdm's epilogue."""
    hi = _tf32(xc)
    lo = _tf32(xc - hi)
    total = torch.zeros((xc.shape[0],) * 2, dtype=torch.float32)
    for k in range(0, xc.shape[1], part):
        h, l = hi[:, k:k + part], lo[:, k:k + part]
        total += l @ h.T + h @ l.T + h @ h.T
    corr = (total / xc.shape[1] / (std[:, None] * std[None, :] + correction)).clamp(-1.0, 1.0)
    corr.fill_diagonal_(1.0)
    return 1.0 - corr


class TestKernelPlanAndLayout:
    """What surrounds the CUDA kernel, in Python the CPU reaches: the
    launch plan, the padding of rows to TMA's 16-byte stride, the
    wrapper's checks, and the 3xTF32 arithmetic of its f32 route."""

    SHAPES = [(1000, 4096), (1000, 193600), (1000, 512), (1000, 1000), (10000, 4096),
              (257, 1031), (129, 1), (1900, 193600), (40, 2048),
              # THINGS, TVSD and NSD-Synthetic: n below one tile, d narrower than a split
              (100, 4096), (100, 193600), (100, 256), (100, 1031), (220, 512), (370, 4096),
              (1484, 66), (1484, 193600)]
    SMS = 132  # an H100 SXM; on the card the wrapper passes the device's own count

    @pytest.mark.parametrize("n,d", SHAPES)
    @pytest.mark.parametrize("element_size", [4, 2])
    def test_plan_covers_upper_tiles_and_d(self, n, d, element_size):
        p = rdm_kernel.plan(n, d, element_size, self.SMS)
        stage = 128 // element_size
        tiles = rdm_kernel.upper_tiles(p.tiles_per_side)
        assert p.grid == (len(tiles), p.splits) and p.n_pad >= n > p.n_pad - 128
        # every upper tile (row <= col) exactly once, and no lower tile
        assert sorted(tiles) == [(r, c) for r in range(p.tiles_per_side)
                                 for c in range(p.tiles_per_side) if r <= c]
        # the splits cover [0, d) without overlap or gap
        b = p.split_bounds
        assert len(b) == p.splits + 1 and b[0] == 0 and b[-1] == d
        assert all(lo < hi for lo, hi in zip(b, b[1:]))
        assert p.stage_bounds[-1] == -(-d // stage)
        assert all(x % stage == 0 for x in b[:-1])
        if p.splits > 1:
            assert all(hi - lo >= 512 for lo, hi in zip(b, b[1:]))
            assert p.workspace == (p.splits, p.n_pad, p.n_pad)
        else:
            assert p.workspace is None
        if len(tiles) >= self.SMS:  # the tiles alone reach a wave of SMs
            assert p.splits == 1

    @pytest.mark.parametrize("sms", [132, 114])
    def test_plan_fills_the_card_at_n_1000(self, sms):
        p = rdm_kernel.plan(1000, 193600, 4, sms)
        assert p.tiles == 36 and p.sms == sms
        # whole waves of this card's SMs, or within one block of them
        assert -p.tiles * p.splits % sms < p.tiles
        assert rdm_kernel.plan(1000, 4096, 4, sms).splits > 1
        if sms == 132:
            assert p.tiles * p.splits % sms == 0  # 11 splits: 3 full waves

    @pytest.mark.parametrize("d,splits", [(4096, 8), (193600, 16), (1031, 2), (256, 1),
                                          (66, 1)])
    def test_plan_below_one_tile(self, d, splits):
        """n = 100 (TVSD's test set): one 128-row tile, taller than the
        tensor (TMA fills rows 100..127 with zeros and the stores are
        masked), the d splits filling as many SMs as d allows."""
        p = rdm_kernel.plan(100, d, 4, self.SMS)
        assert (p.tiles, p.n_pad, p.grid, p.splits) == (1, 128, (1, splits), splits)
        assert p.workspace == (None if splits == 1 else (splits, 128, 128))

    @pytest.mark.parametrize("d", [1031, 1, 66])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_padding_keeps_the_rdm(self, rng, d, dtype):
        xc, std = _centered(rng.randn(33, d).astype(np.float32))
        xc = xc.to(dtype)
        padded = rdm_kernel.pad_rows(xc)
        assert padded.shape[1] * padded.element_size() % 16 == 0
        assert padded.data_ptr() % 16 == 0 and padded.shape[1] > d
        # the tensor map spans d columns of rows padded.shape[1] apart: that view
        assert torch.equal(padded[:, :d], xc)
        np.testing.assert_allclose(
            _as_np(rdm_kernel.rdm_from_centered_reference(padded[:, :d], std)),
            _as_np(rdm_kernel.rdm_from_centered_reference(xc, std)), atol=1e-6)

    def test_padding_leaves_aligned_rows_and_fixes_a_misaligned_base(self):
        xc = torch.randn(8, 64)
        assert rdm_kernel.pad_rows(xc) is xc
        shifted = torch.randn(8 * 64 + 1)[1:].view(8, 64)  # base 4 bytes off
        fixed = rdm_kernel.pad_rows(shifted)
        assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed[:, :64], shifted)

    def test_3xtf32_emulation_matches_jax(self):
        rng = np.random.RandomState(7)
        x = (rng.randn(64, 193600) + 0.5 * rng.randn(1, 193600)).astype(np.float32)
        ref = np.asarray(jrdm.compute_rdm(x))
        got = _as_np(_rdm_3xtf32(*_centered(x)))
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_tf32_rounding(self):
        x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-12, -(1.0 + 2.0**-11),
                          1.0 + 2.0**-12])
        # ties round away from zero; 10 mantissa bits survive
        assert _tf32(x).tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0]
        assert not (_tf32(torch.randn(100)).view(torch.int32) & 0x1FFF).any()

    def test_wrapper_raises_on_inputs_it_cannot_take(self):
        xc, std = _centered(np.random.RandomState(0).randn(6, 10).astype(np.float32))
        with pytest.raises(ValueError, match="contiguous"):
            rdm_kernel.rdm_from_centered(xc.T.contiguous().T, std)
        with pytest.raises(ValueError, match="std"):
            rdm_kernel.rdm_from_centered(xc, std[:5].contiguous())
        with pytest.raises(ValueError, match="std"):
            rdm_kernel.rdm_from_centered(xc, std.double())
        with pytest.raises(ValueError, match="device"):
            rdm_kernel.rdm_from_centered(xc.to("meta"), std.to("meta"))
        with pytest.raises(ValueError, match="2-D"):
            rdm_kernel.rdm_from_centered(xc.double(), std)


class TestStats:
    @pytest.mark.parametrize("kind", ["random", "tied"])
    def test_ranks(self, kind):
        x = _rows(kind)
        np.testing.assert_array_equal(_as_np(tstats.rankdata_dense(torch.from_numpy(x), dim=1)),
                                      np.asarray(jstats.rankdata_dense(x, axis=1)))
        for row in x[:5]:
            np.testing.assert_allclose(_as_np(tstats.rankdata_average(torch.from_numpy(row))),
                                       np.asarray(jstats.rankdata_average(jnp.asarray(row))))

    @pytest.mark.parametrize("name", ["pearson_corr", "spearman_corr", "spearman_corr_dense"])
    @pytest.mark.parametrize("kind", ["random", "tied"])
    def test_correlations(self, name, kind):
        x = _rows(kind)
        a, b = x[:, 0] + x[:, 1], x[:, 2] - 0.5 * x[:, 0]
        ref = float(getattr(jstats, name)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(tstats, name)(torch.from_numpy(a), torch.from_numpy(b)))
        assert got == pytest.approx(ref, abs=1e-6)

    def test_pearson_zero_variance_is_nan(self):
        assert np.isnan(float(tstats.pearson_corr(torch.ones(5), torch.arange(5.0))))


class TestSRP:
    def test_transform_with_jax_matrix(self, rng):
        d, k = 300, 32
        x = rng.randn(6, d).astype(np.float32)
        jt = jsrp.SRPTransform(k=k, seed=3)
        ref = np.asarray(jt(jnp.asarray(x)))
        tt = tsrp.SRPTransform(k=k, seed=3, device="cpu")
        srp_from_jax(tt, {d: tuple(np.asarray(c, np.float32) for c in jt.matrix_chunks(d))})
        got = _as_np(tt(torch.from_numpy(x)))
        assert got.shape == (6, tt.out_dim(d)) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2 * np.abs(ref).max())

    def test_apply_chunked_two_chunks(self, rng):
        x = rng.randn(5, 50).astype(np.float32)
        chunks = (rng.randn(20, 8).astype(np.float32), rng.randn(30, 8).astype(np.float32))
        ref = np.asarray(jsrp.apply_chunked(
            jnp.asarray(x), tuple(jnp.asarray(c, jnp.bfloat16) for c in chunks)))
        got = _as_np(tsrp.apply_chunked(
            torch.from_numpy(x), tuple(torch.from_numpy(c).to(torch.bfloat16) for c in chunks)))
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2 * np.abs(ref).max())

    def test_own_matrix_is_seeded_sparse_sign(self):
        d, k = 400, 64
        m = tsrp.SRPTransform(k=k, seed=0, device="cpu").matrix_chunks(d)[0].float()
        again = tsrp.SRPTransform(k=k, seed=0, device="cpu").matrix_chunks(d)[0].float()
        other = tsrp.SRPTransform(k=k, seed=1, device="cpu").matrix_chunks(d)[0].float()
        assert m.shape == (d, k) and torch.equal(m, again) and not torch.equal(m, other)
        v = float(torch.tensor(np.sqrt(1.0 / ((1.0 / np.sqrt(d)) * k))).to(torch.bfloat16))
        assert set(torch.unique(m).tolist()) <= {0.0, v, -v}
        assert 0.03 < float((m != 0).float().mean()) < 0.07  # density 1/sqrt(d) = 0.05
        assert tsrp.SRPTransform(k=k, device="cpu").out_dim(10) == 10


def _neural_rdms(neural):
    return (np.stack([np.asarray(jrdm.compute_rdm(y)) for y in neural]),
            torch.stack([trdm.compute_rdm(torch.from_numpy(y)) for y in neural]))


class TestSelection:
    @pytest.mark.parametrize("method,exact", [("spearman", False), ("spearman", True),
                                              ("pearson", False)])
    def test_multipair_matches_jax(self, rng, method, exact):
        stacked = rng.randn(4, 16, 12).astype(np.float32)
        stacked[1, 3] = stacked[1, 2]  # duplicate stimulus rows: tied RDM values
        neural = [rng.randn(16, 9).astype(np.float32) for _ in range(3)]
        j_rdms, t_rdms = _neural_rdms(neural)
        ref = np.asarray(_select_scores_multipair(jnp.asarray(stacked), jnp.asarray(j_rdms),
                                                  method, exact))
        got = _as_np(select_scores_multipair([torch.from_numpy(a) for a in stacked], t_rdms,
                                             method, exact))
        assert got.shape == (3, 4)
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_select_best_layer_mixed_widths(self, rng):
        acts = {"a": rng.randn(14, 8).astype(np.float32),
                "b": rng.randn(14, 20).astype(np.float32)}
        neural = rng.randn(14, 6).astype(np.float32)
        got = select_best_layer({k: torch.from_numpy(v) for k, v in acts.items()}, neural)
        j_rdm = jrdm.compute_rdm(neural)
        for name, a in acts.items():
            ref = _select_scores_multipair(jnp.asarray(a)[None], j_rdm[None], "spearman")
            assert got[name] == pytest.approx(float(ref[0, 0]), abs=1e-5)


class TestGroupedScoring:
    def _inputs(self, rng, n=20):
        model_rdms = {}
        for layer in ("convA", "fcB"):
            a = np.round(rng.rand(n, n), 1).astype(np.float32)  # 11 levels: heavy ties
            r = np.triu(a, 1)
            model_rdms[layer] = r + r.T
        mats = {}
        for key in [("V1", 0), ("V1", 1), ("V2", 0)]:
            y = rng.randn(n, 7).astype(np.float32)
            y[4] = y[3]  # identical responses: tied neural RDM entries
            y[9] = y[3]
            mats[key] = y
        pair_layer = {("V1", 0): "convA", ("V1", 1): "fcB", ("V2", 0): "convA"}
        return model_rdms, mats, pair_layer

    def test_matches_jax_on_ties(self, rng):
        model_rdms, mats, pair_layer = self._inputs(rng)
        idx = jboot.bootstrap_indices(20, 16, seed=42)
        ref_boot, ref_point = jboot.grouped_scoring(model_rdms, mats, pair_layer, idx, chunk=5)
        got_boot, got_point = tboot.grouped_scoring(
            {k: torch.from_numpy(v) for k, v in model_rdms.items()}, mats, pair_layer, idx,
            chunk=5)
        assert list(got_boot) == list(ref_boot)
        for key in ref_boot:
            assert got_point[key] == pytest.approx(ref_point[key], abs=1e-5)
            assert got_boot[key].dtype == np.float64 and got_boot[key].shape == (16,)
            np.testing.assert_allclose(got_boot[key], ref_boot[key], atol=1e-5)

    def test_no_bootstrap_gives_point_scores_only(self, rng):
        model_rdms, mats, pair_layer = self._inputs(rng)
        idx = jboot.bootstrap_indices(20, 4, seed=42)
        _, ref_point = jboot.grouped_scoring(model_rdms, mats, pair_layer, idx)
        boot, point = tboot.grouped_scoring(
            {k: torch.from_numpy(v) for k, v in model_rdms.items()}, mats, pair_layer,
            np.zeros((0, 18), np.int32))
        assert all(b.shape == (0,) for b in boot.values())
        for key in ref_point:
            assert point[key] == pytest.approx(ref_point[key], abs=1e-5)

    def test_indices_and_ci_match(self):
        np.testing.assert_array_equal(tboot.bootstrap_indices(30, 7),
                                      jboot.bootstrap_indices(30, 7))
        s = np.random.RandomState(0).randn(100)
        assert tboot.percentile_ci(s) == jboot.percentile_ci(s)
