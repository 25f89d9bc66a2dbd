"""The PyTorch port's cross-model RDM comparison against the JAX package,
on the CPU: ``run`` with the tiny CLIP and DINOv2 towers on
``synthetic:30`` in both packages, the JAX towers' weights and SRP
matrices carried across, so the npz payloads must agree: the same keys,
layer lists and summary pairs, every RDM within 5e-4 and every ``corr__``
matrix within 1e-4. The SRP rounds its input to bf16, so a tap value that
the two packages compute ~1e-6 apart can round to neighbouring bf16
values (2⁻⁸ relative): the narrow patch_embed RDMs part by up to 1.6e-4
(the deeper ones by < 1e-5), and the Spearman scores over their 435
triangle values by up to 5e-5. Also
``cross_model_matrix`` against pairwise ``compute_rdm_correlation``, the
stimuli, model resolution, and the CLI's exit code when a model fails.
"""
import numpy as np
import pytest
import torch

import jax

from visreps_tpu.analysis import cross_model_rdms as jcm
from visreps_tpu.ops.srp import SRPTransform as JaxSRP

from visreps_tpu_torch.analysis import cross_model_rdms as tcm
from visreps_tpu_torch.models.convert import params_from_jax, srp_from_jax
from visreps_tpu_torch.models.extractor import FeatureExtractor
from visreps_tpu_torch.ops.rdm import compute_rdm_correlation

IMG = 32
SRP_K = 64
N_STIMULI = 30
TOWERS = ["clip-vit-l14", "dinov2-l14"]
RDM_TOL = 5e-4
CORR_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cross_model")
    jax_out = jcm.run(TOWERS, f"synthetic:{N_STIMULI}", str(tmp / "jax.npz"), srp_k=SRP_K,
                      batch_size=8, image_size=IMG, pretrained=False, tiny_towers=True,
                      save_rdms=True)
    mp = pytest.MonkeyPatch()
    resolve = tcm.resolve_model

    def with_jax_weights(name, pretrained, image_size, tiny_towers=False, device=None):
        model, nodes = resolve(name, pretrained, image_size, tiny_towers, device)
        state, _ = jcm.resolve_model(name, pretrained, image_size, tiny_towers)
        model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, state.params)))
        return model, nodes

    def with_jax_srp(model, nodes, **kwargs):
        ext = FeatureExtractor(model, nodes, **kwargs)
        jax_srp = JaxSRP(k=kwargs["srp_k"], seed=0)
        srp_from_jax(ext.srp, {d: tuple(np.asarray(c, np.float32) for c in jax_srp.matrix_chunks(d))
                               for d in set(ext.tap_dims.values())})
        return ext

    mp.setattr(tcm, "resolve_model", with_jax_weights)
    mp.setattr(tcm, "FeatureExtractor", with_jax_srp)
    try:
        torch_out = tcm.run(TOWERS, f"synthetic:{N_STIMULI}", str(tmp / "torch.npz"),
                            srp_k=SRP_K, batch_size=8, image_size=IMG, pretrained=False,
                            tiny_towers=True, save_rdms=True, device="cpu")
    finally:
        mp.undo()
    return jax_out, torch_out, tmp


class TestRunParity:
    def test_same_keys_layers_and_summary(self, both_runs):
        jax_out, torch_out, tmp = both_runs
        assert set(torch_out) == set(jax_out)
        assert sum(k.startswith("corr__") for k in torch_out) == 3
        assert "model_errors" not in torch_out
        for m in TOWERS:
            assert list(torch_out[f"layers__{m}"]) == list(jax_out[f"layers__{m}"])
            assert list(torch_out[f"layers__{m}"]) == ["patch_embed", "block1", "block2",
                                                       "pooled"]
        assert str(torch_out["method"]) == "spearman"
        assert [tuple(r[:2]) for r in torch_out["summary"]] == [tuple(r[:2])
                                                                for r in jax_out["summary"]]
        saved = np.load(tmp / "torch.npz", allow_pickle=True)
        assert set(saved.files) == set(torch_out)

    def test_rdms_match(self, both_runs):
        jax_out, torch_out, _ = both_runs
        keys = [k for k in jax_out if k.startswith("rdm__")]
        assert len(keys) == 8
        for k in keys:
            assert torch_out[k].shape == (N_STIMULI, N_STIMULI)
            np.testing.assert_allclose(torch_out[k], jax_out[k], atol=RDM_TOL, rtol=0, err_msg=k)

    def test_corr_matrices_match(self, both_runs):
        jax_out, torch_out, _ = both_runs
        for k in (k for k in jax_out if k.startswith("corr__")):
            assert torch_out[k].shape == jax_out[k].shape == (4, 4)
            np.testing.assert_allclose(torch_out[k], jax_out[k], atol=CORR_TOL, rtol=0,
                                       err_msg=k)
            if k.split("__")[1] == k.split("__")[2]:
                np.testing.assert_allclose(np.diag(torch_out[k]), 1.0, atol=1e-6)

    def test_model_times_recorded(self, both_runs):
        assert set(tcm.LAST_MODEL_TIMES) == set(TOWERS)
        assert all(t > 0 for t in tcm.LAST_MODEL_TIMES.values())


class TestPieces:
    @pytest.mark.parametrize("method", ["spearman", "pearson", "kendall"])
    def test_matrix_is_pairwise_correlation(self, method):
        rng = np.random.RandomState(0)

        def rdm():
            a = rng.rand(12, 12).astype(np.float32)
            a = a + a.T
            np.fill_diagonal(a, 0.0)
            return torch.from_numpy(a)

        rdms_a = {f"a{i}": rdm() for i in range(3)}
        rdms_b = {f"b{i}": rdm() for i in range(2)}
        mat = tcm.cross_model_matrix(rdms_a, rdms_b, method)
        want = np.array([[compute_rdm_correlation(x, y, method) for y in rdms_b.values()]
                         for x in rdms_a.values()])
        assert mat.shape == (3, 2)
        np.testing.assert_allclose(mat, want, atol=1e-6, rtol=0)

    def test_stimuli_match_jax(self, tmp_path):
        want = jcm.build_stimuli("synthetic:5", IMG)
        got = tcm.build_stimuli("synthetic:5", IMG)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        for name in ("b.png", "a.jpg"):
            (tmp_path / name).write_bytes(b"")
        assert tcm.build_stimuli(str(tmp_path), IMG) == jcm.build_stimuli(str(tmp_path), IMG)

    def test_resolve_torchvision_models(self):
        _, nodes = tcm.resolve_model("AlexNet", False, 224, device="cpu")
        state, jnodes = jcm.resolve_model("AlexNet", False, 224)
        assert nodes == jnodes
        with pytest.raises(ValueError):  # as in the JAX package: names are case-sensitive
            tcm.resolve_model("alexnet", False, 224, device="cpu")
        with pytest.raises(ValueError):
            jcm.resolve_model("alexnet", False, 224)

    def test_tiny_towers_follow_the_seed(self):
        a, nodes = tcm.resolve_model("dinov2-l14", False, IMG, tiny_towers=True, device="cpu")
        b, _ = tcm.resolve_model("dinov2-l14", False, IMG, tiny_towers=True, device="cpu")
        assert nodes == ["patch_embed", "block1", "block2", "pooled"]
        assert a.hidden == 32 and a.num_layers == 2
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                     b.state_dict().values()))


class TestCLI:
    def _argv(self, tmp_path, models):
        return ["--models", *models, "--stimuli", "synthetic:6", "--image-size", str(IMG),
                "--srp-k", "16", "--batch-size", "4", "--tiny-towers", "--random-init",
                "--device", "cpu", "--out", str(tmp_path / "out.npz")]

    def test_exit_1_when_a_model_fails(self, tmp_path):
        assert tcm.main(self._argv(tmp_path, ["clip-vit-l14", "NoSuchNet"])) == 1
        out = np.load(tmp_path / "out.npz", allow_pickle=True)
        assert [str(e).split(":")[0] for e in out["model_errors"]] == ["NoSuchNet"]
        assert "corr__clip-vit-l14__clip-vit-l14" in out.files

    def test_exit_0_when_all_succeed(self, tmp_path):
        assert tcm.main(self._argv(tmp_path, TOWERS)) == 0
        out = np.load(tmp_path / "out.npz", allow_pickle=True)
        assert "model_errors" not in out.files
        assert sum(k.startswith("corr__") for k in out.files) == 3

    def test_needs_a_card_unless_cpu_is_asked(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the no-card rule cannot be observed")
        argv = self._argv(tmp_path, TOWERS)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcm.main(argv[:argv.index("--device")] + argv[argv.index("--device") + 2:])
