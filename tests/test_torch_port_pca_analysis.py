"""The port's PCA analyses (``visreps_tpu_torch/experiments/pca_analysis/``)
and the fig. 1a schematic against the JAX package's, on the CPU.

PC poles: 600 × 64 f32 features with a planted spectrum — the top 7
eigenvalues of their correlation matrix (what the z-scored covariance
holds) lie ≥ 18 % apart, so the 6 PCs are well posed. Scores are held
within 1e-5 of the largest |score| up to one sign per PC (LAPACK and XLA
may each negate a PC; the port does not fix signs), and the pole sets
up to that sign and up to swaps between scores within 1e-6 relative at
a pole's edge. The other CLIs are host numpy in both packages: arrays
equal to the bit, data files equal."""
import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from experiments.neurips_2025.fig1 import imagenet_pca_schematic as jsch
from experiments.pca_analysis import pca_poles_images as jpoles
from experiments.pca_analysis import pca_visualization as jvis
from experiments.pca_analysis import visualize_class_distribution as jdist

from visreps_tpu_torch.experiments.neurips_2025.fig1 import imagenet_pca_schematic as tsch
from visreps_tpu_torch.experiments.pca_analysis import pca_poles_images as tpoles
from visreps_tpu_torch.experiments.pca_analysis import pca_visualization as tvis
from visreps_tpu_torch.experiments.pca_analysis import visualize_class_distribution as tdist

SCORE_TOL = 1e-5   # of the largest |score|, per PC, up to sign
TIE_TOL = 1e-6     # relative: a pole may swap images whose scores are this close


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (see test_torch_port_cg_benefits)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def planted(n=600, d=64, seed=0) -> np.ndarray:
    """Features whose correlation matrix has 7 well-separated top
    eigenvalues, on columns of different scales and offsets."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(d, d))
    s = np.r_[[12, 9, 7, 5.5, 4.3, 3.4, 2.7], np.full(d - 7, 0.4)]
    z = rng.randn(n, d)
    z = (z - z.mean(0)) / z.std(0)
    x = (z * s) @ q.T
    return (x * rng.uniform(0.5, 2.0, d) + rng.uniform(-1, 1, d)).astype(np.float32)


def names_for(n: int) -> list:
    return [f"n{k % 12:08d}_{k}.JPEG" for k in range(n)]


def test_planted_spectrum_is_well_posed():
    ev = np.sort(np.linalg.eigvalsh(np.corrcoef(planted().astype(np.float64), rowvar=False)))
    top = ev[::-1][:8]
    assert ((top[:7] - top[1:]) / top[:7]).min() > 0.18


def _signs(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Per PC, +1 or −1: the sign that brings ``got`` onto ``want``."""
    return np.where(np.sum(got * want, axis=0) >= 0, 1.0, -1.0)


def _check_scores(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    signs = _signs(got, want)
    err = np.abs(got * signs - want).max(axis=0) / np.abs(want).max(axis=0)
    assert err.max() <= SCORE_TOL, err
    return signs


def _check_poles(rows_t, rows_j, scores_j, signs, n_poles):
    """Each (pc, pole) image set of the port equals the JAX one's under
    the PC's sign (a negated PC swaps low and high), up to swaps between
    scores within TIE_TOL of the pole's edge score."""
    def sets(rows):
        out = {}
        for r in rows:
            out.setdefault((r["pc"], r["pole"]), []).append(r["image_file"])
        return out

    st, sj = sets(rows_t), sets(rows_j)
    index = {name: i for i, name in enumerate(names_for(len(scores_j)))}
    for (pc, pole), imgs in st.items():
        assert len(imgs) == n_poles
        jpole = pole if signs[pc - 1] > 0 else {"low": "high", "high": "low"}[pole]
        want = sj[(pc, jpole)]
        col = scores_j[:, pc - 1]
        edge = col[index[want[-1]]]
        for img in set(imgs) ^ set(want):
            assert abs(col[index[img]] - edge) <= TIE_TOL * np.abs(col).max(), (pc, pole, img)
    assert set(st) == set(sj)


class TestPoles:
    @pytest.mark.parametrize("n_fit", [110000, 200])
    def test_scores_and_poles(self, n_fit):
        x = planted()
        got = tpoles.compute_pc_scores(x, n_fit=n_fit, device="cpu")
        want = np.asarray(jpoles.compute_pc_scores(x, n_fit=n_fit))
        signs = _check_scores(got, want)
        mapping = {f"n{k:08d}": f"class {k}" for k in range(12)}
        rows_t = tpoles.analyze_pc_poles(got, names_for(len(x)), mapping, 25)
        rows_j = jpoles.analyze_pc_poles(want, names_for(len(x)), mapping, 25)
        assert len(rows_t) == len(rows_j) == 6 * 2 * 25
        _check_poles(rows_t, rows_j, want, signs, 25)
        fit = tpoles.fit_pcs(x, n_fit=n_fit, device="cpu")
        assert fit["n_fit"] == min(n_fit, len(x)) and set(fit["seconds"]) == {
            "fit_rows", "gram", "eigh"}
        ev = np.linalg.eigvalsh(np.corrcoef(x[np.random.RandomState(42).choice(
            len(x), fit["n_fit"], replace=False)].astype(np.float64), rowvar=False))[::-1][:6]
        n = fit["n_fit"]  # ddof-0 z-scores over n − 1: the correlation matrix × n / (n − 1)
        np.testing.assert_allclose(fit["eigenvalues"].numpy(), ev * n / (n - 1), rtol=1e-5)

    def test_the_fit_rows_are_numpys_draw(self, monkeypatch):
        """The port projects in chunks; the fit rows are the numpy draw."""
        x = planted()
        monkeypatch.setattr(tpoles, "PROJECT_CHUNK", 64)
        chunked = tpoles.compute_pc_scores(x, n_fit=300, device="cpu")
        monkeypatch.setattr(tpoles, "PROJECT_CHUNK", 65536)
        whole = tpoles.compute_pc_scores(x, n_fit=300, device="cpu")
        np.testing.assert_allclose(chunked, whole, rtol=0, atol=1e-6 * np.abs(whole).max())
        fit = np.random.RandomState(42).choice(len(x), 300, replace=False)
        refit = tpoles.compute_pc_scores(x[fit], n_fit=300, seed=42, device="cpu")
        assert np.abs(refit).max() > 0  # a permutation of the same rows fits the same PCs
        _check_scores(whole[fit], refit)

    def test_main(self, tmp_path, monkeypatch):
        x = planted()
        ds = tmp_path / "datasets" / "obj_cls" / "imagenet"
        ds.mkdir(parents=True)
        np.savez(ds / "features_toy.npz", fc2=x,
                 image_names=np.array([f"/imgs/{n}" for n in names_for(len(x))]))
        (tmp_path / "map_clsloc.txt").write_text(
            "".join(f"n{k:08d} {k + 1} class_{k}\n" for k in range(12)))
        monkeypatch.setenv("IMAGENET_DATA_DIR", str(tmp_path))
        monkeypatch.chdir(tmp_path)
        out = tpoles.main(["--features_filename", "features_toy.npz", "--n_poles", "20",
                           "--device", "cpu"])
        assert out == "datasets/obj_cls/imagenet/pca_poles/pca_poles_toy.csv"
        rows_t = list(csv.DictReader(open(out)))
        jpoles.main(["--features_filename", "features_toy.npz", "--n_poles", "20"])
        rows_j = list(csv.DictReader(open(out)))
        assert list(rows_t[0]) == ["pc", "pole", "score", "image_file", "image_class_id",
                                   "image_class"]
        for rows in (rows_t, rows_j):
            for r in rows:
                r["pc"] = int(r["pc"])
                k = int(r["image_class_id"][1:])
                assert r["image_class"] == f"{k + 1} class_{k}"
        scores_j = np.asarray(jpoles.compute_pc_scores(x))
        signs = _signs(tpoles.compute_pc_scores(x, device="cpu"), scores_j)
        _check_poles(rows_t, rows_j, scores_j, signs, 20)

    def test_needs_a_card_unless_cpu_is_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpoles.compute_pc_scores(planted(60, 8))


class TestVisualization:
    @pytest.fixture
    def inputs(self, tmp_path):
        x = planted(400, 32, seed=3).astype(np.float32)
        names = names_for(len(x))
        np.savez(tmp_path / "features.npz", fc2=x,
                 image_names=np.array([n.encode() for n in names]))
        xc = x.astype(np.float64) - x.mean(0)
        vecs = np.linalg.eigh(xc.T @ xc)[1][:, ::-1][:, :20]
        np.savez(tmp_path / "eig.npz", eigenvectors=vecs.astype(np.float32),
                 mean=x.mean(0))
        labels = tmp_path / "labels"
        labels.mkdir()
        with open(labels / "n_classes_4.csv", "w") as f:
            f.write("image,pca_label\n")
            f.writelines(f"{n},{k % 4}\n" for k, n in enumerate(names))
        return tmp_path

    def test_scores_and_data_files(self, inputs):
        args = (str(inputs / "features.npz"), str(inputs / "eig.npz"),
                str(inputs / "labels" / "n_classes_4.csv"))
        st, lt = tvis.load_scores_and_labels(*args)
        sj, lj = jvis.load_scores_and_labels(*args)
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(lt, lj)
        assert st.shape == (20, 4)
        argv = ["--features", args[0], "--eigenvectors", args[1],
                "--labels_dir", str(inputs / "labels"), "--n_classes", "4"]
        tvis.main(argv + ["--out_dir", str(inputs / "t")])
        jvis.main(argv + ["--out_dir", str(inputs / "j")])
        data = np.load(inputs / "t" / "pca_pc1pc2_4classes.npz")
        np.testing.assert_array_equal(data["scores"], sj)
        np.testing.assert_array_equal(data["labels"], lj)
        dens = json.loads((inputs / "t" / "pca_1d_distributions.json").read_text())
        for i in range(4):
            d, e = np.histogram(sj[:, i], bins=80, density=True)
            assert dens[f"PC{i + 1}"]["density"] == d.tolist()
            assert dens[f"PC{i + 1}"]["edges"] == e.tolist()
        for name in ("pca_pc1pc2_4classes.png", "pca_1d_distributions.png"):
            assert (inputs / "t" / name).is_file() and (inputs / "j" / name).is_file()


class TestClassDistribution:
    def test_counts_and_data(self, tmp_path, capsys):
        rng = np.random.RandomState(2)
        labels = rng.zipf(1.6, 3000) % 64
        path = tmp_path / "n_classes_64.csv"
        with open(path, "w") as f:
            f.write("image,pca_label\n")
            f.writelines(f"img{i}.JPEG,{v}\n" for i, v in enumerate(labels))
        np.testing.assert_array_equal(tdist.class_counts_from_csv(str(path)),
                                      jdist.class_counts_from_csv(str(path)))
        got = tdist.main(["--labels", str(path), "--out", str(tmp_path / "t.png")])
        tline = capsys.readouterr().out.splitlines()[-1]
        want = jdist.main(["--labels", str(path), "--out", str(tmp_path / "j.png")])
        assert tline == capsys.readouterr().out.splitlines()[-1].replace("j.png", "t.png")
        np.testing.assert_array_equal(got, want)
        data = json.loads((tmp_path / "t.json").read_text())
        assert data["counts"] == want.tolist() and sum(data["counts"]) == 3000
        n_show = min(16, len(want) // 2)
        assert data["top"] == want[:n_show].tolist() and data["bottom"] == want[-n_show:].tolist()
        assert sum(data["histogram"]) == len(want)
        assert data["summary"].startswith(f"{len(want):,} classes  ·  3,000 images")
        assert (tmp_path / "t.png").is_file() and (tmp_path / "j.png").is_file()


class TestSchematic:
    def test_points_and_data(self, tmp_path):
        data = tsch.schematic_data()
        x, y = jsch.make_synthetic()
        x2 = jsch.pca_2d(x)
        np.testing.assert_array_equal(data["points"], x2)
        np.testing.assert_array_equal(data["labels"], y)
        np.testing.assert_array_equal(data["medians"], [np.median(x2[:, 0]),
                                                        np.median(x2[:, 1])])
        tsch.main(["--out", str(tmp_path / "t.png")])
        jsch.main(["--out", str(tmp_path / "j.png")])
        saved = np.load(tmp_path / "t.npz")
        for k, v in data.items():
            np.testing.assert_array_equal(saved[k], v)
        assert np.bincount(saved["quadrant"]).sum() == len(y)
        assert (tmp_path / "t.png").is_file() and (tmp_path / "j.png").is_file()
