"""The PyTorch port's figure data without pandas against the JAX
package's figure scripts (``experiments/neurips_2025/``,
``experiments/reconstruction_analysis/plot.py``,
``experiments/binary_pc_rsa/visualize.py``,
``experiments/coarse_grain_benefits/plot_curriculum_rsa.py`` and
``plotters/plotter_utils.py``'s filters), on the CPU.

One long results CSV in ``tests/test_experiments_figs.py``'s layout,
with reconstruction rows, mixed-case layers and metrics, a blank seed
and scores, and ``pca_labels`` written three ways (True/False, 1/0, and
True/False with blanks), goes through each data function of both
packages; one results.db through module 2's queries. Every series must
equal pandas' on the same file: the same keys, order and NaN positions,
and values within 1e-12 relative (the port reads numbers with Python's
correctly rounded ``float`` and reduces them with numpy, where pandas'
C parser and its compensated group sums may differ in the last bits). Then each figure CLI runs in a subprocess where matplotlib cannot
be imported: it exits 0, names the figure it did not draw, writes its
data, and loads neither pandas nor matplotlib; and one CLI draws its PNG
here.
"""
import csv
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from experiments.binary_pc_rsa import visualize as jviz
from experiments.coarse_grain_benefits import plot_curriculum_rsa as jcur
from experiments.neurips_2025 import figutils as jfig
from experiments.neurips_2025.fig2 import reconstructed_rsa_nsd as jfig2
from experiments.neurips_2025.fig3 import full_vs_pcs_things as jfig3f
from experiments.neurips_2025.fig3 import reconstructed_rsa_things as jfig3r
from experiments.reconstruction_analysis import plot as jplot
from plotters import plotter_utils as jpu
from visreps_tpu.core.config import Config as JaxConfig
from visreps_tpu.core.db import save_results

from visreps_tpu_torch.experiments.binary_pc_rsa import visualize as tviz
from visreps_tpu_torch.experiments.coarse_grain_benefits import plot_curriculum_rsa as tcur
from visreps_tpu_torch.experiments.neurips_2025 import figutils as tfig
from visreps_tpu_torch.experiments.neurips_2025.fig2 import bar_plot_nsd as tbar2
from visreps_tpu_torch.experiments.neurips_2025.fig2 import reconstructed_rsa_nsd as tfig2
from visreps_tpu_torch.experiments.neurips_2025.fig3 import full_vs_pcs_things as tfig3f
from visreps_tpu_torch.experiments.neurips_2025.fig3 import reconstructed_rsa_things as tfig3r
from visreps_tpu_torch.experiments.reconstruction_analysis import plot as tplot

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]
REGIONS = ["early visual stream", "ventral visual stream"]
LAYERS = ["conv3", "Conv4", "fc1", "fc2"]
PCA_FLAGS = ["bool", "int", "blank"]


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    return str(path)


def _flag(pca, how, rng):
    if how == "int":
        return int(pca)
    if how == "blank" and rng.rand() < 0.05:
        return ""
    return pca


def long_rows(how: str, seed: int = 0) -> list:
    """Baseline rows (epoch 0 and 20; 1000-way and 2–64 PCA classes) and
    reconstruction rows (pca_k 1–20, a few missing) per layer, seed,
    subject and region; a blank seed, blank scores and mixed-case metric
    names among them."""
    rng = np.random.RandomState(seed)
    rows = []
    for region in REGIONS:
        for layer in LAYERS:
            for seed_ in (1, 2, 3):
                for subj in (0, 1):
                    conds = [(0, False, "", 0, 1), (20, False, "", 0, 1)]
                    conds += [(20, True, n, 0, 1) for n in (2, 4, 8, 16, 32, 64)]
                    conds += [(20, False, "", 1, k) for k in range(1, 21)
                              if (k * seed_ + len(layer)) % 7]  # a seed's missing ks
                    for epoch, pca, n, recon, k in conds:
                        rows.append(dict(
                            layer=layer, seed=seed_ if rng.rand() > 0.01 else "",
                            subject_idx=subj, epoch=epoch, region=region,
                            neural_dataset="nsd", compare_method=rng.choice(["Spearman",
                                                                             "spearman"]),
                            pca_labels=_flag(pca, how, rng), pca_n_classes=n,
                            reconstruct_from_pcs=recon, pca_k=k,
                            score=repr(float(0.05 + 0.3 * rng.rand()))
                            if rng.rand() > 0.02 else ""))
    return rows


@pytest.fixture(scope="module", params=PCA_FLAGS)
def long_csv(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("figs") / f"long_{request.param}.csv"
    return _write_csv(path, long_rows(request.param, PCA_FLAGS.index(request.param)))


RTOL = 1e-12
VALUE_COLUMNS = {"score", "mean", "std", "sem"}  # reductions; every other column is a key


def _same(got, want, rtol=RTOL):
    """NaN at the same places and the other values within ``rtol``
    (0: equal)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], rtol=rtol, atol=0)


def _frame_equal(df, table):
    """A pandas frame and a port Table: same columns, same values."""
    df = df.reset_index(drop=True)
    assert list(df.columns) == list(table.columns)
    for col in df.columns:
        if table[col].dtype.kind == "O":
            def norm(v):
                return None if isinstance(v, float) and math.isnan(v) else v
            assert [norm(v) for v in df[col].tolist()] == [norm(v) for v in table[col].tolist()]
        else:
            _same(table[col], df[col].to_numpy(dtype=float, na_value=np.nan),
                  rtol=RTOL if col in VALUE_COLUMNS else 0)


class TestLongCsv:
    def test_read_csv_types_as_pandas(self, long_csv):
        _frame_equal(pd.read_csv(long_csv), tfig.read_csv(long_csv))

    @pytest.mark.parametrize("region", REGIONS)
    def test_assemble_conditions(self, long_csv, region):
        df, t = pd.read_csv(long_csv), tfig.read_csv(long_csv)
        df = df[df["region"].str.lower() == region]
        t = t.take(tfig.eq(tfig.str_lower(t["region"]), region))
        want = jfig.assemble_conditions(df, "conv4", "conv3")
        got = tfig.assemble_conditions(t, "conv4", "conv3")
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])

    @pytest.mark.parametrize("kwargs", [
        {"epoch": 20}, {"epoch": 0, "dataset": "NSD"}, {"subject_idx": [0]},
        {"reconstruct_from_pcs": True, "pca_k": 3}, {"pca_n_classes": [64, 2], "layers": ["fc1"]},
        {"region": "early visual stream", "metric": "Spearman"}])
    def test_split_and_avg_over_seed(self, long_csv, kwargs):
        df, t = pd.read_csv(long_csv), tfig.read_csv(long_csv)
        for want, got in zip(jpu.split_and_select_df(df, **kwargs),
                             tfig.split_and_select_df(t, **kwargs)):
            _frame_equal(want, got)
            _frame_equal(jpu.avg_over_seed(want), tfig.avg_over_seed(got))

    @pytest.mark.parametrize("metric", ["Spearman", "spearman"])
    def test_prepare_series(self, long_csv, metric):
        df, t = pd.read_csv(long_csv), tfig.read_csv(long_csv)
        layers = ["conv3", "Conv4", "fc1", "fc2"]
        want = jfig3f.prepare_series(df, metric, layers)
        got = tfig3f.prepare_series(t, metric, layers)
        for w, g in zip(want[:2], got[:2]):
            assert list(g) == list(w)
            _same(list(g.values()), list(w.values()))
        assert list(got[2]) == list(want[2])
        for n in want[2]:
            assert list(got[2][n]) == list(want[2][n])
            _same(list(got[2][n].values()), list(want[2][n].values()))

    @pytest.mark.parametrize("layer", ["fc1", "conv4"])
    def test_recon_matrix_and_bands(self, long_csv, layer):
        df, t = pd.read_csv(long_csv), tfig.read_csv(long_csv)
        for region in REGIONS:
            want = jfig2.recon_matrix(df, region, layer, "Spearman")
            _same(tfig2.recon_matrix(t, region, layer, "Spearman"), want)
            assert np.isnan(want).any() and not np.isnan(want).all()
            for eqs in ({"epoch": 0}, {"epoch": 20, "pca_n_classes": 64}):
                w = jfig2.baseline_band(df, region, layer, "Spearman", **eqs)
                _same(tfig2.baseline_band(t, region, layer, "Spearman", **eqs), w)
        _same(tfig3r.recon_matrix(t, layer, "Spearman", max_k=12),
              jfig3r.recon_matrix(df, layer, "Spearman", max_k=12))
        for eqs in ({"epoch": 0}, {"epoch": 20, "pca_n_classes": 64}):
            _same(tfig3r.baseline_band(t, layer, "Spearman", **eqs),
                  jfig3r.baseline_band(df, layer, "Spearman", **eqs))


# ── module 2: results.db ────────────────────────────────────────────

@pytest.fixture(scope="module")
def results_db(tmp_path_factory):
    """Baseline, reconstruction and coarse rows of 3 datasets, written by
    the JAX package's save_results (some checkpoint_dirs NULL, ties among
    the scores so that idxmax's first maximum matters)."""
    rng = np.random.RandomState(4)
    db = tmp_path_factory.mktemp("db") / "results.db"
    spaces = (("nsd", REGIONS, [0, 1, 2]), ("tvsd", ["V1", "IT"], [0, 1]),
              ("things-behavior", ["N/A"], ["N/A"]))
    models = [(1000, False, "ck"), (2, True, "ck"), (64, True, "ck2"), (64, True, None),
              (32, True, "ck")]
    for ds, regions, subjects in spaces:
        for region in regions:
            for subj in subjects:
                for seed in (1, 2, 3):
                    for cfg_id, pca, ckdir in models:
                        if rng.rand() < 0.15:
                            continue
                        sweeps = [(False, 1)] + ([(True, k) for k in (1, 2, 3, 5)]
                                                 if cfg_id == 1000 else [])
                        for recon, k in sweeps:
                            cfg = JaxConfig({
                                "seed": seed, "epoch": 20, "region": region,
                                "subject_idx": subj, "neural_dataset": ds, "cfg_id": cfg_id,
                                "pca_labels": pca, "pca_n_classes": cfg_id if pca else None,
                                "pca_labels_folder": "f", "checkpoint_dir": ckdir,
                                "analysis": "rsa", "compare_method": "spearman",
                                "reconstruct_from_pcs": recon, "pca_k": k,
                                "model_name": "CustomCNN"})
                            save_results([{"layer": layer, "compare_method": "spearman",
                                           "score": float(rng.choice([0.1, 0.2, rng.rand()])),
                                           "analysis": "rsa"}
                                          for layer in ("conv3_post", "fc1_post", "fc2_post")],
                                         cfg, db_path=db)
    return db


@pytest.mark.parametrize("dataset,regions", [
    ("nsd", [*REGIONS, None]), ("tvsd", ["V1", "IT", "V4"]), ("things-behavior", ["N/A"])])
def test_reconstruction_plot_queries(results_db, dataset, regions):
    for region in regions:
        want = jplot.query_reconstruction_curve(results_db, dataset, region)
        got = tplot.query_reconstruction_curve(results_db, dataset, region)
        if len(want):
            _frame_equal(want, got)
        else:
            assert got.empty
        agg = tplot.aggregate_curve(got)
        _frame_equal(jplot.aggregate_curve(want), agg)
        _same(tplot.query_1000way_baseline(results_db, dataset, region),
              jplot.query_1000way_baseline(results_db, dataset, region))
        _same(tplot.query_coarse_baseline(results_db, dataset, region),
              jplot.query_coarse_baseline(results_db, dataset, region))


# ── binary-PC and curriculum figures (csv module in both packages) ──

def test_binary_visualize_series(tmp_path):
    rng = np.random.RandomState(5)
    rows = [dict(n_pcs=n, region=r, weighted=w, correlation=c, subject_idx=s,
                 score=repr(float(rng.rand())))
            for r in tviz.REGIONS for n in (2, 5, 20) for w in (True, False, "1")
            for c in ("Spearman", "Kendall") for s in (0, 1)]
    res = _write_csv(tmp_path / "b.csv", rows)
    base = _write_csv(tmp_path / "cnn.csv", [
        dict(layer=l, region=r, epoch=e, correlation=c, subject_idx=s,
             score=repr(float(rng.rand())))
        for r in tviz.REGIONS for l in ("conv4", "fc1") for e in (0, 20)
        for c in ("Spearman", "Kendall") for s in ("0", "1", "7")])
    assert tviz.average_over_subjects(tviz._read_csv(res)) == \
        jviz.average_over_subjects(jviz._read_csv(res))
    assert tviz.load_baselines(base, {"0", "1"}) == jviz.load_baselines(base, {"0", "1"})


def test_curriculum_mean_by_depth(tmp_path):
    rng = np.random.RandomState(6)
    rows = [dict(model_name=m, region=r, depth_normalized=repr(float(d)),
                 rsa_score=repr(float(rng.rand())))
            for m in tcur.MODEL_NAMES for r in tcur.REGIONS
            for d in np.linspace(0, 1, 7) for _ in range(2)]
    with open(_write_csv(tmp_path / "c.csv", rows)) as f:
        read = list(csv.DictReader(f))
    for m in tcur.MODEL_NAMES:
        for r in tcur.REGIONS:
            for got, want in zip(tcur._mean_by_depth(read, m, r),
                                 jcur._mean_by_depth(read, m, r)):
                _same(got, want)


# seaborn 0.13.2's color_palette("Blues", 4)[1:] and ("Greens", 7)[1:]
SEABORN_PALETTES = {
    ("Blues", 3): [(0.5796078431372549, 0.7701960784313725, 0.8737254901960784),
                   (0.2909803921568628, 0.5945098039215686, 0.7890196078431373),
                   (0.09019607843137256, 0.39294117647058824, 0.6705882352941177)],
    ("Greens", 6): [(0.7792233756247597, 0.9132333717800846, 0.7518031526336024),
                    (0.6292964244521337, 0.8500115340253749, 0.6061361014994232),
                    (0.45176470588235296, 0.7670895809304115, 0.4612072279892349),
                    (0.25259515570934254, 0.6681276432141483, 0.3628604382929642),
                    (0.1340253748558247, 0.5423298731257208, 0.26828143021914647),
                    (0.0, 0.42303729334871204, 0.170718954248366)],
}


@pytest.mark.parametrize("name,n", list(SEABORN_PALETTES))
def test_palette_is_seaborns(name, n):
    """The drawing helpers' palettes without seaborn: its colours, from
    matplotlib's colormap."""
    pytest.importorskip("matplotlib")
    assert tfig._blues(n, name) == SEABORN_PALETTES[(name, n)]


# ── the CLIs ────────────────────────────────────────────────────────

_DRIVER = """
import runpy, sys
class NoMatplotlib:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("matplotlib is blocked")
sys.meta_path.insert(0, NoMatplotlib())
mod = sys.argv[1]
sys.argv = [mod, *sys.argv[2:]]
runpy.run_module(mod, run_name="__main__", alter_sys=True)
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "pandas", "matplotlib", "seaborn", "jax", "visreps_tpu", "experiments", "plotters"))
assert not bad, bad
"""


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """Every CLI's input files."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(8)
    long_csv = _write_csv(tmp / "long.csv", long_rows("bool"))
    binary = _write_csv(tmp / "binary.csv", [
        dict(subject_idx=s, n_pcs=n, region=r, weighted=w, correlation=c,
             score=float(rng.rand()))
        for s in (0, 1) for n in (2, 3) for r in tviz.REGIONS for w in (True, False)
        for c in ("Spearman", "Kendall")])
    curriculum = _write_csv(tmp / "cur.csv", [
        dict(model_name=m, region=r, depth_normalized=d, rsa_score=float(rng.rand()))
        for m in tcur.MODEL_NAMES for r in tcur.REGIONS for d in (0.0, 0.5, 1.0)])
    rsm_dir = tmp / "RSMs" / "pca4cls"
    rsm_dir.mkdir(parents=True)
    for name in ("rsms_nsd_pca_labels_False_pca_k_2_cfgid_1_seed_1.npz",
                 "rsms_nsd_pca_labels_False_pca_k_2_cfgid_1_seed_2.npz",
                 "rsms_nsd_pca_labels_True_cfgid_2_seed_1.npz",
                 "rsms_nsd_pca_labels_True_cfgid_2_seed_2.npz"):
        np.savez(rsm_dir / name, **{l: np.corrcoef(rng.rand(12, 5)) for l in ("conv1", "fc2")})
    db = tmp / "results.db"
    for k in (1, 2, 3):
        save_results([{"layer": "fc1", "compare_method": "spearman", "score": 0.1 * k,
                       "analysis": "rsa"}], JaxConfig({
                           "seed": 1, "epoch": 20, "region": "V1", "subject_idx": 0,
                           "neural_dataset": "tvsd", "cfg_id": 1000, "pca_labels": False,
                           "checkpoint_dir": "ck", "analysis": "rsa",
                           "compare_method": "spearman", "reconstruct_from_pcs": True,
                           "pca_k": k, "model_name": "CustomCNN"}), db_path=db)
    return {"tmp": tmp, "long": long_csv, "binary": binary, "curriculum": curriculum,
            "rsms": str(tmp / "RSMs"), "db": str(db)}


P = "visreps_tpu_torch.experiments."
CLIS = {
    "reconstruction_plot": (P + "reconstruction_analysis.plot",
                            lambda i, o: ["--db", i["db"], "--out_dir", o],
                            ["reconstruction_nsd", "reconstruction_tvsd",
                             "reconstruction_things-behavior"]),
    "binary_visualize": (P + "binary_pc_rsa.visualize",
                         lambda i, o: ["--results", i["binary"], "--cnn_baseline",
                                       i["binary"] + ".none", "--out_dir", o],
                         ["binary_pc_rsa_early", "binary_pc_rsa_ventral"]),
    "fig1": (P + "neurips_2025.fig1.model_reps_rsa_comparisons",
             lambda i, o: ["--base_rsm_dir", i["rsms"], "--output_dir", o, "--device", "cpu"],
             ["rsa_grouped_4cls_kendall"]),
    "fig2_recon": (P + "neurips_2025.fig2.reconstructed_rsa_nsd",
                   lambda i, o: ["--recon_csv", i["long"], "--baseline_csv", i["long"],
                                 "--out", f"{o}/recon_nsd.png"], ["recon_nsd"]),
    "fig2_bar": (P + "neurips_2025.fig2.bar_plot_nsd",
                 lambda i, o: ["--csv", i["long"], "--out", f"{o}/bar_nsd.png"], ["bar_nsd"]),
    "fig3_recon": (P + "neurips_2025.fig3.reconstructed_rsa_things",
                   lambda i, o: ["--recon_csv", i["long"], "--baseline_csv", i["long"],
                                 "--layer", "fc2", "--out", f"{o}/recon_things.png"],
                   ["recon_things"]),
    "fig3_full": (P + "neurips_2025.fig3.full_vs_pcs_things",
                  lambda i, o: ["--csv", i["long"], "--out", f"{o}/full_things.png"],
                  ["full_things"]),
    "fig3_bar": (P + "neurips_2025.fig3.bar_plot_things",
                 lambda i, o: ["--csv", i["long"], "--pc_layer", "fc2", "--out",
                               f"{o}/bar_things.png"], ["bar_things"]),
    "fig4": (P + "neurips_2025.fig4.full_vs_pcs_nsd",
             lambda i, o: ["--csv", i["long"], "--out", f"{o}/full_nsd.png"], ["full_nsd"]),
    "curriculum": (P + "coarse_grain_benefits.plot_curriculum_rsa",
                   lambda i, o: ["--input", i["curriculum"], "--out", f"{o}/cur.png"], ["cur"]),
}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_without_matplotlib(cli_inputs, name):
    module, argv, figures = CLIS[name]
    out = cli_inputs["tmp"] / name
    proc = subprocess.run([sys.executable, "-c", _DRIVER, module, *argv(cli_inputs, str(out))],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    not_drawn = [line for line in proc.stdout.splitlines()
                 if "matplotlib is not installed" in line]
    assert len(not_drawn) == len(figures), proc.stdout
    for fig, line in zip(figures, not_drawn):
        assert f"{fig}.png not drawn" in line
        series = json.loads((out / f"{fig}.json").read_text())
        assert series and not (out / f"{fig}.png").exists()


def test_cli_draws_with_matplotlib(cli_inputs, tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "bar.png"
    scores = tbar2.main(["--csv", cli_inputs["long"], "--out", str(out)])
    assert out.stat().st_size > 0
    written = json.loads(out.with_suffix(".json").read_text())
    assert list(written) == list(scores)
    assert [len(v) for v in written.values()] == [len(v) for v in scores.values()]
    assert list(scores)[0] == "Untrained" and list(scores)[-1] == "1000 Classes"
