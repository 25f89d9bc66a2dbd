"""The port's results.db plotters (``visreps_tpu_torch/plotters/``) against
the JAX package's pandas ``plotters/``, on the CPU.

One seeded results.db is written twice, through each package's
``core/db.save_results`` (the two files must hold the same rows), in
``tests/test_plotters.py``'s layout — every dataset and region, 2 seeds,
``alexnet`` and ``clip`` label folders, cfg 2–64, 1000 and untrained —
plus the cases where pandas' rules matter: duplicated (seed, subject)
rows (a second checkpoint, and two layers in one run), missing bootstrap
distributions and ones that do not bracket the mean (the SEM fallback),
a condition with one seed (NaN CI), tied layer means, THINGS' 'N/A'
subject, encoding rows and missing conditions (NaN bars).

Every query and summary is held to the pandas version on its own
package's file (keys, order and NaN places exact, values within 1e-12
relative), and each CLI's JSON series to the numbers the JAX figure
draws (its ``Axes.bar`` / ``errorbar`` / ``boxplot`` / ``axhline`` /
``text`` calls, recorded). Both packages draw: matplotlib is here."""
import json
import math
import sqlite3
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import matplotlib

matplotlib.use("Agg")
from matplotlib.axes import Axes  # noqa: E402

import plotters.plot_architectures as jarch  # noqa: E402
import plotters.plotter_utils as jpu  # noqa: E402
from plotters.nsd import plot_coarseness as jnsd  # noqa: E402
from plotters.nsd_synthetic import plot_coarseness as jsyn  # noqa: E402
from plotters.things import plot_coarseness as jthings  # noqa: E402
from plotters.tvsd import plot_coarseness as jtvsd  # noqa: E402
from visreps_tpu.core.config import Config as JaxConfig  # noqa: E402
from visreps_tpu.core.db import save_results as jax_save  # noqa: E402

from visreps_tpu_torch.core.config import Config  # noqa: E402
from visreps_tpu_torch.core.db import save_results as torch_save  # noqa: E402
from visreps_tpu_torch.plotters import plot_architectures as tarch  # noqa: E402
from visreps_tpu_torch.plotters import plot_helpers as thelp  # noqa: E402
from visreps_tpu_torch.plotters import plotter_utils as tpu  # noqa: E402
from visreps_tpu_torch.plotters.nsd import plot_coarseness as tnsd  # noqa: E402
from visreps_tpu_torch.plotters.nsd_synthetic import plot_coarseness as tsyn  # noqa: E402
from visreps_tpu_torch.plotters.things import plot_coarseness as tthings  # noqa: E402
from visreps_tpu_torch.plotters.tvsd import plot_coarseness as ttvsd  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-12
REGIONS = {
    "nsd": ["early visual stream", "ventral visual stream", "V1", "V2", "V3", "hV4",
            "FFA", "PPA"],
    "nsd_synthetic": ["early visual stream", "ventral visual stream"],
    "tvsd": ["V1", "V4", "IT"],
    "things-behavior": ["N/A"],
}
SUBJECTS = {"nsd": range(3), "nsd_synthetic": range(3), "tvsd": range(2),
            "things-behavior": ["N/A"]}


def _rows(rng):
    """(config, result rows) of every run, in writing order."""
    runs = []

    def add(nd, region, subj, seed, cfg_id, folder, epoch, score, layers=("conv5_post",),
            boot="around", analysis="rsa", method="spearman", ckpt=None, pca=True):
        cfg = {"seed": seed, "epoch": epoch, "region": region, "subject_idx": subj,
               "neural_dataset": nd, "cfg_id": cfg_id, "pca_labels": pca,
               "pca_n_classes": cfg_id if pca else None, "pca_labels_folder": folder,
               "checkpoint_dir": ckpt or f"ckpt_{folder}", "analysis": analysis,
               "compare_method": method, "reconstruct_from_pcs": False, "pca_k": 1,
               "model_name": "CustomCNN"}
        rows = []
        for i, layer in enumerate(layers):
            s = score if isinstance(score, float) else score[i]
            row = {"layer": layer, "compare_method": method, "score": s,
                   "ci_low": s - 0.03, "ci_high": s + 0.03, "analysis": analysis,
                   "layer_selection_scores": []}
            if boot == "around":
                row["bootstrap_scores"] = list(rng.uniform(s - 0.04, s + 0.04, 40))
            elif boot == "above":  # does not bracket the mean
                row["bootstrap_scores"] = list(rng.uniform(s + 0.1, s + 0.2, 30))
            rows.append(row)
        runs.append((cfg, rows))

    for nd, regions in REGIONS.items():
        for region in regions:
            for subj in SUBJECTS[nd]:
                for seed in (1, 2):
                    noise = lambda: float(rng.uniform(-0.01, 0.01))  # noqa: E731
                    for arch in ("alexnet", "clip"):
                        for cfg_id in (2, 4, 8, 16, 32, 64):
                            if nd == "nsd_synthetic" and arch == "clip" and cfg_id == 2:
                                continue  # a missing condition: a NaN bar
                            if nd == "tvsd" and region == "IT" and cfg_id == 64 and seed == 2:
                                continue  # one seed
                            boot = "around"
                            if cfg_id == 32 and region == "ventral visual stream":
                                boot = None
                            elif cfg_id == 4 and region in ("V2", "V4"):
                                boot = "above"
                            elif cfg_id == 64 and region == "IT":
                                boot = None
                            score = 0.2 + 0.002 * cfg_id + 0.01 * seed + noise()
                            layers = ("conv5_post",)
                            if cfg_id == 16:  # two layers of one run, tied means
                                layers, score = ("conv5_post", "fc1_post"), (score, score)
                            add(nd, region, subj, seed, cfg_id, f"pca_labels_{arch}", 20,
                                score, layers, boot)
                    add(nd, region, subj, seed, 1000, "imagenet1k", 20, 0.31 + noise(),
                        pca=False)
                    if nd != "tvsd":  # TVSD has no untrained rows: no untrained bar
                        add(nd, region, subj, seed, 1000, "imagenet1k", 0, 0.05 + noise(),
                            pca=False)
                    if nd == "nsd" and region in REGIONS["nsd_synthetic"]:
                        for cfg_id in (8, 1000):
                            folder = "imagenet1k" if cfg_id == 1000 else "pca_labels_alexnet"
                            add(nd, region, subj, seed, cfg_id, folder, 20, 0.4 + noise(),
                                analysis="encoding_score", method="pearson",
                                pca=cfg_id != 1000)
    # a second checkpoint of one (seed, subject): duplicated rows, the higher kept
    add("nsd", "V1", 0, 1, 8, "pca_labels_alexnet", 20, 0.9, ckpt="ckpt_again")
    add("nsd", "V1", 0, 1, 8, "pca_labels_alexnet", 20, 0.1, ckpt="ckpt_third")
    return runs


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plotters")
    runs = _rows(np.random.RandomState(0))
    paths = {"jax": tmp / "jax.db", "torch": tmp / "torch.db"}
    for cfg, rows in runs:
        jax_save(rows, JaxConfig(cfg), db_path=paths["jax"])
        torch_save(rows, Config(cfg), db_path=paths["torch"])
    return paths


def _dump(path):
    with sqlite3.connect(path) as conn:
        return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall(), key=repr)
                for t in ("results", "bootstrap_distributions")}


def test_both_packages_write_the_same_db(dbs):
    j, t = _dump(dbs["jax"]), _dump(dbs["torch"])
    assert j == t and len(t["results"]) > 800


# ── comparison helpers ──────────────────────────────────────────────

def _close(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    a, b = float(a), float(b)
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= RTOL * max(abs(a), abs(b), 1e-300)


def _na(v):
    return None if isinstance(v, float) and math.isnan(v) else v


def same_frame(table, df):
    assert list(table.columns) == list(df.columns)
    assert len(table) == len(df)
    for col in df.columns:
        got, want = table[col], df[col].to_numpy()
        if got.dtype.kind == "f":
            assert want.dtype.kind == "f", col
            assert all(_close(a, b) for a, b in zip(got.tolist(), want.tolist())), col
        else:
            assert [_na(v) for v in got.tolist()] == [_na(v) for v in want.tolist()], col


def same_summary(got: dict, want: dict):
    assert list(got) == list(want)
    for k in ("mean", "ci_low", "ci_high"):
        assert _close(got[k], want[k]), (k, got[k], want[k])
    assert got["n_runs"] == want["n_runs"] and got["run_ids"] == want["run_ids"]


CONDITIONS = [  # (dataset, region, folder, cfg_id, method, epoch, analysis)
    ("nsd", "V1", "pca_labels_alexnet", 8, "spearman", 20, "rsa"),      # duplicates
    ("nsd", "V1", "pca_labels_alexnet", 16, "spearman", None, "rsa"),   # two layers a run
    ("nsd", "ventral visual stream", "pca_labels_clip", 32, "spearman", 20, "rsa"),  # no boot
    ("nsd", "V2", "pca_labels_alexnet", 4, "spearman", 20, "rsa"),      # boot above the mean
    ("tvsd", "IT", "pca_labels_alexnet", 64, "spearman", 20, "rsa"),    # one seed, no boot
    ("tvsd", "V4", "pca_labels_clip", 4, "spearman", 20, "rsa"),
    ("things-behavior", "N/A", "pca_labels_alexnet", 2, "spearman", 20, "rsa"),
    ("nsd_synthetic", "early visual stream", "pca_labels_clip", 2, "spearman", 20, "rsa"),
    ("nsd", "early visual stream", "imagenet1k", 1000, "spearman", 0, "rsa"),
    ("nsd", "early visual stream", "pca_labels_alexnet", 8, "pearson", 20, "encoding_score"),
    ("nsd", "early visual stream", "pca_labels_dino", 8, "spearman", 20, "rsa"),  # none
]


class TestQueries:
    @pytest.mark.parametrize("cond", CONDITIONS, ids=lambda c: f"{c[0]}-{c[1]}-{c[3]}")
    def test_best_scores_summary_subjects(self, dbs, cond, capsys):
        nd, region, folder, cfg_id, method, epoch, analysis = cond
        args = (nd, region, folder, cfg_id, method, epoch, analysis)
        got = tpu.query_best_scores(*args, db_path=dbs["torch"])
        tout = capsys.readouterr().out
        want = jpu.query_best_scores(*args, db_path=dbs["jax"])
        assert tout == capsys.readouterr().out
        if want.empty:
            assert got.empty
        else:
            same_frame(got, want)
        same_summary(tpu.get_condition_summary(*args, db_path=dbs["torch"]),
                     jpu.get_condition_summary(*args, db_path=dbs["jax"]))
        subj_t = tpu.get_subject_scores(*args, db_path=dbs["torch"])
        subj_j = jpu.get_subject_scores(*args, db_path=dbs["jax"])
        assert list(subj_t) == subj_j.index.tolist()
        assert all(_close(a, b) for a, b in zip(subj_t.values(), subj_j.tolist()))

    def test_the_rules_show(self, dbs, capsys):
        """The seeded cases do what they are there for."""
        best = tpu.query_best_scores("nsd", "V1", "pca_labels_alexnet", 8, epoch=20,
                                     db_path=dbs["torch"])
        assert "WARNING: 3 duplicate rows for seed=1, subject_idx=0" in capsys.readouterr().out
        assert best["score"][0] == 0.9
        for cond in (CONDITIONS[2], CONDITIONS[3]):  # SEM fallback: a CI around the mean
            s = tpu.get_condition_summary(*cond, db_path=dbs["torch"])
            assert s["ci_low"] < s["mean"] < s["ci_high"]
            seeds = tpu.group_agg(tpu.query_best_scores(*cond, db_path=dbs["torch"]), "seed")
            sem = np.std(seeds["score"], ddof=1) / np.sqrt(2)
            assert abs(s["ci_high"] - s["mean"] - 1.96 * sem) < 1e-12
        one_seed = tpu.get_condition_summary(*CONDITIONS[4], db_path=dbs["torch"])
        assert math.isnan(one_seed["ci_low"]) and math.isnan(one_seed["ci_high"])
        things = tpu.query_best_scores(*CONDITIONS[6], db_path=dbs["torch"])
        assert set(things["subject_idx"].tolist()) == {"N/A"}

    @pytest.mark.parametrize("run_ids", [[], ["nope"], "first3", "all_v1"])
    def test_bootstrap_ci(self, dbs, run_ids):
        with sqlite3.connect(dbs["torch"]) as conn:
            ids = [r[0] for r in conn.execute(
                "SELECT run_id FROM results WHERE region = 'V1' ORDER BY run_id")]
        if isinstance(run_ids, str):
            run_ids = {"first3": ids[:3], "all_v1": ids}[run_ids]
        ids = run_ids
        got = tpu.get_bootstrap_ci(ids, db_path=dbs["torch"])
        want = jpu.get_bootstrap_ci(ids, db_path=dbs["jax"])
        assert all(_close(a, b) for a, b in zip(got, want))

    @pytest.mark.parametrize("kw", [
        {"neural_dataset": "nsd"}, {"neural_dataset": "tvsd", "region": "IT"},
        {"neural_dataset": "nsd", "analysis": "encoding_score", "compare_method": "pearson"},
        {"neural_dataset": "things-behavior", "checkpoint_dir": "ckpt_pca_labels_clip"}])
    def test_query_scores_and_reshaping(self, dbs, kw):
        got = tpu.query_scores(db_path=dbs["torch"], **kw)
        want = jpu.query_scores(db_path=dbs["jax"], **kw)
        same_frame(got, want)
        for name in ("avg_over_subject_idx", "avg_over_seed", "avg_over_subject_idx_seed"):
            same_frame(getattr(tpu, name)(got), getattr(jpu, name)(want))
        for filt in ({}, {"epoch": 20, "layers": ["conv5_post"]},
                     {"pca_n_classes": [4, 64], "subject_idx": [0, 1]},
                     {"dataset": kw["neural_dataset"].upper(), "reconstruct_from_pcs": False}):
            for t, j in zip(tpu.split_and_select_df(got, **filt),
                            jpu.split_and_select_df(want, **filt)):
                same_frame(t, j)

    @pytest.mark.parametrize("cols", [["seed"], ["seed", "subject_idx"], ["cfg_id", "epoch"]])
    def test_best_layer_scores(self, dbs, cols):
        got = tpu.get_best_layer_scores(
            tpu.query_scores("nsd", region="V1", db_path=dbs["torch"]), cols)
        want = jpu.get_best_layer_scores(
            jpu.query_scores("nsd", region="V1", db_path=dbs["jax"]), cols)
        assert list(got) == list(want)
        for key in want:
            (gs, gl), (ws, wl) = got[key], want[key]
            assert gl == wl and len(gs) == len(ws)
            assert all(_close(a, b) for a, b in zip(gs, ws))


# ── the figures: each CLI's series against what the JAX figure draws ──

class Recorder:
    """Records the JAX figures' bars, whiskers, boxes, lines and texts,
    per axes in drawing order."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("bar", "errorbar", "boxplot", "axhline", "text", "set_xticklabels"):
            original = getattr(Axes, name)

            def wrapper(ax, *args, _name=name, _orig=original, **kwargs):
                self.calls.append((id(ax), _name, args, kwargs))
                return _orig(ax, *args, **kwargs)
            monkeypatch.setattr(Axes, name, wrapper)

    def per_axes(self, name):
        out = {}
        for ax, n, args, kwargs in self.calls:
            if n == name:
                out.setdefault(ax, []).append((args, kwargs))
        return list(out.values())


def _jax_figure(monkeypatch, main, argv):
    with monkeypatch.context() as m:
        rec = Recorder(m)
        main(argv)
    return rec


def _check_bars(panels, rec):
    bars, whiskers = rec.per_axes("bar"), rec.per_axes("errorbar")
    assert len(bars) == len(panels)
    wi = iter(whiskers)
    for p, drawn in zip(panels, bars):
        want = [(float(a[0]), float(a[1])) for a, _ in drawn]
        got = [(x, m) for x, m in zip(p["x"], p["mean"]) if m is not None]
        assert [g[0] for g in got] == [w[0] for w in want]
        assert all(_close(g[1], w[1]) for g, w in zip(got, want))
        expected = []
        for x, m, lo, hi in zip(p["x"], p["mean"], p["ci_low"], p["ci_high"]):
            if None not in (m, lo, hi) and m - lo >= 0 and hi - m >= 0 and (m - lo or hi - m):
                expected.append((x, m, m - lo, hi - m))
        drawn_w = next(wi, []) if expected else []
        assert len(drawn_w) == len(expected)
        for (x, m, el, eh), (args, kw) in zip(expected, drawn_w):
            assert args[0] == x and _close(args[1], m)
            assert _close(kw["yerr"][0][0], el) and _close(kw["yerr"][1][0], eh)


def _check_boxes(panels, rec):
    boxes = iter(rec.per_axes("boxplot"))
    texts = [a[2] for _, n, a, _ in rec.calls if n == "text"]
    assert texts.count("Insufficient data") == sum(p["insufficient"] for p in panels)
    for p in panels:
        if p["insufficient"]:
            continue
        (args, kw), = next(boxes)
        assert list(kw["positions"]) == p["x"]
        assert len(args[0]) == len(p["scores"])
        for drawn, got in zip(args[0], p["scores"]):
            assert len(drawn) == len(got) and all(_close(a, b) for a, b in zip(got, drawn))


COARSENESS = [
    ("nsd-streams", tnsd, jnsd, ["--pca_labels", "alexnet", "--regions", "streams"],
     "coarseness_bars_alexnet", "per_subject_alexnet"),
    ("nsd-finegrained", tnsd, jnsd, ["--pca_labels", "clip", "--regions", "finegrained"],
     "coarseness_bars_clip_finegrained", "per_subject_clip_finegrained"),
    ("nsd-encoding", tnsd, jnsd, ["--pca_labels", "alexnet", "--analysis", "encoding_score"],
     "coarseness_bars_alexnet_encoding", "per_subject_alexnet_encoding"),
    ("nsd_synthetic", tsyn, jsyn, ["--pca_labels", "clip"], "coarseness_bars_clip",
     "per_subject_clip"),
    ("things", tthings, jthings, ["--pca_labels", "alexnet"], "coarseness_bars_alexnet", None),
    ("tvsd", ttvsd, jtvsd, ["--pca_labels", "alexnet"], "coarseness_bars_alexnet",
     "per_subject_alexnet"),
    ("tvsd-dino", ttvsd, jtvsd, ["--pca_labels", "dino"], "coarseness_bars_dino",
     "per_subject_dino"),
]


@pytest.mark.parametrize("case", COARSENESS, ids=[c[0] for c in COARSENESS])
def test_coarseness_cli_series(dbs, tmp_path, monkeypatch, case):
    _, tmod, jmod, argv, bars_name, subj_name = case
    tmod.main(argv + ["--out-dir", str(tmp_path / "t"), "--db", str(dbs["torch"])])
    rec = _jax_figure(monkeypatch, jmod.main,
                      argv + ["--out-dir", str(tmp_path / "j"), "--db", str(dbs["jax"])])
    bars = json.loads((tmp_path / "t" / f"{bars_name}.json").read_text())
    assert (tmp_path / "t" / f"{bars_name}.png").is_file()
    assert (tmp_path / "j" / f"{bars_name}.png").is_file()
    n_bars = len(rec.per_axes("bar"))
    _check_bars(bars, rec)
    if subj_name is None:
        assert not list((tmp_path / "t").glob("per_subject_*"))
        return
    subj = json.loads((tmp_path / "t" / f"{subj_name}.json").read_text())
    assert (tmp_path / "t" / f"{subj_name}.png").is_file()
    assert n_bars == len(bars)
    _check_boxes(subj, rec)


@pytest.mark.parametrize("dataset,region", [("nsd", "ventral visual stream"),
                                            ("things", "N/A")])
def test_architectures_cli_series(dbs, tmp_path, monkeypatch, dataset, region):
    argv = ["--dataset", dataset, "--region", region]
    got = tarch.main(argv + ["--out-dir", str(tmp_path / "t"), "--db", str(dbs["torch"])])
    rec = _jax_figure(monkeypatch, jarch.main,
                      argv + ["--out-dir", str(tmp_path / "j"), "--db", str(dbs["jax"])])
    assert got["architectures"] == ["alexnet", "clip"]
    bars = json.loads(Path(got["bars"]).with_suffix(".json").read_text())
    (drawn,) = rec.per_axes("bar")
    assert [b["mean"] for b in bars["bars"]] == pytest.approx(
        [float(a[1]) for a, _ in drawn], rel=RTOL)
    stars = [a for _, n, a, _ in rec.calls if n == "text" and a[2] == "*"]
    assert len(stars) == sum(b["star"] for b in bars["bars"])
    (line,) = [a for _, n, a, _ in rec.calls if n == "axhline"]
    assert _close(bars["baseline_1k"], line[0])
    boxes = json.loads(Path(got["boxes"]).with_suffix(".json").read_text())
    calls = rec.per_axes("boxplot")
    assert len(calls) == 1 and len(calls[0]) == 1
    (series,), _ = calls[0][0]
    assert len(series) == len(boxes["series"])
    for a, b in zip(boxes["series"], series):
        assert all(_close(x, y) for x, y in zip(a, b))
    labels = [a[0] for _, n, a, _ in rec.calls if n == "set_xticklabels"][-1]
    assert boxes["labels"] == list(labels)
    for path in (got["bars"], got["boxes"]):
        assert Path(path).is_file()


def test_architectures_without_rows(dbs, tmp_path, capsys):
    assert tarch.main(["--dataset", "nsd", "--region", "nowhere", "--db",
                       str(dbs["torch"]), "--out-dir", str(tmp_path)]) is None
    assert "No PCA-label-source rows found" in capsys.readouterr().out


def test_barplot_ttests(tmp_path):
    """The paired t-tests are scipy's, part of the data: p and the star."""
    from scipy import stats

    rng = np.random.RandomState(3)
    base = list(rng.uniform(0.3, 0.32, 8))
    scores = {("alexnet", 2): [b + 0.05 for b in base], ("clip", 2): list(base),
              ("alexnet", 4): list(rng.uniform(0.3, 0.32, 8)), ("clip", 4): [0.2, 0.3],
              ("1K", None): base}
    data = tpu.plot_brain_score_barplot(scores, [2, 4], ["alexnet", "clip"], "nsd x",
                                        str(tmp_path / "b.png"))
    by = {(b["architecture"], b["n_classes"]): b for b in data["bars"]}
    p = stats.ttest_rel(scores[("alexnet", 4)], base)[1]
    assert by[("alexnet", 4)]["p"] == p and by[("alexnet", 4)]["star"] == (p < 0.01)
    assert by[("alexnet", 2)]["star"] is True or math.isnan(by[("alexnet", 2)]["p"])
    assert by[("clip", 4)]["p"] is None  # a length mismatch: no test
    assert json.loads((tmp_path / "b.json").read_text())["bars"][0]["architecture"] == "alexnet"
    assert (tmp_path / "b.png").is_file()


def test_colours_equal_matplotlibs():
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap("Blues")
    want = [cmap(0.25 + 0.65 * i / (thelp.N_COARSE - 1)) for i in range(thelp.N_COARSE)]
    assert thelp.BLUES == [tuple(float(v) for v in c) for c in want]
    for name in ("COARSE_CFGS", "N_COARSE", "FULL_CFG", "PCA_MODELS", "FOLDER_DISPLAY",
                 "UNTRAINED_COLOR", "BASELINE_COLOR", "BAR_WIDTH"):
        assert getattr(thelp, name) == getattr(sys.modules["plotters.plot_helpers"], name)
    assert thelp.coarseness_colors(5) == sys.modules["plotters.plot_helpers"].coarseness_colors(5)


def _no_matplotlib_code() -> str:
    return (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "from visreps_tpu_torch.plotters.tvsd import plot_coarseness\n"
        f"plot_coarseness.main(['--out-dir', sys.argv[1], '--db', sys.argv[2]])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('pandas', 'jax', 'plotters')]\n"
        "assert not bad, bad\n")


def test_cli_without_matplotlib(dbs, tmp_path):
    """The card's machine has no matplotlib: the plotters import without it
    and each CLI writes its series and says what it did not draw."""
    proc = subprocess.run([sys.executable, "-c", _no_matplotlib_code(),
                           str(tmp_path), str(dbs["torch"])], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "matplotlib is not installed" in proc.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "coarseness_bars_alexnet.json", "per_subject_alexnet.json"]
