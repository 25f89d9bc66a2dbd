"""The port's WordNet label source (``visreps_tpu_torch/experiments/wordnet/``)
and ``ImageNetDataset``'s WordNet lookups against the JAX package's, on
the CPU, plus the slice as a whole: a hypernym snapshot → the port's
WordNet CSVs → ``run.main --mode train`` on them → that checkpoint's NSD
eval → its rows in the port's plotter queries.

The snapshot is made by hand (``_paths``): 40 wnids under 8 of the
super-categories' Level-6 synsets, paths 6–12 deep, every fifth wnid
with a second, longer path, and one wnid whose only path is 6 long (its
Level-6 synset is the leaf). No test reaches nltk: it is blocked or
stubbed, so nothing is downloaded. Every comparison is exact (CSV files
byte for byte, printed lines and returned values equal)."""
import json
import sqlite3
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from experiments.wordnet import hierarchy as jhier
from experiments.wordnet import make_semantic_labels as jsem
from experiments.wordnet import make_wordnet_labels as jlab
from experiments.wordnet import wordnet as jwn
from visreps_tpu.data import obj_cls as jobj

import visreps_tpu_torch.core.db as tdb
from visreps_tpu_torch.benchmarks import fixture as tfixture
from visreps_tpu_torch.benchmarks.fixture import write_imagenet_fixture
from visreps_tpu_torch.data import obj_cls as tobj
from visreps_tpu_torch.experiments.wordnet import hierarchy as thier
from visreps_tpu_torch.experiments.wordnet import make_semantic_labels as tsem
from visreps_tpu_torch.experiments.wordnet import make_wordnet_labels as tlab
from visreps_tpu_torch.experiments.wordnet import wordnet as twn

REPO = Path(__file__).resolve().parents[1]
N_CLASSES = 40
CATEGORIES = ["animal.n.01", "plant.n.02", "conveyance.n.03", "device.n.01",
              "container.n.01", "clothing.n.01", "building.n.01", "vegetable.n.01"]
TRUNK = ["entity.n.01", "physical_entity.n.01", "object.n.01", "whole.n.02"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (see test_torch_port_cg_benefits)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wnid(k: int) -> str:
    return f"n{k:08d}"  # benchmarks/fixture.write_imagenet_fixture's folder names


def _paths(n: int = N_CLASSES) -> dict:
    """{wnid: root-first hypernym paths}: Level 6 (index 6) of each
    shortest path is one of CATEGORIES."""
    out = {}
    for k in range(n):
        cat = CATEGORIES[k % len(CATEGORIES)]
        stem = cat.split(".")[0]
        branch = [f"{stem}_branch.n.01", f"{stem}_group.n.01"]
        tail = [f"{stem}_sub{k % 3}.n.01", f"{stem}_kind{k % 4}.n.01", f"{stem}_form{k % 5}.n.01"]
        depth = 7 + k % 6  # 7–12 synsets
        path = TRUNK + branch + [cat] + tail[:max(0, depth - 8)] + [f"leaf{k}.n.01"]
        paths = [path]
        if k % 5 == 0:  # a second, longer path through another group
            paths.append(TRUNK + [f"{stem}_other.n.01"] + branch + [cat] + tail
                         + [f"leaf{k}.n.01"])
        out[_wnid(k)] = paths
    out[_wnid(n - 1)] = [TRUNK + ["plant_group.n.01", "plant.n.02"]]  # 6 deep: leaf is Level 6
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 40-class ImageNet tree (80 JPEGs), its folder_labels.json and the
    snapshot."""
    root = tmp_path_factory.mktemp("wordnet")
    data = write_imagenet_fixture(root / "imagenet", 80, n_classes=N_CLASSES, pca_n_classes=[])
    snap = root / "paths.json"
    snap.write_text(json.dumps(_paths()))
    env = {"IMAGENET_DATA_DIR": data["dataset_path"],
           "IMAGENET_LOCAL_DIR": str(Path(data["label_file"]).parent),
           "WORDNET_PATHS_JSON": str(snap)}
    return {"root": root, "data": data, "snap": snap, "env": env}


@pytest.fixture
def env(world, monkeypatch):
    for k, v in world["env"].items():
        monkeypatch.setenv(k, v)
    return world


def _datasets(world):
    kw = dict(split="all", label_file=world["data"]["label_file"])
    return (tobj.ImageNetDataset(world["data"]["dataset_path"], **kw),
            jobj.ImageNetDataset(world["data"]["dataset_path"], **kw))


def _block_nltk(monkeypatch):
    for name in ("nltk", "nltk.corpus"):
        monkeypatch.setitem(sys.modules, name, None)


class _Synset:
    def __init__(self, name, paths=()):
        self._name, self._paths = name, paths

    def name(self):
        return self._name

    def hypernym_paths(self):
        return [[_Synset(s) for s in p] for p in self._paths]


def _stub_nltk(monkeypatch, paths: dict):
    """nltk with a corpus that knows ``paths`` (offset → the wnid's)."""
    wn = types.SimpleNamespace(
        ensure_loaded=lambda: None,
        synset_from_pos_and_offset=lambda pos, off: _Synset(
            f"syn{off}.{pos}.01", paths[f"n{off:08d}"]))
    nltk = types.ModuleType("nltk")
    corpus = types.ModuleType("nltk.corpus")
    corpus.wordnet = wn
    nltk.corpus = corpus
    nltk.download = lambda *a, **k: pytest.fail("nltk.download called")
    monkeypatch.setitem(sys.modules, "nltk", nltk)
    monkeypatch.setitem(sys.modules, "nltk.corpus", corpus)


# ── ImageNetDataset's WordNet lookups (the repaired methods) ─────────

class TestImageNetWordnet:
    def test_wnid_from_label(self, world):
        t, j = _datasets(world)
        for k in range(N_CLASSES):
            assert t.get_wnid_from_label(k) == j.get_wnid_from_label(k) == _wnid(k)
        for bad in (N_CLASSES, -1, 999):
            with pytest.raises(ValueError, match=f"Label index {bad} not found") as te:
                t.get_wnid_from_label(bad)
            with pytest.raises(ValueError) as je:
                j.get_wnid_from_label(bad)
            assert str(te.value) == str(je.value)

    def test_synset_without_nltk_is_none(self, world, monkeypatch, capsys):
        t, j = _datasets(world)
        _block_nltk(monkeypatch)
        assert t.get_wordnet_synset(3) is None
        tout = capsys.readouterr().out
        assert j.get_wordnet_synset(3) is None
        assert tout == capsys.readouterr().out
        assert "nltk not installed" in tout

    def test_synset_from_nltk(self, world, monkeypatch):
        t, j = _datasets(world)
        _stub_nltk(monkeypatch, _paths())
        for k in (0, 7, N_CLASSES - 1):
            assert t.get_wordnet_synset(k).name() == j.get_wordnet_synset(k).name()
        with pytest.raises(ValueError):
            t.get_wordnet_synset(N_CLASSES)


# ── hierarchy.py ─────────────────────────────────────────────────────

class TestHierarchy:
    def test_queries_equal_jax(self, world):
        paths = _paths()
        th, jh = thier.WordnetHierarchy(paths), jhier.WordnetHierarchy(paths)
        wnids = sorted(paths) + ["n99999999"]  # one without paths
        for w in wnids:
            assert th.hypernym_paths(w) == jh.hypernym_paths(w)
            for depth in range(0, 14):
                assert th.ancestor_at_depth(w, depth) == jh.ancestor_at_depth(w, depth)
            for level in (3, 6, 8):
                assert th.level_synset(w, level) == jh.level_synset(w, level)
        names = {s for ps in paths.values() for p in ps for s in p} | {"not_a_synset.n.01"}
        for name in sorted(names):
            assert th.children(name) == jh.children(name)
        # the longest path sets the depth, the shortest the level
        assert th.ancestor_at_depth(_wnid(0), 4) == "animal_other.n.01"
        assert th.level_synset(_wnid(0), 6) == "animal.n.01"
        assert th.level_synset(_wnid(N_CLASSES - 1), 6) == "plant.n.02"  # the leaf
        assert th.ancestor_at_depth(_wnid(N_CLASSES - 1), 9) == "plant.n.02"

    def test_load_sources(self, world, monkeypatch):
        monkeypatch.setenv("WORDNET_PATHS_JSON", str(world["snap"]))
        assert thier.WordnetHierarchy.load().paths == jhier.WordnetHierarchy.load().paths
        monkeypatch.delenv("WORDNET_PATHS_JSON")
        _block_nltk(monkeypatch)
        for mod in (thier, jhier):
            with pytest.raises(RuntimeError, match="No WordNet source"):
                mod.WordnetHierarchy.load([_wnid(0)])
        _stub_nltk(monkeypatch, _paths())
        wnids = [_wnid(k) for k in range(5)]
        assert thier.WordnetHierarchy.load(wnids).paths == jhier.WordnetHierarchy.load(wnids).paths

    def test_export_snapshot(self, env, monkeypatch, tmp_path, capsys):
        _stub_nltk(monkeypatch, _paths())
        thier.main(["export", str(tmp_path / "t.json")])
        jhier.export_snapshot(sorted(_paths()), str(tmp_path / "j.json"))
        assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
        assert f"Wrote {N_CLASSES} wnid hierarchies" in capsys.readouterr().out


# ── wordnet.py ───────────────────────────────────────────────────────

class TestExplorationCLI:
    def test_printed_lines(self, world):
        h = thier.WordnetHierarchy(_paths())
        for args in (("entity.n.01",), ("object.n.01", 0, 5, 2), ("animal.n.01", 0, 2, 1)):
            got, want = [], []
            twn.print_hierarchy(h, *args, out=got.append)
            jwn.print_hierarchy(jhier.WordnetHierarchy(_paths()), *args, out=want.append)
            assert got == want and len(got) > 1
        for w in (_wnid(0), _wnid(3), "n99999999"):
            got, want = [], []
            twn.print_ancestry(h, w, out=got.append)
            jwn.print_ancestry(h, w, out=want.append)
            assert got == want

    def test_main(self, env, capsys):
        argv = ["--tree", "object.n.01", "--ancestry", _wnid(5), "--max_depth", "2"]
        twn.main(argv)
        got = capsys.readouterr().out
        jwn.main(argv)
        assert got == capsys.readouterr().out
        assert "Path 2 (" in got and "- object.n.01" in got


# ── the two label makers ─────────────────────────────────────────────

class TestLabelMakers:
    def test_depth_csvs_byte_for_byte(self, world, tmp_path):
        t, j = _datasets(world)
        th, jh = thier.WordnetHierarchy(_paths()), jhier.WordnetHierarchy(_paths())
        got = tlab.make_labels(t, th, str(tmp_path / "t"), n_classes=N_CLASSES)
        want = jlab.make_labels(j, jh, str(tmp_path / "j"), n_classes=N_CLASSES)
        assert [(d, k) for d, (k, _) in got.items()] == [(d, k) for d, (k, _) in want.items()]
        assert list(got) == list(range(1, 8))
        for depth, (k, path) in got.items():
            assert Path(path).read_bytes() == Path(want[depth][1]).read_bytes()
            rows = Path(path).read_text().splitlines()
            assert rows[0] == "image,pca_label" and len(rows) == 81
        # a plain recomputation of one depth: sorted unique ancestors as ids
        anc = {k: max(_paths()[_wnid(k)], key=len) for k in range(N_CLASSES)}
        at5 = {k: p[min(5, len(p) - 1)] for k, p in anc.items()}
        ids = {a: i for i, a in enumerate(sorted(set(at5.values())))}
        want5 = ["image,pca_label"] + [f"{img},{ids[at5[c]]}" for _, c, img in t.samples]
        assert Path(got[5][1]).read_text().splitlines() == want5

    def test_semantic_csv_and_mapping(self, world, tmp_path):
        t, j = _datasets(world)
        th, jh = thier.WordnetHierarchy(_paths()), jhier.WordnetHierarchy(_paths())
        out_t = tsem.make_labels(t, th, str(tmp_path / "t" / "sem.csv"), n_classes=N_CLASSES)
        out_j = jsem.make_labels(j, jh, str(tmp_path / "j" / "sem.csv"), n_classes=N_CLASSES)
        assert Path(out_t).read_bytes() == Path(out_j).read_bytes()
        mt, mj = (Path(p.replace(".csv", "_mapping.txt")) for p in (out_t, out_j))
        assert mt.read_bytes() == mj.read_bytes()
        assert "8 Super-Categories for ImageNet" in mt.read_text()
        assert list(tsem.SUPER_CATEGORIES.items()) == list(jsem.SUPER_CATEGORIES.items())
        assert tsem.CATEGORY_ORDER == jsem.CATEGORY_ORDER
        assert tsem.SYNSET_TO_SUPER == jsem.SYNSET_TO_SUPER

    def test_unmapped_synset_raises(self, world):
        paths = _paths()
        paths[_wnid(2)] = [TRUNK + ["odd_branch.n.01", "odd_group.n.01", "odd.n.01", "x.n.01"],
                           TRUNK + ["odd_branch.n.01", "weird.n.01", "leaf.n.01"]]
        paths[_wnid(4)] = [TRUNK + ["y.n.01", "z.n.01", "zz.n.01", "q.n.01"]]
        errors = []
        for mod, hmod in ((tsem, thier), (jsem, jhier)):
            with pytest.raises(ValueError, match="2 unmapped Level 6 synsets") as e:
                mod.classify_classes(hmod.WordnetHierarchy(paths), _wnid, N_CLASSES)
            errors.append(str(e.value))
        assert errors[0] == errors[1] and "'zz.n.01'" in errors[0]
        del paths[_wnid(7)]
        for mod, hmod in ((tsem, thier), (jsem, jhier)):
            with pytest.raises(ValueError, match=r"Class 7 \(n00000007\) has no Level 6 synset"):
                mod.classify_classes(hmod.WordnetHierarchy(paths), _wnid, N_CLASSES)

    def test_mains_keep_the_1000_class_default(self, env, tmp_path):
        """Both mains ask for 1,000 classes: on a 40-class label map they
        raise at class 40, as the JAX package's do."""
        for main in (tlab.main, jlab.main):
            with pytest.raises(ValueError, match=f"Label index {N_CLASSES} not found"):
                main(["--out_dir", str(tmp_path / "w")])
        for main in (tsem.main, jsem.main):
            with pytest.raises(ValueError, match=f"Label index {N_CLASSES} not found"):
                main(["--out", str(tmp_path / "s.csv")])

    def test_mains_on_a_1000_wnid_label_map(self, world, monkeypatch, tmp_path):
        """A 1,000-wnid folder_labels.json whose first 40 entries are the
        tree's folders, with paths for every wnid (the chip run's layout):
        both mains then run unchanged and write the same files."""
        paths = _paths(1000)
        local = tmp_path / "local"
        local.mkdir()
        (local / "folder_labels.json").write_text(
            json.dumps({_wnid(k): k for k in range(1000)}))
        (tmp_path / "paths.json").write_text(json.dumps(paths))
        monkeypatch.setenv("IMAGENET_DATA_DIR", world["data"]["dataset_path"])
        monkeypatch.setenv("IMAGENET_LOCAL_DIR", str(local))
        monkeypatch.setenv("WORDNET_PATHS_JSON", str(tmp_path / "paths.json"))
        got = tlab.main(["--out_dir", str(tmp_path / "t")])
        jlab.main(["--out_dir", str(tmp_path / "j")])
        for depth, (k, path) in got.items():
            assert Path(path).read_bytes() == (tmp_path / "j" / f"n_classes_{k}.csv").read_bytes()
        tsem.main(["--out", str(tmp_path / "t" / "sem.csv")])
        jsem.main(["--out", str(tmp_path / "j" / "sem.csv")])
        for name in ("sem.csv", "sem_mapping.txt"):
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


# ── the slice as a whole ─────────────────────────────────────────────

class TestSlice:
    def test_snapshot_to_training_to_plotter_rows(self, tmp_path, monkeypatch):
        """Snapshot → the port's depth CSVs on a 2-class tree → one
        CustomCNN training step on the depth-7 labels → the checkpoint's
        NSD RSA eval → its rows through the port's plotter queries."""
        from visreps_tpu_torch import run as trun
        from visreps_tpu_torch.plotters import plotter_utils as tpu

        data = write_imagenet_fixture(tmp_path / "imagenet", 10, n_classes=2, pca_n_classes=[])
        paths = {_wnid(0): [TRUNK + ["a.n.01", "b.n.01", "animal.n.01", "dog.n.01"]],
                 _wnid(1): [TRUNK + ["a.n.01", "c.n.01", "plant.n.02", "tree.n.01"]]}
        (tmp_path / "paths.json").write_text(json.dumps(paths))
        monkeypatch.setenv("WORDNET_PATHS_JSON", str(tmp_path / "paths.json"))
        ds = tobj.ImageNetDataset(data["dataset_path"], split="all", label_file=data["label_file"])
        written = tlab.make_labels(ds, thier.WordnetHierarchy.load(), str(tmp_path / "wordnet"),
                                   n_classes=2)
        assert {d: k for d, (k, _) in written.items()} == {1: 1, 2: 1, 3: 1, 4: 1, 5: 2, 6: 2, 7: 2}
        labels = Path(written[7][1]).read_text().splitlines()[1:]
        assert sorted({line.split(",")[1] for line in labels}) == ["0", "1"]

        ckpt = tmp_path / "ckpt"
        trainer = trun.main([
            "--mode", "train", "--device", "cpu", "--config", str(REPO / "configs/train/base.json"),
            "--override", "pca_labels=true", "pca_n_classes=2", "batchsize=4", "num_epochs=1",
            "warmup_epochs=0", "num_workers=2", "log_interval=1", "checkpoint_interval=1",
            "log_checkpoints=true", "data_augment=false", f"checkpoint_dir={ckpt}",
            f"dataset_path={data['dataset_path']}", f"label_file={data['label_file']}",
            f"pca_labels_folder={tmp_path / 'wordnet'}"])
        losses = [h["loss"] for h in trainer.history]
        assert len(losses) == 2 and all(np.isfinite(losses))  # 8 train images / batch 4

        meta = tfixture.ensure_fixture(tmp_path / "nsd", n_shared=12, n_unique=20, n_subjects=2,
                                       n_regions=2, n_voxels=8, img_size=64)
        db = tmp_path / "results.db"
        monkeypatch.setenv("NSD_DATA_DIR", str(Path(meta["pickle"]).parent))
        monkeypatch.setenv("NSD_STIMULI_HDF5", meta["stimuli"])
        monkeypatch.setattr(tdb, "RESULTS_DB_PATH", db)
        trun.main([
            "--mode", "eval", "--device", "cpu", "--config", str(REPO / "configs/eval/base.json"),
            "--override", "neural_dataset=nsd", "subject_idx=[0,1]",
            "region=[early visual stream,ventral visual stream]", "analysis=rsa",
            "compare_method=spearman", "bootstrap=true", "n_bootstrap=8", "n_select=10",
            "batchsize=16", "num_workers=2", "load_model_from=checkpoint", "cfg_id=2",
            f"checkpoint_dir={ckpt}", "checkpoint_model=checkpoint_epoch_1.pth",
            "srp_k=32", "log_expdata=true", "seed=1"])
        folder = str(tmp_path / "wordnet")
        with sqlite3.connect(db) as conn:
            n_rows = conn.execute("SELECT COUNT(*) FROM results WHERE pca_labels_folder = ?",
                                  (folder,)).fetchone()[0]
        assert n_rows == 4  # 2 subjects × 2 regions, one best layer each
        for region in ("early visual stream", "ventral visual stream"):
            best = tpu.query_best_scores("nsd", region, folder, 2, epoch=1, db_path=db)
            assert sorted(best["subject_idx"].tolist()) == ["0", "1"]
            assert np.isfinite(best["score"]).all()
            summary = tpu.get_condition_summary("nsd", region, folder, 2, epoch=1, db_path=db)
            assert summary["n_runs"] == 2
            assert summary["ci_low"] <= summary["mean"] <= summary["ci_high"]
            assert set(tpu.get_subject_scores("nsd", region, folder, 2, epoch=1,
                                              db_path=db)) == {"0", "1"}
