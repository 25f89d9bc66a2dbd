"""The port's ten data-preparation scripts (``visreps_tpu_torch/scripts/``)
against the JAX package's (``scripts/``), on the same seeded inputs in
``tmp_path``: the pickles' contents exactly (values as float32 arrays,
ids with their types), the JSON and CSV files byte for byte, the symlink
trees, the rsync argv and exit code, and every printed line.

The THINGS table and the NetCDF coordinates go through pandas in the
JAX scripts and through ``csv`` in the port; both are held to the JAX
output. ``xarray`` is not installed, so both packages' ``extract`` read a
stub put in ``sys.modules``. The reference's xarray pickles are stood in
for by ``FakeDataArray``, which has the two attributes ``convert`` reads.
"""
import json
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from scripts import combine_fmri_responses as jcombine  # noqa: E402
from scripts import copy_checkpoints as jcopy  # noqa: E402
from scripts import create_imagenet_labels as jlabels  # noqa: E402
from scripts import create_imagenet_mini as jmini  # noqa: E402
from scripts import extract_xarray_coords as jcoords  # noqa: E402
from scripts.preprocess_data import preprocess_nsd as jnsd  # noqa: E402
from scripts.preprocess_data import preprocess_nsd_synthetic as jsynth  # noqa: E402
from scripts.preprocess_data import preprocess_things as jthings  # noqa: E402
from scripts.preprocess_data import preprocess_tvsd as jtvsd  # noqa: E402
from scripts.preprocess_data import process_cusack25 as jcusack  # noqa: E402

from visreps_tpu_torch.scripts import combine_fmri_responses as tcombine  # noqa: E402
from visreps_tpu_torch.scripts import copy_checkpoints as tcopy  # noqa: E402
from visreps_tpu_torch.scripts import create_imagenet_labels as tlabels  # noqa: E402
from visreps_tpu_torch.scripts import create_imagenet_mini as tmini  # noqa: E402
from visreps_tpu_torch.scripts import extract_xarray_coords as tcoords  # noqa: E402
from visreps_tpu_torch.scripts.preprocess_data import preprocess_nsd as tnsd  # noqa: E402
from visreps_tpu_torch.scripts.preprocess_data import preprocess_nsd_synthetic as tsynth  # noqa: E402
from visreps_tpu_torch.scripts.preprocess_data import preprocess_things as tthings  # noqa: E402
from visreps_tpu_torch.scripts.preprocess_data import preprocess_tvsd as ttvsd  # noqa: E402
from visreps_tpu_torch.scripts.preprocess_data import process_cusack25 as tcusack  # noqa: E402

REGIONS = ("early visual stream", "ventral_stream", "V1")


def assert_same(a, b, path="root"):
    """Equal nested containers: same types and keys (in order), arrays of
    the same dtype and shape with equal values."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def run_both(capsys, jmain, tmain, jargv, targv):
    """Both mains on their argv; returns (JAX stdout, port stdout)."""
    jmain(jargv)
    jout = capsys.readouterr().out
    tmain(targv)
    tout = capsys.readouterr().out
    return jout, tout


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


class FakeCoords(dict):
    pass


class FakeDataArray:
    """Picklable stand-in for a reference xarray DataArray: the
    ``.coords["stimulus"].values`` and ``.values`` that ``convert`` reads."""

    def __init__(self, stimulus, values):
        self.coords = FakeCoords(stimulus=types.SimpleNamespace(values=np.asarray(stimulus)))
        self.values = values

    def __reduce__(self):
        return FakeDataArray, (self.coords["stimulus"].values, self.values)


def write_npz_dir(root: Path, rng, ids_of, n_vox=5, extra=None, suffix_of=None):
    """Per-(region, subject) npz files; ``ids_of(region, subj)`` gives the
    stimulus ids, ``extra`` files that the builders must skip."""
    root.mkdir()
    for region in REGIONS:
        for subj in (0, 3, 10):
            ids = ids_of(region, subj)
            name = suffix_of(region, subj) if suffix_of else f"{region}_subj{subj}"
            np.savez(root / f"{name}.npz", stimulus=np.asarray(ids),
                     values=rng.randn(len(ids), n_vox).astype(np.float64))
    for name in extra or ():
        (root / name).write_bytes(b"")
    return root


class TestPreprocessNSD:
    def test_from_npz(self, tmp_path, capsys):
        rng = np.random.RandomState(0)
        npz = write_npz_dir(tmp_path / "npz", rng,
                            lambda r, s: rng.choice(1000, 7 + s, replace=False),
                            extra=["notes.txt", "shared.npz"])
        shared = tmp_path / "shared_ids.npy"
        np.save(shared, np.arange(0, 1000, 7, dtype=np.int64))
        argv = lambda out: ["from-npz", "--npz-dir", str(npz), "--shared-ids", str(shared),  # noqa: E731
                            "--out", str(tmp_path / out)]
        jout, tout = run_both(capsys, jnsd.main, tnsd.main, argv("j.pkl"), argv("t.pkl"))
        assert tout == jout.replace(str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl"))
        got, want = load(tmp_path / "t.pkl"), load(tmp_path / "j.pkl")
        assert_same(got, want)
        assert isinstance(got["shared_ids"], set)
        assert sorted(got["data"]) == sorted(REGIONS) and sorted(got["data"]["V1"]) == [0, 3, 10]

    def test_convert(self, tmp_path, capsys):
        rng = np.random.RandomState(1)
        ref = {"shared_ids": np.array([3, 1, 2], np.int64), "data": {
            r: {s: FakeDataArray(rng.choice(500, 6, replace=False),
                                 rng.randn(6, 4)) for s in (0, 1)} for r in REGIONS}}
        src = tmp_path / "ref.pkl"
        with open(src, "wb") as f:
            pickle.dump(ref, f)
        jout, tout = run_both(capsys, jnsd.main, tnsd.main,
                              ["convert", str(src), str(tmp_path / "j.pkl")],
                              ["convert", str(src), str(tmp_path / "t.pkl")])
        assert tout == jout.replace("j.pkl", "t.pkl")
        assert_same(load(tmp_path / "t.pkl"), load(tmp_path / "j.pkl"))


class TestPreprocessNSDSynthetic:
    def test_from_npz(self, tmp_path, capsys):
        rng = np.random.RandomState(2)
        pool = [f"syn_{i:03d}" for i in range(40)]
        npz = write_npz_dir(tmp_path / "npz", rng,
                            lambda r, s: list(rng.choice(pool, 37, replace=False)),
                            extra=["readme.npy"])
        jout, tout = run_both(
            capsys, jsynth.main, tsynth.main,
            ["from-npz", "--npz-dir", str(npz), "--out", str(tmp_path / "j.pkl")],
            ["from-npz", "--npz-dir", str(npz), "--out", str(tmp_path / "t.pkl")])
        assert tout == jout.replace("j.pkl", "t.pkl")
        got = load(tmp_path / "t.pkl")
        assert_same(got, load(tmp_path / "j.pkl"))
        assert 0 < len(got["shared_stimulus_names"]) < 37  # the intersection over files

    def test_convert(self, tmp_path, capsys):
        rng = np.random.RandomState(3)
        ref = {"shared_stimulus_names": np.array(["b", "a"]), "data": {
            r: {s: FakeDataArray(np.array([f"s{i}" for i in rng.permutation(5)]),
                                 rng.randn(5, 3).astype(np.float32)) for s in (2, 5)}
            for r in REGIONS}}
        src = tmp_path / "ref.pkl"
        with open(src, "wb") as f:
            pickle.dump(ref, f)
        jout, tout = run_both(capsys, jsynth.main, tsynth.main,
                              ["convert", str(src), str(tmp_path / "j.pkl")],
                              ["convert", str(src), str(tmp_path / "t.pkl")])
        assert tout == jout.replace("j.pkl", "t.pkl")
        assert_same(load(tmp_path / "t.pkl"), load(tmp_path / "j.pkl"))


def write_things(tmp_path: Path, sep: str) -> tuple[Path, Path]:
    """A SPoSE-style table (header, 66 dims, a blank line, a quoted name)
    and an object_images tree in which one concept has no folder and one
    has no images."""
    rng = np.random.RandomState(4)
    concepts = ["aardvark", "ball, red", "cat", "no_folder", "empty", "dog"]
    root = tmp_path / "object_images"
    for c in concepts:
        if c == "no_folder":
            continue
        (root / c).mkdir(parents=True)
        if c == "empty":
            (root / c / "notes.txt").write_text("x")
            continue
        for i in range(rng.randint(1, 4)):
            (root / c / f"{c}_{i:02d}{['.jpg', '.JPEG', '.png'][i % 3]}").write_bytes(b"")
        (root / c / "readme.md").write_text("x")
    lines = [sep.join(["concept"] + [f"dim{i}" for i in range(66)])]
    for c in concepts:
        vals = [repr(float(v)) for v in rng.randn(66) * 10 ** rng.uniform(-3, 3, 66)]
        name = f'"{c}"' if sep in c else c
        lines.append(sep.join([name] + vals))
        if c == "cat":
            lines.append("")
    table = tmp_path / f"spose{'.tsv' if sep == chr(9) else '.csv'}"
    table.write_text("\n".join(lines) + "\n")
    return table, root


@pytest.mark.parametrize("sep", ["\t", ","])
def test_preprocess_things(tmp_path, capsys, sep):
    table, root = write_things(tmp_path, sep)
    argv = lambda out: ["--embeddings", str(table), "--images-root", str(root),  # noqa: E731
                        "--out", str(tmp_path / out / "things_split.pkl")]
    jout, tout = run_both(capsys, jthings.main, tthings.main, argv("j"), argv("t"))
    assert tout == jout.replace(str(tmp_path / "j"), str(tmp_path / "t"))
    got = load(tmp_path / "t" / "things_split.pkl")
    assert_same(got, load(tmp_path / "j" / "things_split.pkl"))
    assert "2 concepts skipped" in tout and len(got["embeddings"]) == 4


@pytest.mark.parametrize("layout", ["3d", "flat", "flat_default_reps"])
def test_preprocess_tvsd(tmp_path, capsys, layout):
    rng = np.random.RandomState(5)
    npz = tmp_path / "npz"
    npz.mkdir()
    reps = {"3d": 4, "flat": 3, "flat_default_reps": 30}[layout]
    for region in REGIONS[:2]:
        for subj in (0, 1):
            test_ids = [f"t{i}" for i in rng.permutation(6)]
            arrays = {"train_stimulus": np.array([f"s{i}" for i in rng.permutation(9)]),
                      "train_values": rng.randn(9, 4)}
            if layout == "3d":
                arrays.update(test_stimulus=np.array(test_ids), test_values=rng.randn(6, reps, 4))
            else:  # flat: one id per row, and the first n_test ids kept
                arrays.update(test_stimulus=np.array(test_ids * reps),
                              test_values=rng.randn(6 * reps, 4))
                if layout == "flat":
                    arrays["test_repeats"] = np.array(reps)
            np.savez(npz / f"{region}_subj{subj}.npz", **arrays)
    (npz / "other.txt").write_text("x")
    argv = lambda out: ["--npz-dir", str(npz), "--out", str(tmp_path / out / "resp.pkl")]  # noqa: E731
    jout, tout = run_both(capsys, jtvsd.main, ttvsd.main, argv("j"), argv("t"))
    assert tout == jout.replace(str(tmp_path / "j"), str(tmp_path / "t"))
    got = load(tmp_path / "t" / "resp.pkl")
    assert_same(got, load(tmp_path / "j" / "resp.pkl"))
    assert got[REGIONS[0]][0]["test"]["values"].shape == (6, 4)


def test_process_cusack25(tmp_path, capsys):
    rng = np.random.RandomState(6)
    npz = write_npz_dir(tmp_path / "npz", rng, lambda r, s: [f"img{i}" for i in range(4 + s)],
                        suffix_of=lambda r, s: f"{r}_age_{s}m")
    argv = lambda out: ["--npz-dir", str(npz), "--out", str(tmp_path / out / "resp.pkl")]  # noqa: E731
    jout, tout = run_both(capsys, jcusack.main, tcusack.main, argv("j"), argv("t"))
    assert tout == jout.replace(str(tmp_path / "j"), str(tmp_path / "t"))
    got = load(tmp_path / "t" / "resp.pkl")
    assert_same(got, load(tmp_path / "j" / "resp.pkl"))
    assert sorted(got["V1_age"]) == ["0m", "10m", "3m"]  # split at the last underscore


def test_combine_fmri_responses(tmp_path, capsys):
    rng = np.random.RandomState(7)
    first = {"V1": {0: rng.randn(3)}, "shared": "first", "V2": [1, 2]}
    second = {"streams": {1: rng.randn(2)}, "shared": "second"}
    for name, d in (("a.pkl", first), ("b.pkl", second)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(d, f)
    argv = lambda out: ["--first", str(tmp_path / "a.pkl"), "--second",  # noqa: E731
                        str(tmp_path / "b.pkl"), "--output", str(tmp_path / out)]
    jout, tout = run_both(capsys, jcombine.main, tcombine.main, argv("j.pkl"), argv("t.pkl"))
    assert tout == jout.replace("j.pkl", "t.pkl")
    got = load(tmp_path / "t.pkl")
    assert_same(got, load(tmp_path / "j.pkl"))
    assert got["shared"] == "second"


@pytest.mark.parametrize("argv,rc", [
    (["--src", "host:/ckpt/base"], 0),
    (["--src", "host:/ckpt/base", "--dst", "out/", "--include", "a.pth", "b.json",
      "--dry-run"], 23),
    (["--src", "host:/x", "--include"], 1),
])
def test_copy_checkpoints(capsys, monkeypatch, argv, rc):
    calls = []

    def fake_run(cmd, *a, **k):
        calls.append(list(cmd))
        return types.SimpleNamespace(returncode=rc)

    monkeypatch.setattr(subprocess, "run", fake_run)
    outs, codes = [], []
    for main in (jcopy.main, tcopy.main):
        with pytest.raises(SystemExit) as exc:
            main(list(argv))
        codes.append(exc.value.code)
        outs.append(capsys.readouterr().out)
    assert calls[0] == calls[1] and codes == [rc, rc] and outs[0] == outs[1]
    assert calls[0][:3] == ["rsync", "-av", "--progress"]


def test_create_imagenet_labels(tmp_path, capsys):
    root = tmp_path / "train"
    for name in ("n02", "n01", "n10", "x99", "n03.txt"):
        (root / name).mkdir(parents=True) if not name.endswith(".txt") else (root / name).write_text("")
    jout, tout = run_both(capsys, jlabels.main, tlabels.main,
                          ["--imagenet-dir", str(root), "--out", str(tmp_path / "j.json")],
                          ["--imagenet-dir", str(root), "--out", str(tmp_path / "t.json")])
    assert tout == jout.replace("j.json", "t.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert json.loads((tmp_path / "t.json").read_text()) == {"n01": 0, "n02": 1, "n10": 2}


def tree(root: Path) -> dict:
    """{relative path: ("link", target) or ("file", bytes)} under root."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in filenames:
            p = Path(dirpath) / name
            rel = str(p.relative_to(root))
            out[rel] = ("link", os.readlink(p)) if p.is_symlink() else ("file", p.read_bytes())
    return out


@pytest.mark.parametrize("copy", [False, True])
def test_create_imagenet_mini(tmp_path, capsys, copy):
    """Both scripts on two copies of one tree; the port's tree equals the
    JAX script's with its root renamed, and a target that exists stays."""
    rng = np.random.RandomState(8)
    trees = {}
    for pkg, main in (("j", jmini.main), ("t", tmini.main)):
        src = tmp_path / pkg / "train"
        for c in ("n01", "n02", "n03"):
            (src / c).mkdir(parents=True)
            for i in rng.permutation(5) if pkg == "j" else range(5):
                (src / c / f"img_{i}.JPEG").write_bytes(bytes([i]) * 3)
            (src / c / "label.txt").write_text("x")
        (src / "other").mkdir()
        (src / "n04.txt").write_text("")
        keep = tmp_path / pkg / "imagenet-mini-3" / "n02"
        keep.mkdir(parents=True)
        (keep / "img_0.JPEG").write_bytes(b"kept")
        argv = ["--imagenet-dir", str(src), "--images-per-class", "3"] + (["--copy"] if copy else [])
        main(argv)
        out = capsys.readouterr().out
        assert out == f"Created {tmp_path / pkg / 'imagenet-mini-3'}: 9 images\n"
        trees[pkg] = {k: (kind, v.replace(str(tmp_path / pkg), "ROOT") if kind == "link" else v)
                      for k, (kind, v) in tree(tmp_path / pkg / "imagenet-mini-3").items()}
    assert trees["t"] == trees["j"]
    assert trees["t"]["n02/img_0.JPEG"] == ("file", b"kept") and len(trees["t"]) == 9


class _Coord:
    def __init__(self, values):
        self._values = np.asarray(values)

    def sel(self, presentation):
        return types.SimpleNamespace(values=self._values[presentation])


def fake_xarray(datasets: dict):
    """A module with ``open_dataset`` returning the stub for a path: a
    "betas" array over presentations and the three coordinates."""

    class Dataset(dict):
        def __init__(self, coords, drop=()):
            n = len(next(iter(coords.values())))
            super().__init__({"betas": types.SimpleNamespace(presentation=np.arange(n))})
            self.update({k: _Coord(v) for k, v in coords.items() if k not in drop})
            self.coords = {k: None for k in coords if k not in drop}

    mod = types.ModuleType("xarray")
    mod.open_dataset = lambda path: Dataset(*datasets[str(path)])
    return mod


def test_extract_xarray_coords(tmp_path, capsys, monkeypatch):
    rng = np.random.RandomState(9)
    n = 40
    stim = [f"stim{i:02d}" for i in rng.randint(0, 25, n)]
    subclass = [f"sub {s[-1]}" if int(s[-2:]) % 3 else f'sub, "{s[-1]}"' for s in stim]
    cls = [f"class{int(s[-2:]) % 4}" for s in stim]
    coords = {"class": cls, "subclass": subclass, "stimulus": stim}
    nc = tmp_path / "betas.nc"
    nc.write_bytes(b"")
    monkeypatch.setitem(sys.modules, "xarray", fake_xarray({
        str(nc): (coords,), str(tmp_path / "nocls.nc"): (coords, ("class",))}))
    argv = lambda out: ["--input", str(nc), "--output", str(tmp_path / out)]  # noqa: E731
    jout, tout = run_both(capsys, jcoords.main, tcoords.main, argv("j.csv"), argv("t.csv"))
    assert tout == jout.replace("j.csv", "t.csv")
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    rows = tcoords.extract(str(nc), str(tmp_path / "again.csv"))
    assert len(rows) == len(set(stim))
    with pytest.raises(KeyError, match="Coordinate 'class'"):
        tcoords.extract(str(tmp_path / "nocls.nc"), str(tmp_path / "x.csv"))
    for main in (jcoords.main, tcoords.main):
        with pytest.raises(SystemExit) as exc:
            main(["--input", str(tmp_path / "missing.nc")])
        assert exc.value.code == 1


def test_scripts_run_without_pandas_or_xarray(tmp_path):
    """``python -m`` on each script's ``--help`` in a subprocess that has
    pandas and xarray blocked: none imports either at import time."""
    mods = ["preprocess_data.preprocess_nsd", "preprocess_data.preprocess_nsd_synthetic",
            "preprocess_data.preprocess_things", "preprocess_data.preprocess_tvsd",
            "preprocess_data.process_cusack25", "combine_fmri_responses", "copy_checkpoints",
            "create_imagenet_labels", "create_imagenet_mini", "extract_xarray_coords"]
    code = ("import runpy, sys\n"
            "sys.modules['pandas'] = None\nsys.modules['xarray'] = None\nsys.modules['jax'] = None\n"
            "sys.argv = [sys.argv[1], '--help']\n"
            "try:\n    runpy.run_module(sys.argv[0], run_name='__main__')\n"
            "except SystemExit as e:\n    sys.exit(e.code)\n")
    for m in mods:
        proc = subprocess.run([sys.executable, "-c", code, f"visreps_tpu_torch.scripts.{m}"],
                              cwd=REPO, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, (m, proc.stderr)
        assert "usage:" in proc.stdout
