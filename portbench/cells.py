"""A cell's files, found by name.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Everything
else is a file of its own, found by a name in the cell's data:

  * the configuration's file (``configs`` in ``BENCHMARK.json``), whose
    ``model`` names ``models/<model>.py``;
  * the traffic mix ``traffic/<mix>.json``, whose ``dataset`` names
    ``datasets/<dataset>.py`` and whose ``reference`` names
    ``analyses/<reference>.py``;
  * each per-layer metric's reader ``metrics/<metric>.py``;
  * every probe in ``probes/`` (installed in ``--trace 1`` runs);
  * the cell's limits ``limits/<cell>.json``.

Nothing here imports the program.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
_LOADED: dict = {}


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of the tree at ``root``: its configuration's and
    traffic mix's keys merged, with ``name``, ``config``, ``traffic``,
    ``chips``, the cell's ``end_to_end`` and ``per_layer`` metric
    entries, ``limits``, the fixture's directory and ``root``."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {**config, **traffic, "name": name, "config": w["config"], "traffic": w["traffic"],
            "chips": w["chips"],
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)],
            "limits": json.loads((root / "portbench" / "limits" / f"{name}.json").read_text()),
            "fixture_dir": str(root / "portbench" / "_data" / w["traffic"]), "root": str(root)}


def find(kind: str, name: str, root: Path = ROOT):
    """The module ``portbench/<kind>/<name>.py`` of the tree at ``root``."""
    path = (Path(root) / "portbench" / kind / f"{name}.py").resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        mod_name = f"portbench_{kind}_{name}_{len(_LOADED)}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def model(cell: dict):
    return find("models", cell["model"], cell["root"])


def dataset(cell: dict):
    return find("datasets", cell["dataset"], cell["root"])


def analysis(cell: dict):
    return find("analyses", cell["reference"], cell["root"])


def probe_names(root: Path = ROOT) -> list[str]:
    return sorted(p.stem for p in (Path(root) / "portbench" / "probes").glob("*.py"))
