"""The plain reference's pieces: ranks, RDMs, the frozen SRP rule and the
selection plan, each against an independent computation (the last two
against the program, whose rule they freeze)."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.stats import rankdata

from portbench import reference, srp_rule

BENCH = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_average_ranks_match_scipy():
    v = np.random.RandomState(0).randint(0, 7, size=(5, 40)).astype(np.float64)
    got = reference.average_ranks(torch.from_numpy(v)).numpy()
    assert np.array_equal(got, np.stack([rankdata(row) for row in v]))


def test_ordinal_ranks_break_ties_by_position():
    v = torch.tensor([3.0, 1.0, 3.0, 2.0], dtype=torch.float64)
    assert reference.ordinal_ranks(v).tolist() == [2.0, 0.0, 3.0, 1.0]


def test_rdm_triangle_is_one_minus_corrcoef():
    x = np.random.RandomState(1).standard_normal((9, 70000)).astype(np.float32)
    want = 1.0 - np.corrcoef(x.astype(np.float64))[np.triu_indices(9, 1)]
    got = reference.rdm_triangle(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("d,k", [(1000, 64), (70, 64), (40000, 16)])
def test_srp_rule_is_the_programs(d, k):
    from visreps_tpu_torch.ops.srp import SRPTransform

    seed = 2**31 + 7
    mine = srp_rule.matrix_chunks(d, k, seed, "cpu")
    theirs = SRPTransform(k=k, seed=seed, device="cpu").matrix_chunks(d)
    assert len(mine) == len(theirs)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    x = torch.randn(3, d, generator=torch.Generator().manual_seed(0))
    from visreps_tpu_torch.ops.srp import apply_chunked

    assert torch.equal(srp_rule.project(x, mine), apply_chunked(x, theirs))


def test_bootstrap_sets_are_the_programs():
    from visreps_tpu_torch.ops.bootstrap import bootstrap_indices

    assert np.array_equal(reference.bootstrap_index_sets(50, 30), bootstrap_indices(50, 30))


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


REFERENCE_SIDE = ["reference.py", "srp_rule.py", "weights.py", "cells.py", "yardstick.py"] + [
    f"{kind}/{p.name}" for kind in ("analyses", "datasets", "models")
    for p in sorted((BENCH / kind).glob("*.py"))]


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_reference_side_imports_nothing_of_the_program(name):
    assert not _imports(BENCH / name) & {"jax", "jaxlib", "flax", "visreps_tpu",
                                         "visreps_tpu_torch"}


def test_nothing_in_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "visreps_tpu"}, path
