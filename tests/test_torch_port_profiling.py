"""The port's tracing and phase timing (``visreps_tpu_torch/core/
profiling.py``) on the CPU: ``PhaseTimer.summary()`` equals the JAX
package's for the same phases; ``trace`` writes a Chrome trace that
loads and holds the traced work (with the loaders' ``loader_wait``
label); ``summarize_trace`` on a hand-made trace gives the busy share,
top device operations and idle gaps worked out by hand.
"""
import json

import numpy as np
import pytest
import torch

from visreps_tpu.core.profiling import PhaseTimer as JaxPhaseTimer

from visreps_tpu_torch.core.profiling import PhaseTimer, summarize_trace, trace
from visreps_tpu_torch.data.loader import PrefetchLoader
from visreps_tpu_torch.models.extractor import FeatureExtractor

PHASES = {"model_load": (0.6316, 0), "extraction": (0.5626, 3000),
          "a phase with a long name, cut": (12.5, 7), "empty": (0.0, 5)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_phase_timer_summary_matches_jax():
    t, j = PhaseTimer(), JaxPhaseTimer()
    t.phases, j.phases = dict(PHASES), dict(PHASES)
    assert t.summary() == j.summary()
    lines = t.summary().splitlines()
    assert len(lines) == len(PHASES) + 2 and lines[-1].startswith("TOTAL")


def test_phase_timer_accumulates():
    t, j = PhaseTimer(), JaxPhaseTimer()
    for timer in (t, j):
        for items in (3, 4):
            with timer.phase("decode", items=items):
                pass
        with pytest.raises(ValueError):
            with timer.phase("failing", items=1):
                raise ValueError
    assert {k: v[1] for k, v in t.phases.items()} == {k: v[1] for k, v in j.phases.items()} \
        == {"decode": 7, "failing": 1}
    t.phases = {k: (1.0, n) for k, (_, n) in t.phases.items()}
    j.phases = {k: (1.0, n) for k, (_, n) in j.phases.items()}
    assert t.summary() == j.summary()


class Tiny(torch.nn.Module):
    TAPS = {"conv": ("conv",)}

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3)

    def forward(self, x, capture=()):
        y = self.conv(x)
        return y, {"conv": y} if "conv" in capture else {}


class Batches:
    """A dataset of random 16 px uint8 images."""

    def __init__(self, n):
        self.x = np.random.RandomState(0).randint(0, 256, (n, 16, 16, 3)).astype(np.uint8)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], f"s{i}"


def test_trace_writes_a_readable_chrome_trace(tmp_path):
    """A traced CPU extraction: the file loads as JSON, holds the
    convolutions and the loader's wait; with no device events the busy
    share is 0 and the whole window is one idle gap."""
    ext = FeatureExtractor(Tiny(), ["conv"], extract_pre_and_post=False, srp_k=8,
                           image_size=16, device="cpu")
    with trace(tmp_path / "traces") as path:
        ext.get_activations(PrefetchLoader(Batches(12), batch_size=4, num_workers=2),
                            store="host")
    assert path.parent == tmp_path / "traces" and path.is_file()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::conv2d" in names and "loader_wait" in names
    s = summarize_trace(path)
    assert s["n_device_events"] == 0 and s["busy_share"] == 0.0 and s["top_ops"] == []
    assert s["window_ms"] > 0 and len(s["gaps"]) == 1
    assert s["gaps"][0]["ms"] == pytest.approx(s["window_ms"])
    assert s["gaps"][0]["host_op"] is not None


def test_summarize_trace_by_hand(tmp_path):
    """Window 0–100 µs; device busy 10–30 (a kernel and an overlapping
    memcpy), 50–60 and 60–70 (touching): 40 µs, share 0.4; idle gaps
    0–10, 30–50, 70–100; the host op across 30–50 is the innermost of
    those overlapping it most."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "loader_wait", "ts": 28, "dur": 24},
        {"ph": "X", "cat": "cpu_op", "name": "inner", "ts": 35, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 20, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "label", "ts": 0, "dur": 90},
        {"ph": "i", "cat": "instant", "name": "marker", "ts": 500},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = summarize_trace(path, top=2)
    assert s["window_ms"] == pytest.approx(0.1) and s["device_busy_ms"] == pytest.approx(0.04)
    assert s["busy_share"] == pytest.approx(0.4) and s["n_device_events"] == 4
    assert s["top_ops"] == [{"name": "gemm", "ms": pytest.approx(0.025), "count": 2},
                            {"name": "Memcpy HtoD", "ms": pytest.approx(0.01), "count": 1}]
    assert [(g["start_ms"], g["ms"]) for g in s["gaps"]] == \
        [pytest.approx((0.07, 0.03)), pytest.approx((0.03, 0.02))]
    assert s["gaps"][0]["host_op"] == {"name": "outer", "overlap_ms": pytest.approx(0.03)}
    assert s["gaps"][1]["host_op"] == {"name": "loader_wait", "overlap_ms": pytest.approx(0.02)}
    with pytest.raises(ValueError, match="no timed events"):
        (tmp_path / "empty.json").write_text("[]")
        summarize_trace(tmp_path / "empty.json")
