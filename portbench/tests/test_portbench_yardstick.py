"""The frozen arithmetic against values worked out by hand."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import cells, yardstick


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_rdm_bound_by_operations_and_by_bytes():
    # (1000, 4096) f32: 3 TF32 passes of 1000·1001·4096 over 495 TFLOP/s.
    assert yardstick.rdm_bound_s(1000, 4096, "float32") == pytest.approx(
        3 * 1000 * 1001 * 4096 / 495e12, rel=1e-12)
    assert yardstick.rdm_bound_s(1000, 4096, "float32") == pytest.approx(2.4849e-5, rel=1e-4)
    # bf16 at its own peak, one pass.
    assert yardstick.rdm_bound_s(1000, 4096, "bfloat16") == pytest.approx(4.1459e-6, rel=1e-4)
    # (100, 4096) f32 is bound by bytes: rows in, stds in, RDM out.
    nbytes = 100 * 4096 * 4 + 4 * 100 + 4 * 100 * 100
    assert yardstick.rdm_bound_s(100, 4096, "float32") == pytest.approx(nbytes / 3.35e12)


def test_ridge_ops_small_case_by_hand():
    # n = 10 rows in 5 folds of 2, d = 2, v = 1, 20 alphas.
    sweep, f32 = yardstick.wood_cv_ops(10, 2, 1)
    assert sweep == 5 * 20 * 2.0 * (2 * 2 * 1 + 2 * 2 * 2 * 1)
    assert f32 == 2.0 * 4 + 5 * (2.0 * (4 * 2 + 2 * 2) + 20 * 2.0 * (4 * 2 + 8))
    sweep2, f32_2 = yardstick.ridge_ops(10, 2, 1, 3)
    assert sweep2 == sweep
    assert f32_2 == pytest.approx(f32 + 2.0 * (10 * 4 + 10 * 2 + 2 * 4 + 3 * 2) + 10 / 3 * 8)
    assert yardstick.kfold_bounds(11, 5) == [(0, 3), (3, 5), (5, 7), (7, 9), (9, 11)]
    high = yardstick.ops_bound([(10, 2, 1, 3)], "high")
    assert high == pytest.approx(sweep / 495e12 + f32_2 / 67e12)
    assert yardstick.ops_bound([(10, 2, 1, 3)], "highest") == pytest.approx(
        (sweep + f32_2) / 67e12)


def _conv(hw, cin, cout, k):
    return 2 * hw * hw * cin * cout * k * k


def test_forward_ops_by_hand():
    vgg = (_conv(224, 3, 64, 3) + _conv(224, 64, 64, 3) + _conv(112, 64, 128, 3)
           + _conv(112, 128, 128, 3) + _conv(56, 128, 256, 3) + 2 * _conv(56, 256, 256, 3)
           + _conv(28, 256, 512, 3) + 2 * _conv(28, 512, 512, 3) + 3 * _conv(14, 512, 512, 3)
           + 2 * (25088 * 4096 + 4096 * 4096 + 4096 * 1000))
    assert yardstick.forward_ops(cells.find("models", "vgg16").build()) == vgg
    alex = (_conv(55, 3, 64, 11) + _conv(27, 64, 192, 5) + _conv(13, 192, 384, 3)
            + _conv(13, 384, 256, 3) + _conv(13, 256, 256, 3)
            + 2 * (9216 * 4096 + 4096 * 4096 + 4096 * 1000))
    assert yardstick.forward_ops(cells.find("models", "alexnet").build()) == alex


@pytest.mark.parametrize("config,srp_gflop", [("vgg16", 221.96256768), ("alexnet", 7.946108928)])
def test_srp_ops_of_each_model(config, srp_gflop):
    """2·D·k over the taps wider than k = 4096, one image."""
    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / f"{config}.json").read_text())
    model = cells.find("models", cfg["model"])
    with torch.device("meta"):
        meta = model.build()
    taps = model.taps(meta, torch.empty((1, 3, 224, 224), device="meta"), cfg["taps"])
    widths = [t.shape[1] for t in taps.values()]
    ops = sum(yardstick.srp_ops(d, 4096) for d in widths if d > 4096)
    assert ops / 1e9 == pytest.approx(srp_gflop, rel=1e-12)
    if config == "vgg16":  # 4 taps each of conv1-2, conv3-4; 6 of conv5-7, 8-10, 11-13
        assert ops == 8192 * (4 * 3211264 + 4 * 1605632 + 6 * 802816 + 6 * 401408
                              + 6 * 100352)


def test_summarize_trace_by_hand(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 30, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "host_wait", "ts": 19, "dur": 12},
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 50},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = yardstick.summarize_trace(path)
    assert s["window_s"] == pytest.approx(50e-6)
    assert s["busy_s"] == pytest.approx(30e-6)      # [0, 20] and [30, 40]
    assert s["op_s"] == pytest.approx({"a": 10e-6, "b": 15e-6, "c": 10e-6})
    assert s["top_ops"][0] == ("b", pytest.approx(15e-6))
    # gaps [20, 30] (host_wait covers it all: the shortest full cover) and [40, 50]
    assert s["gaps"] == [("host_wait", pytest.approx(10e-6)), ("outer", pytest.approx(10e-6))]
