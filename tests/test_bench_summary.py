"""The printed bench summary must stay parseable and name its device.

The compact line built by bench.build_summaries is pinned to a size
budget with a full complement of workloads, to carrying the fields the
gates read (vs_baseline_median per workload), and to naming the device
(platform, device_kind, count, the card's name and power limit).
"""

import importlib.util
import json
import pathlib

import pytest


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "benchmod", pathlib.Path(__file__).parent.parent / "bench.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_workload(eps=24_893_309, base=7_723_054):
    return {
        "examples_per_sec": eps,
        "examples_per_sec_median": round(eps * 0.9),
        "vs_baseline": round(eps / base, 2),
        "vs_baseline_median": round(eps * 0.9 / base, 2),
        "reps": 8,
        "best_s": 0.1517,
        "median_s": 0.1686,
        "spread": 1.31,
        "final_rmse": 0.93329,
        "golden_rmse": 0.932842,
        "rmse_delta": 0.00045,
        "rmse_band": 0.005,
        "rmse_ok": True,
        "traffic_model_mb_per_round": 2.17,
        "achieved_gb_per_sec": 0.26,
        "pct_hbm_peak": 0.03,
        "bound": "sequential batch scan, small tables",
    }


def _fake_results(bench):
    w = {k: _fake_workload() for k in (
        "basicMF", "neighborhoodModel", "binaryClassification",
        "implicitFeedback", "pairwiseRank", "bigTable", "bigSvdpp",
        "bigRank",
    )}
    w["pairwiseRank"].update(precision_at_20=0.16479,
                             golden_precision_at_20=0.1651, p20_ok=True)
    w["bigTable"].update(learning_ok=True, table_rows=2_048_576)
    w["bigRank"].update(learning_ok=True, pair_order_acc=0.999,
                        pairs_per_round=1_500_000)
    imfb = _fake_workload()
    imfb.update({
        "stacked_examples_per_sec": 6_000_000,
        "stacked_examples_per_sec_median": 5_400_000,
        "stacked_vs_baseline": 6.49,
        "stacked_vs_baseline_median": 5.84,
        "stacked_spread": 1.4,
        "stacked_reps": 8,
        "stacked_rmse_ok": True,
        "vs_svdpp": 1.114,
    })
    w["multiIMFB"] = imfb
    return w


DEVICE = {
    "platform": "gpu",
    "kind": "NVIDIA H100 80GB HBM3",
    "count": 1,
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
}


def test_compact_line_fits_tail_window(bench):
    w = _fake_results(bench)
    full, out = bench.build_summaries(w, DEVICE, incomplete=False)
    line = json.dumps(out)
    assert len(line) < 2000, (len(line), line)
    back = json.loads(line)
    assert back["vs_baseline_median"] > 0
    assert back["device"] == DEVICE
    for key, c in back["workloads"].items():
        assert "med" in c and c["med"], key
        if key != "multiIMFB":
            assert "vsm" in c, key
        assert "ok" in c, key
    assert back["workloads"]["multiIMFB"]["st_vsm"] == 5.84
    # the full sidecar keeps everything
    assert full["workloads"]["basicMF"]["best_s"] == 0.1517
    assert full["device"] == DEVICE


def test_compact_line_survives_partial_results(bench):
    # a run with one workload measured must still print cleanly
    full, out = bench.build_summaries(
        {"bigTable": _fake_workload()}, DEVICE, incomplete=True,
    )
    line = json.dumps(out)
    assert len(line) < 800
    assert json.loads(line)["bench_incomplete"] is True
    assert json.loads(line)["device"]["kind"] == DEVICE["kind"]


@pytest.mark.parametrize("reps", [1, 3])
def test_timed_reps_counts_reps(bench, monkeypatch, reps):
    monkeypatch.setattr(bench, "REPS", reps)
    calls = []
    stats = bench.timed_reps(lambda: calls.append(1))
    assert stats["reps"] == reps and len(calls) == reps
    assert stats["best_s"] <= stats["median_s"]


def test_timed_reps_setup_untimed(bench, monkeypatch):
    import time as _t

    monkeypatch.setattr(bench, "REPS", 2)
    stats = bench.timed_reps(lambda: None, setup=lambda: _t.sleep(0.05))
    # staging (50 ms/rep) must not show up in the timed window
    assert stats["best_s"] < 0.02, stats


def test_peaks_of_the_h100(bench):
    pk = bench.peaks_for("NVIDIA H100 80GB HBM3")
    assert pk["hbm_gbps"] == 3350.0 and pk["bf16_tflops"] == 989.0
    assert "source" in pk


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "cpu"])
def test_unknown_device_has_no_peaks(bench, kind):
    with pytest.raises(RuntimeError, match="no published peaks"):
        bench.peaks_for(kind)


def test_bench_refuses_the_cpu(bench):
    with pytest.raises(RuntimeError, match="measures the GPU"):
        bench.device_info()


def test_roofline_share_of_hbm_peak(bench):
    r = bench.roofline(3.35e9, 2, 2.0, "x", hbm_gbps=3350.0)
    assert r["achieved_gb_per_sec"] == 3.35
    assert r["pct_hbm_peak"] == 0.1
