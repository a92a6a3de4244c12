"""Config parser parity tests (apex-utils/apex_config.h semantics)."""

from svdfeature_tpu.config import ConfigReader, ConfigSaver
from svdfeature_tpu.params import SVDModelParam, SVDTrainParam, SVDTypeParam
from tests.conftest import DEMO


def test_parse_basic():
    text = """
# comment
base_score = 3
learning_rate = 0.005  # trailing comment
test:buffer_feature="ua.test.buffer"
model_out_folder="./"
"""
    items = ConfigReader(text=text).items()
    assert ("base_score", "3") in items
    assert ("learning_rate", "0.005") in items
    assert ("test:buffer_feature", "ua.test.buffer") in items
    assert ("model_out_folder", "./") in items


def test_parse_quoted_escape():
    items = ConfigReader(text=r'name = "a\"b c"').items()
    assert items == [("name", 'a"b c')]


def test_parse_no_spaces():
    assert ConfigReader(text="a=1\nb=2").items() == [("a", "1"), ("b", "2")]


def test_parse_reference_demo_confs():
    """The demo confs keep the reference's syntax and keys."""
    confs = sorted(DEMO.glob("*/*.conf"))
    assert [c.stem for c in confs] == [
        "basicMF", "binaryClassification", "implicitFeedback",
        "neighborhoodModel", "pairwiseRank",
    ]
    for conf in confs:
        items = dict(ConfigReader(str(conf)).items())
        assert items["num_user"] == "943"
        assert items["num_item"] == "1682"
        assert items["num_factor"] == "64"


def test_saver_priority_and_replay():
    cfg = ConfigSaver()
    cfg.push_back("learning_rate", "0.1")
    cfg.push_back("num_user", "10")
    cfg.load_cli(["learning_rate=0.5", "num_item=7"])
    tp, mp = SVDTrainParam(), SVDModelParam()
    cfg.replay(tp, mp)
    assert tp.learning_rate == 0.5  # CLI override wins (replayed last)
    assert mp.num_user == 10 and mp.num_item == 7
    assert cfg.get("learning_rate") == "0.5"


def test_type_param_decide_format():
    t = SVDTypeParam()
    t.set_param("extend_type", "1")
    t.decide_format()
    assert t.format_type == 1  # USER_GROUP for extended solvers
    t2 = SVDTypeParam()
    t2.decide_format()
    assert t2.format_type == 0


def test_unknown_keys_ignored():
    mp = SVDModelParam()
    mp.set_param("nonsense_key", "42")
    assert mp.num_user == 0


def test_bench_rmse_bands_flip_on_drift():
    """bench.py's RMSE gates are per-workload bands tight enough that a
    real 0.01 drift flips rmse_ok to False (round-3 verdict: the old
    flat 0.02 band passed a ~0.01 drift on the perf number of record)."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "benchmod", pathlib.Path(__file__).parent.parent / "bench.py"
    )
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for key, band in bench.RMSE_BANDS.items():
        assert band < 0.01, key
        want = 0.9328
        ok = bench.rmse_gate(key, want + 0.0001, want)
        assert ok["rmse_ok"] and ok["rmse_delta"] == 0.0001, key
        drift = bench.rmse_gate(key, want + 0.01, want)
        assert not drift["rmse_ok"], key
        assert drift["rmse_band"] == band
