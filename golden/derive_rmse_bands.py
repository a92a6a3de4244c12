"""Derive the per-workload RMSE bands for bench.py's quality gates.

For each RMSE-gated bench workload this runs the EXACT bench
configuration at N seeds (the bench's default seed 10 first) on the
current default device, and derives

    band = max(K_SPREAD * (max - min over seeds),
               K_DELTA  * |rmse(seed=10) - reference golden|)

rounded up to 1e-4 — i.e. the gate is sized from measured seed/init
variance AND the measured deterministic path delta (batched/multirow
trajectory vs the reference's sequential SGD), not chosen to fit a
drift after the fact.  Results (band + the full seed table + the
constants) are written into golden/GOLDEN.json under
``<workload>.rmse_band`` / ``rmse_band_provenance``; bench.py reads
bands from there.

Run from the repository root on the device whose path is gated:
  python golden/derive_rmse_bands.py
"""

import gzip
import json
import math
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(ROOT))

SEEDS = [10, 1, 2, 3, 4, 5]  # 10 = the solvers' default
K_SPREAD = 2.0
K_DELTA = 1.5
ROUNDS = 40


def main():
    import jax

    from svdfeature_tpu.data.text import load_feature_text, load_plus_text
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    golden = json.load(open(ROOT / "golden" / "GOLDEN.json"))

    def fx(name):
        with gzip.open(ROOT / "tests/fixtures" / name, "rt") as f:
            return f.read()

    def rmse(pred, labels):
        d = np.asarray(pred) - np.asarray(labels)
        return float(np.sqrt(np.mean(d * d)))

    BASIC = [
        ("base_score", "3"), ("learning_rate", "0.005"),
        ("wd_item", "0.004"), ("wd_user", "0.004"),
        ("num_item", "1682"), ("num_user", "943"),
        ("num_global", "0"), ("num_factor", "64"),
    ]

    def run(cls, mtype_kw, params, tds, eds, seed, plus=False):
        tr = cls(SVDTypeParam(**mtype_kw))
        for n, v in params + [("seed", str(seed))]:
            tr.set_param(n, str(v))
        tr.init_model()
        tr.init_trainer()
        tr.update_rounds(tds, ROUNDS)
        jax.block_until_ready(tr.state)
        labels = eds.rows.labels if plus else eds.labels
        return rmse(tr.predict_all(eds), labels)

    jobs = {}
    jobs["basicMF"] = (
        SVDFeatureTrainer, {}, BASIC + [("batch_size", "4096")],
        load_feature_text("x", text=fx("ml100k.base.feature.gz")),
        load_feature_text("x", text=fx("ml100k.test.feature.gz")),
        False, golden["basicMF"]["final_rmse"],
    )
    jobs["neighborhoodModel"] = (
        SVDFeatureTrainer, {},
        [kv for kv in BASIC if kv[0] != "num_global"]
        + [("num_global", "6"), ("wd_global", "0.001"),
           ("batch_size", "4096")],
        load_feature_text("x", text=fx("ml100k.base.nb.feature.gz")),
        load_feature_text("x", text=fx("ml100k.test.nb.feature.gz")),
        False, golden["neighborhoodModel"]["final_rmse"],
    )
    jobs["binaryClassification"] = (
        SVDFeatureTrainer, dict(active_type=2),
        [kv for kv in BASIC if kv[0] != "base_score"]
        + [("base_score", "0.5"), ("active_type", "2"),
           ("batch_size", "4096")],
        load_feature_text("x", text=fx("ml100k.base.bin.feature.gz")),
        load_feature_text("x", text=fx("ml100k.test.bin.feature.gz")),
        False, golden["binaryClassification"]["final_rmse"],
    )
    jobs["implicitFeedback"] = (
        SVDPPFeatureTrainer, dict(format_type=1),
        BASIC + [("wd_ufeedback", "0.004"), ("num_ufeedback", "1682"),
                 ("sort_blocks", "1"), ("rows_per_user", "8")],
        load_plus_text("x", "y", text=fx("ml100k.base.group.feature.gz"),
                       feedback_text=fx("ml100k.base.feedback.gz")),
        load_plus_text("x", "y", text=fx("ml100k.test.ug.feature.gz"),
                       feedback_text=fx("ml100k.test.feedback.gz")),
        True, float(golden["implicitFeedback"]["rmse_per_round"]["40"]),
    )

    for key, (cls, mk, pp, tds, eds, plus, want) in jobs.items():
        t0 = time.time()
        seed_rmses = {}
        for s in SEEDS:
            seed_rmses[str(s)] = round(run(cls, mk, pp, tds, eds, s, plus), 6)
        vals = list(seed_rmses.values())
        spread = max(vals) - min(vals)
        delta = abs(seed_rmses[str(SEEDS[0])] - want)
        band = max(K_SPREAD * spread, K_DELTA * delta)
        band = math.ceil(band * 1e4) / 1e4
        golden[key]["rmse_band"] = band
        golden[key]["rmse_band_provenance"] = {
            "seeds": seed_rmses,
            "seed_spread": round(spread, 6),
            "delta_to_golden_seed10": round(delta, 6),
            "rule": f"ceil(max({K_SPREAD}*seed_spread, "
                    f"{K_DELTA}*|delta|), 1e-4)",
            "rounds": ROUNDS,
            "golden_rmse": want,
        }
        print(json.dumps({key: {"band": band, "spread": round(spread, 6),
                                "delta": round(delta, 6),
                                "s": round(time.time() - t0, 1)}}), flush=True)

    json.dump(golden, open(ROOT / "golden" / "GOLDEN.json", "w"), indent=1)
    print("GOLDEN.json updated")


if __name__ == "__main__":
    main()
