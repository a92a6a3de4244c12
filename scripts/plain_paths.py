"""Times the plain XLA paths that carry the trainer on the GPU, reads a
profiler trace of each, and A/Bs the two scatter forms of the small
tables.

The paths, at the bench shapes (bench.py):

  demo cells   basicMF / neighborhoodModel / binaryClassification: 40
               rounds, B=4096, one lax.scan of ops/embed.train_step per
               round dispatch (update_rounds);
  SVD++ cells  implicitFeedback (sort_blocks=1, rows_per_user=8) and
               stacked multiIMFB: 40 rounds of the chunk-carried epoch;
               pairwiseRank: 40 rounds of the multi-round pair dispatch
               (K=8 plain epochs per dispatch);
  big tables   bigTable (2M rows, B=2^20): the sorted-dedup step with
               its .at[].set row write; bigSvdpp (2.25M rows, G=4096 x
               M=4): the augmented user-carry epoch.

For each: best and median of REPS timed runs (each ending in
jax.block_until_ready), then one traced run reduced to device busy
time, idle share and the device time per kernel class (sort, scatter,
gather, matmul, reduce, elementwise fusion, copy).

The A/B runs basicMF and implicitFeedback with the one-hot form forced
on and off (backend.override; both at Precision.HIGHEST) in the order
A B B A, in this one process.

--big-ab instead compares three forms of the big tables, each in turn
(A B C C B A): the sorted-dedup step on rows aligned to 8 floats (the
layout, ops/big_embed.ROW_ALIGN), the same step on rows aligned to 128
floats, and the generic step (standard [N, k] layout, .at[].add
scatters; the solver with its big-table path switched off).  bigTable
runs 5 rounds of the full synthetic; the generic SVD++ epoch packs a
dense [G+1, G+1] overlap per chunk on the host, so bigSvdpp runs 3
rounds of the first 4 chunks (16,384 users).

Usage (on a machine with a GPU):
  python scripts/plain_paths.py [--quick | --big-ab] [--out DIR]
--quick runs basicMF only (a first check of the script on the card).
Writes DIR/plain_paths.json (DIR/big_ab.json with --big-ab; default
perf_out/, listed in .gitignore) and prints a summary.
"""

import argparse
import gzip
import json
import os
import pathlib
import re
import statistics
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = int(os.environ.get("PLAIN_REPS", "3"))
ROUNDS = 40

# kernel-name classes, first match wins
STAGES = [
    ("sort", re.compile(r"sort|radix|cub::", re.I)),
    ("scatter", re.compile(r"scatter", re.I)),
    ("gather", re.compile(r"gather|dynamic.slice", re.I)),
    ("matmul", re.compile(r"gemm|dot|cublas|cutlass|matmul|triton", re.I)),
    ("reduce", re.compile(r"reduce|reduction", re.I)),
    ("copy", re.compile(r"copy|memcpy|memset|transpose", re.I)),
    ("fusion", re.compile(r"fusion|loop|input", re.I)),
]


def stage_of(name):
    for stage, pat in STAGES:
        if pat.search(name):
            return stage
    return "other"


def reduce_trace(trace_dir, structure_out=None):
    """Device busy time, idle share and per-class kernel time from the
    .xplane.pb a jax.profiler trace wrote under trace_dir."""
    import jax

    paths = sorted(pathlib.Path(trace_dir).rglob("*.xplane.pb"))
    if not paths:
        return {"error": "no xplane.pb"}
    pd = jax.profiler.ProfileData.from_file(str(paths[-1]))
    lines_out = []
    events = []
    for plane in pd.planes:
        lines = list(plane.lines)
        lines_out.append(f"plane {plane.name!r}: " + ", ".join(
            f"{ln.name!r}" for ln in lines))
        if not plane.name.startswith("/device:GPU:0"):
            continue
        streams = [ln for ln in lines if "stream" in ln.name.lower()]
        for ln in streams or [ln for ln in lines if ln.name == "XLA Ops"]:
            for ev in ln.events:
                if ev.duration_ns > 0:
                    events.append((ev.start_ns, ev.duration_ns, ev.name))
    if structure_out is not None:
        names = sorted({e[2] for e in events})
        structure_out.write_text("\n".join(lines_out) + "\n\nkernel names:\n"
                                 + "\n".join(names[:400]) + "\n")
    if not events:
        return {"error": "no GPU events"}
    events.sort()
    t0 = events[0][0]
    t1 = max(s + d for s, d, _ in events)
    busy = 0
    cur_s, cur_e = events[0][0], events[0][0] + events[0][1]
    for s, d, _ in events[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    busy += cur_e - cur_s
    by_stage, by_name = {}, {}
    for _, d, n in events:
        st = stage_of(n)
        by_stage[st] = by_stage.get(st, 0) + d
        by_name[n] = by_name.get(n, 0) + d
    total = sum(by_stage.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "window_ms": round((t1 - t0) / 1e6, 3),
        "busy_ms": round(busy / 1e6, 3),
        "idle_share": round(1 - busy / max(t1 - t0, 1), 4),
        "kernels": len(events),
        "stage_ms": {k: round(v / 1e6, 3) for k, v in
                     sorted(by_stage.items(), key=lambda kv: -kv[1])},
        "stage_share": {k: round(v / max(total, 1), 4) for k, v in
                        sorted(by_stage.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [(n[:90], round(v / 1e6, 3)) for n, v in top],
    }


def fixture(name):
    with gzip.open(ROOT / "tests" / "fixtures" / name, "rt") as f:
        return f.read()


def make(cls, mtype_kw, params, generic=False):
    from svdfeature_tpu.params import SVDTypeParam

    tr = cls(SVDTypeParam(**mtype_kw))
    if generic:  # standard layout and scatter-add step at any table size
        tr.SUPPORTS_BIG_TABLE = False
    for n, v in params:
        tr.set_param(n, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


def rmse(pred, labels):
    import numpy as np

    d = np.asarray(pred, np.float64) - np.asarray(labels, np.float64)
    return float(np.sqrt(np.mean(d * d)))


BASIC = [
    ("base_score", "3"), ("learning_rate", "0.005"),
    ("wd_item", "0.004"), ("wd_user", "0.004"),
    ("num_item", "1682"), ("num_user", "943"),
    ("num_global", "0"), ("num_factor", "64"),
]


class Workload:
    """build() -> (trainer, data) untimed; run(tr, data) timed."""

    def __init__(self, name, build, run, examples, check=None):
        self.name, self.build, self.run = name, build, run
        self.examples, self.check = examples, check


def demo_workloads():
    from svdfeature_tpu.data.text import load_feature_text, load_plus_text
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    out = []
    for name, train, test, extra, mt in [
        ("basicMF", "ml100k.base.feature.gz", "ml100k.test.feature.gz", [], {}),
        ("neighborhoodModel", "ml100k.base.nb.feature.gz",
         "ml100k.test.nb.feature.gz",
         [("num_global", "6"), ("wd_global", "0.001")], {}),
        ("binaryClassification", "ml100k.base.bin.feature.gz",
         "ml100k.test.bin.feature.gz",
         [("base_score", "0.5"), ("active_type", "2")], dict(active_type=2)),
    ]:
        tds = load_feature_text("x", text=fixture(train))
        eds = load_feature_text("x", text=fixture(test))
        p = [kv for kv in BASIC if kv[0] not in dict(extra)] + extra + [
            ("batch_size", "4096")]

        def build(p=p, mt=mt, tds=tds):
            tr = make(SVDFeatureTrainer, mt, p)
            tr._pack(tds)
            return tr, tds

        out.append(Workload(
            name, build, lambda tr, d: tr.update_rounds(d, ROUNDS),
            ROUNDS * tds.num_row,
            check=lambda tr, eds=eds: rmse(tr.predict_all(eds), eds.labels)))

    pds = load_plus_text("x", "y", text=fixture("ml100k.base.group.feature.gz"),
                         feedback_text=fixture("ml100k.base.feedback.gz"))
    eds = load_plus_text("x", "y", text=fixture("ml100k.test.ug.feature.gz"),
                         feedback_text=fixture("ml100k.test.feedback.gz"))
    pp = BASIC + [("wd_ufeedback", "0.004"), ("num_ufeedback", "1682"),
                  ("sort_blocks", "1"), ("rows_per_user", "8")]

    def build_ifb():
        tr = make(SVDPPFeatureTrainer, dict(format_type=1), pp)
        tr._pack_plus(pds)
        return tr, pds

    out.append(Workload(
        "implicitFeedback", build_ifb, lambda tr, d: tr.update_rounds(d, ROUNDS),
        ROUNDS * pds.rows.num_row,
        check=lambda tr: rmse(tr.predict_all(eds), eds.rows.labels)))

    from svdfeature_tpu.data.rank import PairSource
    from svdfeature_tpu.data.registry import IteratorConfig

    rtrain = load_plus_text("x", "y", text=fixture("ml100k.rank.base.feature.gz"),
                            feedback_text=fixture("ml100k.rank.base.feedback.gz"),
                            scale_score=5)
    rp = [("learning_rate", "0.005"), ("wd_user", "0.004"), ("wd_item", "0.004"),
          ("num_user", "943"), ("num_item", "1682"), ("num_global", "0"),
          ("num_factor", "64"), ("active_type", "3"), ("num_ufeedback", "1682"),
          ("wd_ufeedback", "0.004"), ("no_user_bias", "1")]
    n_pairs = PairSource(rtrain, IteratorConfig()).epoch_dataset().rows.num_row

    def build_rank():
        src = PairSource(rtrain, IteratorConfig(), seed=10)
        tr = make(SVDPPFeatureTrainer, dict(format_type=1, active_type=3), rp)
        tr._apply_pair_layout()
        assert tr._pair_multi_ok(src)
        return tr, src

    out.append(Workload("pairwiseRank", build_rank,
                        lambda tr, d: tr.update_rounds(d, ROUNDS), ROUNDS * n_pairs))
    return out


def big_workloads(bench):
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    bds, dims = bench.make_big_table()
    tb = make(SVDFeatureTrainer, {}, bench.big_table_params(dims))
    tb._pack(bds)
    pds, pdims = bench.make_big_plus()
    tp = make(SVDPPFeatureTrainer, dict(format_type=1), bench.big_plus_params(pdims))
    tp._pack_plus(pds)
    return [
        # one trainer reused across reps (like the bench): continued
        # rounds are the steady state at this scale
        Workload("bigTable", lambda: (tb, bds),
                 lambda tr, d: tr.update_rounds(d, 5), 5 * dims["EX"]),
        Workload("bigSvdpp", lambda: (tp, pds),
                 lambda tr, d: tr.update_rounds(d, 3), 3 * pdims["EX"]),
    ]


def measure(w, trace_root, structure_out=None):
    import jax

    tr, data = w.build()
    w.run(tr, data)  # compile + warm
    jax.block_until_ready(tr.state)
    times = []
    for _ in range(REPS):
        tr, data = w.build()
        jax.block_until_ready(tr.state)
        t0 = time.perf_counter()
        w.run(tr, data)
        jax.block_until_ready(tr.state)
        times.append(time.perf_counter() - t0)
    res = {
        "best_s": round(min(times), 5),
        "median_s": round(statistics.median(times), 5),
        "examples_per_sec_best": round(w.examples / min(times)),
        "examples_per_sec_median": round(w.examples / statistics.median(times)),
    }
    if w.check is not None:
        res["check_rmse"] = round(w.check(tr), 6)
    tdir = tempfile.mkdtemp(dir=trace_root, prefix=w.name + "_")
    tr, data = w.build()
    jax.block_until_ready(tr.state)
    with jax.profiler.trace(tdir):
        w.run(tr, data)
        jax.block_until_ready(tr.state)
    res["trace"] = reduce_trace(tdir, structure_out)
    return res


def ab_forms(w, order=(True, False, False, True)):
    """The same workload with the one-hot form on and off, A B B A."""
    import jax

    from svdfeature_tpu import backend

    out = {True: [], False: []}
    check = {}
    for flag in order:
        with backend.override(onehot_scatter=flag), \
                jax.default_matmul_precision("highest"):
            tr, data = w.build()
            w.run(tr, data)  # compile for this form
            jax.block_until_ready(tr.state)
            for _ in range(REPS):
                tr, data = w.build()
                jax.block_until_ready(tr.state)
                t0 = time.perf_counter()
                w.run(tr, data)
                jax.block_until_ready(tr.state)
                out[flag].append(time.perf_counter() - t0)
            if w.check is not None:
                check[flag] = round(w.check(tr), 6)
    return {
        form: {
            "best_s": round(min(out[flag]), 5),
            "median_s": round(statistics.median(out[flag]), 5),
            "examples_per_sec_median": round(
                w.examples / statistics.median(out[flag])),
            "check_rmse": check.get(flag),
        }
        for form, flag in (("onehot", True), ("scatter", False))
    }


BIG_FORMS = {
    "dedup_align8": dict(align=8, generic=False),
    "dedup_align128": dict(align=128, generic=False),
    "generic_scatter": dict(align=8, generic=True),
}


def big_ab(bench, trace_root, card):
    """The big-table forms of the module docstring, A B C C B A per cell."""
    import gc

    import jax

    from svdfeature_tpu.ops import big_embed
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    bds, dims = bench.make_big_table()
    pds, pdims = bench.make_big_plus()
    G = dict(bench.big_plus_params(pdims)).get("users_per_batch", "128")
    sub = bench.slice_plus_blocks(pds, min(4 * int(G), pds.num_block))
    cells = {
        "bigTable": (SVDFeatureTrainer, {}, bench.big_table_params(dims), bds,
                     bds.slice_rows(0, 4096), 5, 5 * dims["EX"]),
        "bigSvdpp_4chunks": (
            SVDPPFeatureTrainer, dict(format_type=1),
            bench.big_plus_params(pdims), sub,
            bench.slice_plus_blocks(sub, min(2000, sub.num_block)), 3,
            3 * sub.rows.num_row),
    }
    names = list(BIG_FORMS)
    out = {}
    for cell, (cls, mt, params, data, probe, rounds, examples) in cells.items():
        times = {n: [] for n in names}
        res = {}
        for form in names + names[::-1]:
            spec = BIG_FORMS[form]
            big_embed.ROW_ALIGN = spec["align"]
            try:
                tr = make(cls, mt, params, generic=spec["generic"])
                assert tr.hp.big_table != spec["generic"], (cell, form)
                tr.update_rounds(data, rounds)  # pack + compile + warm
                jax.block_until_ready(tr.state)
                for _ in range(REPS):
                    t0 = time.perf_counter()
                    tr.update_rounds(data, rounds)
                    jax.block_until_ready(tr.state)
                    times[form].append(time.perf_counter() - t0)
                labels = probe.labels if hasattr(probe, "labels") else probe.rows.labels
                r = res.setdefault(form, {
                    "row_width": int(tr.state.w.shape[1]),
                    "check_rmse": round(rmse(tr.predict_all(probe), labels), 6),
                })
                if "trace" not in r:
                    tdir = tempfile.mkdtemp(dir=trace_root, prefix=f"{cell}_{form}_")
                    with jax.profiler.trace(tdir):
                        tr.update_rounds(data, rounds)
                        jax.block_until_ready(tr.state)
                    r["trace"] = reduce_trace(tdir)
            finally:
                big_embed.ROW_ALIGN = BIG_FORMS["dedup_align8"]["align"]
                tr = None
                gc.collect()
        for form in names:
            res[form].update(
                best_s=round(min(times[form]), 5),
                median_s=round(statistics.median(times[form]), 5),
                examples_per_sec_median=round(
                    examples / statistics.median(times[form])),
            )
        out[cell] = res
        print(f"[big-ab {cell}] {json.dumps(res)}  ({card})", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--big-ab", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "perf_out"))
    args = ap.parse_args()

    import jax

    from svdfeature_tpu import backend

    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"plain_paths.py measures the GPU; JAX found {d.platform!r}")
    backend.enable_compile_cache()
    card = backend.card_name_and_power_limit()
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    trace_root = tempfile.mkdtemp(prefix="plain_traces_")
    report = {"card": card, "platform": d.platform, "kind": d.device_kind,
              "count": len(jax.devices()), "reps": REPS,
              "capabilities": str(backend.capabilities()), "paths": {}, "ab": {}}
    print(f"card: {card}  kind={d.device_kind}", flush=True)

    import importlib.util

    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    if args.big_ab:
        report["big_ab"] = big_ab(bench, trace_root, card)
        (out_dir / "big_ab.json").write_text(json.dumps(report, indent=1))
        print(json.dumps({"card": card, "done": sorted(report["big_ab"])}))
        return
    demos = demo_workloads()
    if args.quick:
        demos = demos[:1]
    for w in demos:
        t0 = time.perf_counter()
        so = out_dir / "trace_structure.txt" if w.name == "basicMF" else None
        report["paths"][w.name] = r = measure(w, trace_root, so)
        print(f"[{w.name}] {json.dumps(r)}  ({time.perf_counter() - t0:.0f} s, {card})",
              flush=True)
    for w in demos:
        if w.name in ("basicMF", "implicitFeedback"):
            report["ab"][w.name] = r = ab_forms(w)
            print(f"[ab {w.name}] {json.dumps(r)}  ({card})", flush=True)
    if not args.quick:
        for w in big_workloads(bench):
            t0 = time.perf_counter()
            report["paths"][w.name] = r = measure(w, trace_root)
            print(f"[{w.name}] {json.dumps(r)}  ({time.perf_counter() - t0:.0f} s, {card})",
                  flush=True)
    (out_dir / "plain_paths.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"card": card, "done": sorted(report["paths"])}))


if __name__ == "__main__":
    main()
