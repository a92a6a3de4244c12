"""Smoke run of the SVDFeature trainer on NVIDIA GPUs.

Drives the main path once through the entry points a user calls, and
checks what comes out.  Phases of the one-card run:

  card    the card's name and power limit (nvidia-smi) and JAX's view of
          the device;
  demos   the five reference demos (ML-100K from tests/fixtures, k=64,
          40 rounds, demo/*/*.conf) through make_feature_buffer /
          make_ugroup_buffer, svd_feature and svd_feature_infer; each
          final RMSE (P@20 for pairwiseRank) must fall inside its band
          in golden/GOLDEN.json;
  kdd     the KDD-geometry tables: bigTable (1M users + 2^20 items, k=64,
          B=2^20) and bigSvdpp (the 2.25M-row table of
          bench.make_big_plus).  One step of each is compared on the card
          with the plain reference (the small-table form: generic step
          with .at[].add scatters, standard [N, k] layout) under
          Precision.HIGHEST; then the normal trainer runs a few rounds
          and the RMSE must fall;
  gbrt    RegGBRT (extend_type=31) on the implicitFeedback data through
          the CLIs; the saved model is evaluated with the device tree
          walk (ops/gbrt_forward.py, the default on the card) and with
          the host walk (device_forward=0): both must give the RMSE of
          golden/gbrt_reg.rmse.tsv;
  tests   the card-only tests (pytest -m gpu).

``--four`` runs only the mesh path on four cards, each configuration
against the single-card trajectory from the same process: basicMF with
mesh_data=4, and bigTable with mesh_model=4 (big slabs,
parallel/mesh_big.py).

One JAX process drives the card(s).  The last line of standard output
is ``{"ok": true, "device": {...}}``.  A failed phase, a missed
tolerance, a machine without a GPU, or a copy of this file outside a
checkout of the repository exits non-zero without that line.

Usage:  python chip_smoke.py [--four]
"""

import contextlib
import dataclasses
import gzip
import json
import math
import os
import pathlib
import shutil
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / ".smoke"  # listed in .gitignore; removed at the end

# One step of a big-table form against the plain reference, max |diff|
# per array, in f32.  Both compute the same updates and sum a row's
# duplicates in another order (sorted cumsum vs scatter-add), which
# moves a value by the f32 rounding of the running sums: the dedup
# cumsum of the bias column reaches a few units, so ~1e-6 at worst, and
# the factor column far less.  One factor update is lr*err*|p| ~ 1e-5
# at the initial scale and one bias update lr*err ~ 1e-3, so a lost or
# doubled update fails these bounds.
STEP_TOL = {"w": 1e-6, "b": 1e-5, "g": 1e-5}
# A whole SVD++ chunk (every batch of the first 4096-user chunk plus the
# pool writeback scaled by 1/|N(u)|) accumulates the per-step rounding.
CHUNK_TOL = {"w": 1e-5, "b": 1e-5, "g": 1e-5}
# Mesh against single card: the same batches, psum / all_gather orders.
MESH_RMSE_TOL = 1e-4
MESH_W_TOL = 1e-5


class PhaseFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(msg=""):
    print(msg, flush=True)


@contextlib.contextmanager
def cwd(path):
    prev = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


def gunzip(name, dst):
    with gzip.open(ROOT / "tests" / "fixtures" / name, "rb") as f:
        dst.write_bytes(f.read())


def rmse(pred, labels):
    import numpy as np

    d = np.asarray(pred, np.float64) - np.asarray(labels, np.float64)
    return float(np.sqrt(np.mean(d * d)))


def memory_report(tag, compiled):
    """compiled.memory_analysis() and the device's peak bytes in use."""
    import jax

    ma = compiled.memory_analysis()
    fields = {
        k: getattr(ma, k, None)
        for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes",
        )
    }
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  [{tag}] memory_analysis "
        + " ".join(f"{k}={v}" for k, v in fields.items())
        + f" peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


def max_diffs(a, b, names=("w", "b", "g")):
    import numpy as np

    return {
        n: float(np.max(np.abs(np.asarray(getattr(a, n)) - np.asarray(getattr(b, n)))))
        if np.asarray(getattr(a, n)).size else 0.0
        for n in names
    }


def check_diffs(tag, diffs, tol):
    log(f"  [{tag}] max|diff| "
        + " ".join(f"{n}={diffs[n]:.3e} (tol {tol[n]:.0e})" for n in diffs))
    for n, d in diffs.items():
        check(math.isfinite(d) and d <= tol[n],
              f"{tag}: max|{n} diff| {d:.3e} > {tol[n]:.0e}")


# ---- demos ------------------------------------------------------------------

# Each demo: fixtures -> buffers -> 40 rounds -> infer.  The extra keys
# are the configuration golden/GOLDEN.json's bands were derived at
# (golden/derive_rmse_bands.py: batch_size=4096; SVD++ with sort_blocks=1,
# rows_per_user=8); pairwiseRank keeps the demo conf as it is.
DEMOS = {
    "basicMF": dict(
        files=[("ml100k.base.feature.gz", "ua.base.feature"),
               ("ml100k.test.feature.gz", "ua.test.feature")],
        extra=["batch_size=4096"]),
    "binaryClassification": dict(
        files=[("ml100k.base.bin.feature.gz", "ua.base.feature"),
               ("ml100k.test.bin.feature.gz", "ua.test.feature")],
        extra=["batch_size=4096"]),
    "neighborhoodModel": dict(
        files=[("ml100k.base.nb.feature.gz", "ua.base.feature"),
               ("ml100k.test.nb.feature.gz", "ua.test.feature")],
        extra=["batch_size=4096"]),
    "implicitFeedback": dict(
        files=[("ml100k.base.group.feature.gz", "ua.base.group.feature"),
               ("ml100k.base.feedback.gz", "ua.base.feedback"),
               ("ml100k.test.ug.feature.gz", "ua.test.feature"),
               ("ml100k.test.feedback.gz", "ua.test.feedback")],
        extra=["sort_blocks=1", "rows_per_user=8"]),
    "pairwiseRank": dict(
        files=[("ml100k.rank.base.feature.gz", "ua.base.rank.feature"),
               ("ml100k.rank.base.feedback.gz", "ua.base.rank.feedback"),
               ("ml100k.rank.test.feature.gz", "ua.test.rank.feature"),
               ("ml100k.rank.test.feedback.gz", "ua.test.rank.feedback")],
        extra=[]),
}
ROUNDS = 40


def build_buffers(name):
    from svdfeature_tpu.cli import make_feature_buffer, make_ugroup_buffer

    if name in ("basicMF", "binaryClassification", "neighborhoodModel"):
        make_feature_buffer.main(["ua.base.feature", "ua.base.buffer"])
        make_feature_buffer.main(["ua.test.feature", "ua.test.buffer"])
    elif name == "implicitFeedback":
        make_ugroup_buffer.main(["ua.base.group.feature", "buffer.base.svdpp",
                                 "-fd", "ua.base.feedback"])
        make_ugroup_buffer.main(["ua.test.feature", "buffer.test.svdpp",
                                 "-fd", "ua.test.feedback"])
    else:
        make_ugroup_buffer.main(["ua.base.rank.feature", "buffer.base.svdpp",
                                 "-fd", "ua.base.rank.feedback",
                                 "-scale_score", "5"])
        make_ugroup_buffer.main(["ua.test.rank.feature", "buffer.test.svdpp",
                                 "-fd", "ua.test.rank.feedback",
                                 "-scale_score", "1", "-max_block", "400"])


def run_demo(name, golden, card):
    from svdfeature_tpu.cli import svd_feature, svd_feature_infer

    spec = DEMOS[name]
    d = WORK / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shutil.copy(ROOT / "demo" / name / f"{name}.conf", d)
    for src, dst in spec["files"]:
        gunzip(src, d / dst)
    conf = f"{name}.conf"
    with cwd(d):
        build_buffers(name)
        t0 = time.perf_counter()
        svd_feature.main([conf, f"num_round={ROUNDS}", "silent=1", *spec["extra"]])
        train_s = time.perf_counter() - t0
        if name == "pairwiseRank":
            svd_feature_infer.main([conf, f"pred={ROUNDS}"])
            ranks = [int(v) for v in pathlib.Path("pred.txt").read_text().split()]
            got = sum(1 for v in ranks if v < 20) / (943 * 20.0)
            want, band = golden["pairwiseRank"]["precision_at_20"], 0.003
            metric = "P@20"
        else:
            svd_feature_infer.main(
                [conf, f"start={ROUNDS}", f"end={ROUNDS + 1}", "log_eval=rmse.tsv",
                 *spec["extra"]]
            )
            rnd, val = pathlib.Path("rmse.tsv").read_text().split()
            check(int(rnd) == ROUNDS, f"{name}: evaluated model {rnd}")
            got = float(val)
            want = float(golden[name]["rmse_per_round"][str(ROUNDS)])
            band = golden[name]["rmse_band"]
            metric = f"RMSE@{ROUNDS}"
    ok = abs(got - want) < band
    log(f"  [demos] {name}: {metric} {got:.6f} golden {want:.6f} "
        f"|delta| {abs(got - want):.6f} band {band} -> {'in' if ok else 'OUT'}"
        f"  (train {train_s:.1f} s incl. compile; {card})")
    check(ok, f"{name}: {metric} {got:.6f} outside golden {want} +- {band}")
    shutil.rmtree(d, ignore_errors=True)


def phase_demos(ctx):
    golden = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())
    for name in DEMOS:
        run_demo(name, golden, ctx["card"])


# ---- KDD-geometry tables ------------------------------------------------------


def make_trainer(cls, mtype_kw, params):
    from svdfeature_tpu.params import SVDTypeParam

    tr = cls(SVDTypeParam(**mtype_kw))
    for n, v in params:
        tr.set_param(n, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


def copy_state(st):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.copy, st)


def kdd_big_table(ctx, bench):
    import jax
    import jax.numpy as jnp

    from svdfeature_tpu.ops import embed
    from svdfeature_tpu.ops.big_embed import augment_state, deaugment_state, train_step_big
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer

    bds, dims = bench.make_big_table()
    tb = make_trainer(SVDFeatureTrainer, {}, bench.big_table_params(dims))
    check(tb.hp.big_table, "bigTable did not select the big-table path")
    k = dims["KF"]
    stacked, _ = tb._pack(bds)
    batch = jax.tree.map(lambda a: a[0], stacked)
    lr = jnp.float32(tb.learning_rate)
    st0 = tb._std_state()  # standard [N, k] layout of the initial table
    hp_ref = dataclasses.replace(tb.hp, big_table=False, num_factor=0)
    log(f"  [kdd] bigTable: table {dims['NU'] + dims['NI']} rows x k={k}, "
        f"batch {batch['label'].shape[0]}, {stacked['label'].shape[0]} batches/round")
    with jax.default_matmul_precision("highest"):
        memory_report("bigTable reference step", embed.train_step.lower(
            st0, batch, lr, tb.consts, hp_ref).compile())
        ref = embed.train_step(copy_state(st0), batch, lr, tb.consts, hp_ref)
        jax.block_until_ready(ref)
        aug0 = augment_state(copy_state(st0), k)
        memory_report("bigTable big step", train_step_big.lower(
            aug0, batch, lr, tb.consts, tb.hp).compile())
        big = deaugment_state(train_step_big(aug0, batch, lr, tb.consts, tb.hp), k)
        jax.block_until_ready(big)
    check_diffs("bigTable step vs reference", max_diffs(big, ref), STEP_TOL)
    del ref, big, aug0

    probe = bds.slice_rows(0, 4096)
    r0 = rmse(tb.predict_all(probe), probe.labels)
    traj = []
    for _ in range(3):
        t0 = time.perf_counter()
        tb.update_all(bds)
        jax.block_until_ready(tb.state)
        dt = time.perf_counter() - t0
        traj.append(rmse(tb.predict_all(probe), probe.labels))
        log(f"  [kdd] bigTable round: {dt:.2f} s (first incl. compile), "
            f"train-probe RMSE {traj[-1]:.5f}  ({ctx['card']})")
    log(f"  [kdd] bigTable RMSE {r0:.5f} -> {' -> '.join(f'{x:.5f}' for x in traj)}")
    check(all(math.isfinite(x) for x in traj), "bigTable: non-finite RMSE")
    check(traj[-1] < r0, f"bigTable: RMSE did not fall ({r0} -> {traj[-1]})")


def kdd_big_svdpp(ctx, bench):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from svdfeature_tpu.data.batching_plus import pack_plus
    from svdfeature_tpu.ops.big_embed import augment_state, deaugment_state
    from svdfeature_tpu.ops.svdpp import train_epoch_plus
    from svdfeature_tpu.ops.svdpp_big import train_epoch_plus_big
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    pds, dims = bench.make_big_plus()
    tp = make_trainer(SVDPPFeatureTrainer, dict(format_type=1),
                      bench.big_plus_params(dims))
    check(tp.hp.big_table, "bigSvdpp did not select the big-table path")
    k = dims["KF"]
    m = tp.model
    G, M = tp.users_per_batch, tp.rows_per_user
    # the first chunk of G users: the big path (factored overlap,
    # user-carry plan) against the plain epoch (dense overlap, standard
    # layout, scatter form)
    chunk = bench.slice_plus_blocks(pds, min(G, pds.num_block))
    stacked_b, chunk_id, fb_b, _, ov_b = tp._pack_plus(chunk, cache=False)
    check("chunk_users" in fb_b, "bigSvdpp: user-carry plan not engaged")
    packed = pack_plus(
        chunk, G, m.num_rows, m.param.num_global, m.off_user, m.off_item,
        m.off_ufeedback, num_user=m.param.num_user, num_item=m.param.num_item,
        num_ufeedback=m.param.num_ufeedback, sort_blocks=True, rows_per_user=M,
    )
    check(packed.label.shape == stacked_b["label"].shape, "bigSvdpp: layouts differ")
    stacked_s = jax.device_put(packed.device_arrays())
    fb_s = jax.device_put(packed.fb_arrays())
    ov_s = jax.device_put(packed.fb_overlap)
    lr = jnp.float32(tp.learning_rate)
    fbh = (tp.tparam.scale_lr_ufeedback, tp.tparam.wd_ufeedback,
           tp.tparam.wd_ufeedback_bias)
    st0 = tp._std_state()
    hp_ref = dataclasses.replace(tp.hp, big_table=False, num_factor=0)
    log(f"  [kdd] bigSvdpp: table {m.num_rows} rows x k={k}, chunk of "
        f"{chunk.num_block} users / {chunk.rows.num_row} rows in "
        f"{packed.label.shape[0]} batches of G={G} x M={M}")
    with jax.default_matmul_precision("highest"):
        args_ref = (stacked_s, jnp.asarray(packed.chunk_id), fb_s, ov_s, lr,
                    tp.consts, hp_ref, *fbh)
        memory_report("bigSvdpp reference chunk", train_epoch_plus.lower(
            st0, *args_ref, rows_per_user=M).compile())
        ref = train_epoch_plus(copy_state(st0), *args_ref, rows_per_user=M)
        jax.block_until_ready(ref)
        aug0 = augment_state(copy_state(st0), k)
        args_big = (stacked_b, chunk_id, fb_b, ov_b, lr, tp.consts, tp.hp, *fbh)
        memory_report("bigSvdpp big chunk", train_epoch_plus_big.lower(
            aug0, *args_big, rows_per_user=M, carry_users=True).compile())
        big = train_epoch_plus_big(aug0, *args_big, rows_per_user=M,
                                   carry_users=True)
        big = deaugment_state(big, k, n_rows=m.num_rows + 1)
        jax.block_until_ready(big)
    check_diffs("bigSvdpp chunk vs reference", max_diffs(big, ref), CHUNK_TOL)
    check(int(big.step) == int(ref.step), "bigSvdpp: step counters differ")
    del ref, big, aug0, stacked_s, fb_s, ov_s

    probe = bench.slice_plus_blocks(pds, min(2000, pds.num_block))
    r0 = rmse(tp.predict_all(probe), probe.rows.labels)
    traj = []
    for _ in range(2):
        t0 = time.perf_counter()
        tp.update_all(pds)
        jax.block_until_ready(tp.state)
        dt = time.perf_counter() - t0
        traj.append(rmse(tp.predict_all(probe), probe.rows.labels))
        log(f"  [kdd] bigSvdpp round: {dt:.2f} s (first incl. pack + compile), "
            f"train-probe RMSE {traj[-1]:.5f}  ({ctx['card']})")
    log(f"  [kdd] bigSvdpp RMSE {r0:.5f} -> {' -> '.join(f'{x:.5f}' for x in traj)}")
    check(all(math.isfinite(x) for x in traj), "bigSvdpp: non-finite RMSE")
    check(traj[-1] < r0, f"bigSvdpp: RMSE did not fall ({r0} -> {traj[-1]})")
    check(np.isfinite(np.asarray(tp._std_state().w)).all(), "bigSvdpp: non-finite table")


def import_bench():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def phase_kdd(ctx):
    bench = import_bench()
    kdd_big_table(ctx, bench)
    import gc

    gc.collect()
    kdd_big_svdpp(ctx, bench)


# ---- GBRT ---------------------------------------------------------------------

# RegGBRT on the implicitFeedback data with the tree parameters
# golden/gbrt_reg.rmse.tsv was recorded at by the reference binary
GBRT_KEYS = [
    "extend_type=31", "num_spec_sparse=943", "learning_rate=0.3",
    "min_split_loss=1", "min_split_instance=100", "min_child_instance=20",
    "min_child_weight=5", "min_split_weight=10", "max_depth=5",
    "rt_loss_type=1",
]
# The exact-greedy fit runs on the host and is deterministic: the host
# walk reproduces the reference's six printed decimals (the bound of
# tests/test_golden_full.py).  The device walk sums the same f32 leaf
# values in another order; 1e-5 on the RMSE is f32 rounding over 6
# trees, while one row sent down a wrong branch moves it by far more.
GBRT_RMSE_TOL = 5e-6
GBRT_WALK_TOL = 1e-5


def phase_gbrt(ctx):
    from svdfeature_tpu.cli import svd_feature, svd_feature_infer
    from svdfeature_tpu.ops import gbrt_forward

    golden = {
        int(r): float(v)
        for r, v in (ln.split() for ln in
                     (ROOT / "golden" / "gbrt_reg.rmse.tsv").read_text().splitlines())
    }
    rounds = max(golden)
    d = WORK / "gbrt"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    conf = "implicitFeedback.conf"
    shutil.copy(ROOT / "demo" / "implicitFeedback" / conf, d)
    for src, dst in DEMOS["implicitFeedback"]["files"]:
        gunzip(src, d / dst)
    walks = []
    device_walk = gbrt_forward.forward_trees

    def counted_walk(*a, **kw):
        walks.append(1)
        return device_walk(*a, **kw)

    got, walked = {}, {}
    with cwd(d):
        build_buffers("implicitFeedback")
        t0 = time.perf_counter()
        svd_feature.main([conf, f"num_round={rounds}", "silent=1", *GBRT_KEYS])
        train_s = time.perf_counter() - t0
        gbrt_forward.forward_trees = counted_walk
        try:
            for walk, extra in (("device", []), ("host", ["device_forward=0"])):
                n0 = len(walks)
                t0 = time.perf_counter()
                svd_feature_infer.main(
                    [conf, f"start={rounds}", f"end={rounds + 1}",
                     f"log_eval={walk}.tsv", *GBRT_KEYS, *extra])
                eval_s = time.perf_counter() - t0
                rnd, val = pathlib.Path(f"{walk}.tsv").read_text().split()
                check(int(rnd) == rounds, f"gbrt: evaluated model {rnd}")
                got[walk], walked[walk] = float(val), len(walks) > n0
                log(f"  [gbrt] {walk} walk: RMSE@{rounds} {got[walk]:.6f} golden "
                    f"{golden[rounds]:.6f} (eval {eval_s:.1f} s incl. compile; "
                    f"{ctx['card']})")
        finally:
            gbrt_forward.forward_trees = device_walk
    log(f"  [gbrt] {rounds} trees trained on the host in {train_s:.1f} s; "
        f"|device - host| {abs(got['device'] - got['host']):.2e} "
        f"(tol {GBRT_WALK_TOL:.0e}); |host - golden| "
        f"{abs(got['host'] - golden[rounds]):.2e} (tol {GBRT_RMSE_TOL:.0e})")
    check(walked["device"], "gbrt: the default evaluation did not take the device walk")
    check(not walked["host"], "gbrt: device_forward=0 still took the device walk")
    check(abs(got["host"] - golden[rounds]) <= GBRT_RMSE_TOL,
          f"gbrt: host walk RMSE {got['host']} vs golden {golden[rounds]}")
    check(abs(got["device"] - got["host"]) <= GBRT_WALK_TOL,
          f"gbrt: device walk RMSE {got['device']} vs host {got['host']}")
    shutil.rmtree(d, ignore_errors=True)


# ---- card-only tests ------------------------------------------------------------


def phase_tests(ctx):
    import pytest

    os.environ["SVDFEATURE_TESTS_ON_CARD"] = "1"
    rc = pytest.main([
        "-q", "-p", "no:cacheprovider", "-p", "no:randomly", "-m", "gpu",
        str(ROOT / "tests" / "test_backend.py"),
    ])
    check(rc == 0, f"card-only tests failed (pytest exit code {rc})")


# ---- four cards: the mesh path ------------------------------------------------------

BASIC = [
    ("base_score", "3"), ("learning_rate", "0.005"),
    ("wd_item", "0.004"), ("wd_user", "0.004"),
    ("num_item", "1682"), ("num_user", "943"),
    ("num_global", "0"), ("num_factor", "64"), ("batch_size", "4096"),
]


def compare_trajectories(tag, single, meshed, train, probe, labels, rounds, ctx):
    import jax
    import numpy as np

    for r in range(rounds):
        times = []
        for tr in (single, meshed):
            t0 = time.perf_counter()
            tr.update_all(train)
            jax.block_until_ready(tr.state)
            times.append(time.perf_counter() - t0)
        a = rmse(single.predict_all(probe), labels)
        b = rmse(meshed.predict_all(probe), labels)
        log(f"  [four] {tag} round {r + 1}: RMSE single {a:.6f} mesh {b:.6f} "
            f"|diff| {abs(a - b):.2e} (tol {MESH_RMSE_TOL:.0e}); round s "
            f"single {times[0]:.3f} mesh {times[1]:.3f}  ({ctx['card_count']} cards)")
        check(abs(a - b) <= MESH_RMSE_TOL, f"{tag}: round {r + 1} RMSE differs")
    ws = np.asarray(single._std_state().w)[: single.model.num_rows]
    single._sync_model_from_state()
    meshed._sync_model_from_state()
    wm = np.asarray(meshed.model.w)
    d = float(np.max(np.abs(wm - np.asarray(single.model.w))))
    log(f"  [four] {tag} final table max|w diff| {d:.3e} (tol {MESH_W_TOL:.0e})")
    check(ws.shape == wm.shape and d <= MESH_W_TOL, f"{tag}: final tables differ")


def phase_four(ctx):
    import jax

    from svdfeature_tpu.data.text import load_feature_text
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer

    check(len(jax.devices()) >= 4, f"--four needs 4 cards, found {len(jax.devices())}")

    def fx(name):
        with gzip.open(ROOT / "tests" / "fixtures" / name, "rt") as f:
            return f.read()

    tds = load_feature_text("x", text=fx("ml100k.base.feature.gz"))
    eds = load_feature_text("x", text=fx("ml100k.test.feature.gz"))
    single = make_trainer(SVDFeatureTrainer, {}, BASIC)
    meshed = make_trainer(SVDFeatureTrainer, {}, BASIC + [("mesh_data", "4")])
    check(meshed._mesh is not None and meshed._mesh.devices.size == 4,
          "basicMF: mesh_data=4 did not build a 4-card mesh")
    compare_trajectories("basicMF mesh_data=4", single, meshed, tds, eds,
                         eds.labels, 5, ctx)
    del single, meshed

    bench = import_bench()
    bds, dims = bench.make_big_table()
    params = bench.big_table_params(dims)
    single = make_trainer(SVDFeatureTrainer, {}, params)
    meshed = make_trainer(SVDFeatureTrainer, {}, params + [("mesh_model", "4")])
    check(meshed._mesh_big, "bigTable: mesh_model=4 did not select big slabs")
    probe = bds.slice_rows(0, 4096)
    compare_trajectories("bigTable mesh_model=4", single, meshed, bds, probe,
                         probe.labels, 2, ctx)


# ---- main -----------------------------------------------------------------------


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main(argv):
    unknown = set(argv) - {"--four"}
    if unknown:
        fail(f"unknown arguments {sorted(unknown)}; usage: chip_smoke.py [--four]")
    four = "--four" in argv
    if not (ROOT / "svdfeature_tpu" / "__init__.py").is_file():
        fail(f"no svdfeature_tpu package beside {__file__}: run from a checkout")
    sys.path.insert(0, str(ROOT))

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"JAX finds no GPU (default backend: {devs[0].platform})")

    from svdfeature_tpu import backend

    cache = backend.enable_compile_cache()
    card = backend.card_name_and_power_limit()
    first_card = card.splitlines()[0]
    log(f"card (nvidia-smi name, power.limit): {card}")
    log(f"jax: platform={devs[0].platform} device_kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__} compile_cache={cache}")
    log(f"backend capabilities: {backend.capabilities()}")
    ctx = {"card": first_card, "card_count": len(devs)}

    if four:
        phases = [("four", phase_four)]
    else:
        phases = [("demos", phase_demos), ("kdd", phase_kdd),
                  ("gbrt", phase_gbrt), ("tests", phase_tests)]

    failed = []
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            log(f"[{name}] start")
            try:
                fn(ctx)
                log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s  ({first_card})")
            except Exception:
                traceback.print_exc()
                log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
                failed.append(name)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if failed:
        fail(f"phases failed: {failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
