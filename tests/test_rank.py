"""Pairwise-rank pipeline tests: pair synthesis, ranker protocol, tools.

Full-horizon parity (verified via CLI): 40 rounds on ML-100K gives
P@20 = 0.1648 vs the reference's 0.1651.
"""

import numpy as np
import pytest

from svdfeature_tpu.data.rank import PairSource, _merge_diff
from svdfeature_tpu.data.registry import IteratorConfig
from svdfeature_tpu.data.text import load_plus_text
from svdfeature_tpu.params import SVDTypeParam, svd_type
from svdfeature_tpu.solvers.ranker import SVDFeatureRanker
from svdfeature_tpu.utils.evaluator import (
    EvaluatorMAP,
    average_precision,
    ndcg_at,
    precision_at,
)


def test_merge_diff():
    # common index 5 -> difference; disjoint kept with sign
    pi = np.array([2, 5], np.uint32)
    pv = np.array([1.0, 2.0], np.float32)
    ni = np.array([5, 7], np.uint32)
    nv = np.array([0.5, 3.0], np.float32)
    idx, val = _merge_diff(pi, pv, ni, nv)
    assert list(idx) == [2, 5, 7]
    np.testing.assert_allclose(val, [1.0, 1.5, -3.0])


def make_block_text():
    # one user, 2 pos (label 1.0) and 2 neg (label 0)
    rows = []
    for r, (lbl, iid) in enumerate([(1.0, 10), (1.0, 11), (0.0, 12), (0.0, 13)]):
        rows.append(f"{lbl} 0 1 1 3:1 {iid}:1")
    fb = "4 2 10:0.7 11:0.7\n"
    return "\n".join(rows), fb


def test_pair_source_difference_rows():
    text, fb = make_block_text()
    ds = load_plus_text("x", "y", text=text, feedback_text=fb)
    cfg = IteratorConfig()
    src = PairSource(ds, cfg, seed=3)
    ep = src.epoch_dataset()
    assert ep.num_block == 1
    blk = ep.block(0)
    assert blk.data.num_row == 2  # snum = len(neg) = 2
    for r in range(blk.data.num_row):
        label, g, u, i = blk.data.row(r)
        assert label == 1.0
        assert list(u[0]) == [3]  # positive row's user feature
        # item segment: +1 on a pos item, -1 on a neg item
        assert set(i[1]) == {1.0, -1.0}
    # counts deterministic across epochs (stable shapes)
    ep2 = src.epoch_dataset()
    assert ep2.rows.num_row == ep.rows.num_row


def test_ranker_protocol():
    """Protocol: 3 items, then a user section with one ban and one pos."""
    from svdfeature_tpu.model import SVDModel
    from svdfeature_tpu.params import SVDModelParam

    p = SVDModelParam(num_user=4, num_item=3, num_factor=4, base_score=3.0)
    mt = SVDTypeParam(format_type=svd_type.RANDOM_ORDER_FORMAT)
    m = SVDModel.rand_init(p, mt, seed=1)
    # craft scores: make item 1 clearly best for user 0 via bias
    import jax.numpy as jnp

    b = np.zeros(m.num_rows, np.float32)
    b[m.off_item + 1] = 5.0
    b[m.off_item + 0] = 2.0
    b[m.off_item + 2] = 1.0
    m = type(m)(w=jnp.zeros_like(m.w), b=jnp.asarray(b), g=m.g, param=m.param, mtype=mt)

    rk = SVDFeatureRanker(mt)
    rk.model = m
    rk.init_ranker(3)
    from svdfeature_tpu.data.text import load_feature_text

    proto = "\n".join(
        [
            "0 0 0 1 0:1",   # ITEM 0
            "0 0 0 1 1:1",   # ITEM 1
            "0 0 0 1 2:1",   # ITEM 2
            "2 0 1 0 0:1",   # USER 0
            "-1 0 1 0 1:1",  # BAN item index 1 (the best)
            "1 0 1 0 0:1",   # POS item index 0
            "4 0 0 0",       # PROCESS
        ]
    )
    ds = load_feature_text("x", text=proto)
    out = rk.process_dataset(ds)
    # banned item 1 excluded; item 0 (bias 2) beats item 2 (bias 1) -> rank 0
    assert list(out) == [0]
    # top_k mode
    rk.top_k = 2
    out2 = rk.process_dataset(ds)
    assert list(out2) == [0, 2]


def test_evaluators():
    assert precision_at([0, 5, 30], 20) == pytest.approx(2 / 20)
    assert average_precision([0, 2]) == pytest.approx((1 / 1 + 2 / 3) / 2)
    assert ndcg_at([0], 10) == pytest.approx(1.0)
    ev = EvaluatorMAP("MAP@10,PRE@5")
    ev.add_user([0, 3])
    ev.add_user([7])
    out = ev.eval()
    assert set(out) == {"MAP@10", "PRE@5"}


def test_tool_byte_parity_rank_buffer(tmp_path):
    """make_ugroup_buffer with -max_block splitting matches reference bytes."""
    import pathlib

    ref = pathlib.Path(".baseline/demo/pairwiseRank/buffer.test.svdpp")
    if not ref.exists():
        pytest.skip("reference buffer not present")
    from svdfeature_tpu.cli.make_ugroup_buffer import main

    out = tmp_path / "t.buffer"
    main([
        ".baseline/demo/pairwiseRank/ua.test.basicfeature",
        str(out),
        "-fd", ".baseline/demo/pairwiseRank/ua.test.feedbackfeature",
        "-scale_score", "1", "-max_block", "400",
    ])
    assert out.read_bytes() == ref.read_bytes()


def test_gen_rows_vectorized_matches_ref():
    """The vectorized pair-row synthesis is entry-for-entry identical to
    the per-pair reference loop (_gen_rows_ref) — sorted-unique merge
    order, zero-diff entries kept — across sampling methods and label
    modes."""
    import numpy as np

    from svdfeature_tpu.data.registry import IteratorConfig
    from svdfeature_tpu.data.rank import PairSource
    from svdfeature_tpu.data.text import load_plus_text

    rng = np.random.RandomState(4)
    rows, fb = [], []
    for u in range(12):
        n = 3 + u % 4
        items = rng.choice(30, n, replace=False)
        for i in items:
            # overlapping global ids force real diff merges (incl. zeros)
            rows.append(
                f"{rng.randint(0, 6)} 2 1 2 0:{rng.rand():.2f} 1:0.5 "
                f"{u}:1 {i}:1 {rng.randint(0, 30)}:0.3"
            )
        fb.append(f"{n} 0")
    ds = load_plus_text("x", "y", text="\n".join(rows), feedback_text="\n".join(fb))

    for method, extra in [(0, {}), (1, {}), (0, {"rank_sample_num": 2})]:
        cfg = IteratorConfig()
        cfg.rank_sample_method = method
        for k, v in extra.items():
            setattr(cfg, k, v)
        s1 = PairSource(ds, cfg, seed=7)
        s2 = PairSource(ds, cfg, seed=7)
        s2._gen_rows = s2._gen_rows_ref
        d1, d2 = s1.epoch_dataset().rows, s2.epoch_dataset().rows
        np.testing.assert_array_equal(d1.labels, d2.labels)
        np.testing.assert_array_equal(d1.row_ptr, d2.row_ptr)
        np.testing.assert_array_equal(d1.index, d2.index)
        np.testing.assert_array_equal(d1.value, d2.value)


def _mini_rank_trainer(extra=()):
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1, active_type=3))
    for k, v in [
        ("learning_rate", "0.01"), ("wd_user", "0.004"), ("wd_item", "0.004"),
        ("num_user", "12"), ("num_item", "30"), ("num_global", "6"),
        ("num_factor", "8"), ("num_ufeedback", "30"), ("wd_ufeedback", "0.004"),
        ("no_user_bias", "1"),
    ] + list(extra):
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


def _skewed_pair_ds(seed=4):
    rng = np.random.RandomState(seed)
    rows, fb = [], []
    for u in range(12):
        n = 2 + (7 * (u % 5))  # skewed block sizes: 2..30 rows
        items = rng.choice(30, min(n, 30), replace=False)
        for i in items:
            # learnable signal: low item ids are the positives everywhere
            rows.append(f"{float(1 if i < 15 else 0)} 1 1 1 0:0.5 {u}:1 {i}:1")
        fb.append(f"{len(items)} 0")
    return load_plus_text("x", "y", text="\n".join(rows), feedback_text="\n".join(fb))


def test_pair_dense_layout_defaults():
    """PairSource training defaults to the dense layout (users sorted by
    pair count, rank_rows_per_user pairs per user per step), shrinking the
    scan length; explicit sort_blocks=/rows_per_user= keys win."""
    ds = _skewed_pair_ds()
    cfg = IteratorConfig()

    tr = _mini_rank_trainer([("users_per_batch", "4"), ("rank_rows_per_user", "4")])
    tr._apply_pair_layout()
    assert tr.sort_blocks == 1 and tr.rows_per_user == 4
    dense = tr._pack_plus(PairSource(ds, cfg, seed=9).epoch_dataset(), cache=False)

    tr2 = _mini_rank_trainer(
        [("users_per_batch", "4"), ("sort_blocks", "0"), ("rows_per_user", "1")]
    )
    tr2._apply_pair_layout()
    assert tr2.sort_blocks == 0 and tr2.rows_per_user == 1
    strict = tr2._pack_plus(PairSource(ds, cfg, seed=9).epoch_dataset(), cache=False)

    T_dense, T_strict = dense[0]["label"].shape[0], strict[0]["label"].shape[0]
    assert T_dense < T_strict  # skew makes the dense layout strictly shorter
    # same pair multiset trains either way: weights count real rows
    assert float(dense[0]["weight"].sum()) == float(strict[0]["weight"].sum())


def test_pair_dense_layout_trains():
    """A few dense-layout rounds learn the pair ordering (sanity: the
    full-horizon P@20 gate is tests/test_golden_full.py)."""
    ds = _skewed_pair_ds()
    tr = _mini_rank_trainer([("users_per_batch", "4")])
    src = PairSource(ds, IteratorConfig(), seed=9)
    tr.update_rounds(src, 15)
    p = tr.predict_all(PairSource(ds, IteratorConfig(), seed=31).epoch_dataset())
    assert np.mean(p > 0.5) > 0.9


def _noglobal_pair_ds(seed=4):
    """Skewed pair blocks with NO global features (skeleton-eligible);
    16 users so the dense layout packs GS = 16 x 8 = 128."""
    rng = np.random.RandomState(seed)
    rows, fb = [], []
    for u in range(16):
        n = 2 + (7 * (u % 5))  # skewed block sizes: 2..30 rows
        items = rng.choice(30, min(n, 30), replace=False)
        for i in items:
            rows.append(f"{float(1 if i < 15 else 0)} 0 1 1 {u}:1 {i}:1")
        fb.append(f"{len(items)} 0")
    return load_plus_text("x", "y", text="\n".join(rows), feedback_text="\n".join(fb))


def test_device_sampler_law():
    """On-device resampler (ops/pair_sample.py) obeys the reference
    sampling law (apex_svd_data.cpp:812-1025): every sampled row is a
    same-user candidate of the right polarity, coverage is the cyclic
    read of a permutation (per-candidate counts differ by <=1; exactly
    once when snum == n_neg), padded slots hold the dummy row, rounds
    are fresh, and a key replays deterministically."""
    import jax

    from svdfeature_tpu.ops.pair_sample import (
        build_pair_sampler_statics,
        sample_pair_flats,
    )

    ds = _noglobal_pair_ds()
    cfg = IteratorConfig()
    src = PairSource(ds, cfg, seed=9)
    tr = _mini_rank_trainer(
        [("users_per_batch", "4"), ("num_global", "0"), ("num_user", "16")]
    )
    tr._apply_pair_layout()
    assert tr._pair_skeleton_ok(src)
    sk = tr._build_pair_skeleton(src)
    st = build_pair_sampler_statics(src, sk["slot"], sk["TGS"])

    R = 3
    fp, fn = map(
        np.asarray, sample_pair_flats(jax.random.PRNGKey(0), st, R, sk["TGS"])
    )
    assert fp.shape == fn.shape == (R, sk["TGS"])

    rows = src._rows_cat
    Rr = rows.num_row
    labels = rows.labels
    row_starts = np.asarray(src._row_starts, np.int64)
    row_block = (
        np.searchsorted(row_starts, np.arange(Rr), side="right") - 1
    )
    _, _, counts = src.epoch_pairs()
    blk_of_pair = np.repeat(np.arange(len(counts)), counts)
    slot = sk["slot"]
    pad = np.ones(sk["TGS"], bool)
    pad[slot] = False

    for r in range(R):
        assert (fp[r][pad] == Rr).all() and (fn[r][pad] == Rr).all()
        p, n = fp[r][slot], fn[r][slot]
        # same-user candidates of the right polarity
        np.testing.assert_array_equal(row_block[p], blk_of_pair)
        np.testing.assert_array_equal(row_block[n], blk_of_pair)
        assert (labels[p] - cfg.pos_sample_lowerb > -1e-6).all()
        assert (labels[n] - cfg.neg_sample_upperb < 1e-6).all()
        # cyclic-permutation coverage per user
        for b in np.unique(blk_of_pair):
            sel = blk_of_pair == b
            in_b = row_block == b
            for plane, cond in (
                (p, labels - cfg.pos_sample_lowerb > -1e-6),
                (n, labels - cfg.neg_sample_upperb < 1e-6),
            ):
                cand = np.nonzero(in_b & cond)[0]
                c = np.bincount(plane[sel], minlength=Rr)[cand]
                assert c.max() - c.min() <= 1
        # snum == n_neg by default: each negative exactly once per round
        cnt_n = np.bincount(n, minlength=Rr)
        used_users = np.unique(blk_of_pair)
        negs_of_used = np.nonzero(
            np.isin(row_block, used_users)
            & (labels - cfg.neg_sample_upperb < 1e-6)
        )[0]
        assert (cnt_n[negs_of_used] == 1).all()

    # fresh randomness across rounds; deterministic under the same key
    assert (fp[0] != fp[1]).any() or (fn[0] != fn[1]).any()
    fp2, fn2 = map(
        np.asarray, sample_pair_flats(jax.random.PRNGKey(0), st, R, sk["TGS"])
    )
    np.testing.assert_array_equal(fp, fp2)
    np.testing.assert_array_equal(fn, fn2)


def test_sample_offsets_law():
    """Host permutation-offset sampling (pair_geometry + sample_offsets)
    obeys the reference method-0 law like the device sampler: assembling
    the planes exactly as _pair_multi_train does (candidate-table gather +
    cyclic pair map) yields same-user candidates of the right polarity
    with cyclic-permutation coverage, fresh across rounds, and the pair
    count per block matches epoch_pairs."""
    ds = _noglobal_pair_ds()
    cfg = IteratorConfig()
    src = PairSource(ds, cfg, seed=9)
    geo = src.pair_geometry()
    rng = np.random.default_rng(5)
    K = 3
    opl, onl = src.sample_offsets(K, rng)
    assert opl.dtype == geo["off_dtype"] and onl.dtype == geo["off_dtype"]

    rows = src._rows_cat
    Rr = rows.num_row
    labels = rows.labels
    row_starts = np.asarray(src._row_starts, np.int64)
    row_block = np.searchsorted(row_starts, np.arange(Rr), side="right") - 1
    _, _, counts = src.epoch_pairs()
    blk_of_pair = np.repeat(np.arange(len(counts)), counts)
    assert len(geo["jp"]) == counts.sum()  # same pair count per epoch

    for plane_offs, rows_tbl, base, jmap, cond in (
        (opl, geo["pos_rows"], geo["pstart_elem"], geo["jp"],
         labels - cfg.pos_sample_lowerb > -1e-6),
        (onl, geo["neg_rows"], geo["nstart_elem"], geo["jn"],
         labels - cfg.neg_sample_upperb < 1e-6),
    ):
        for r in range(K):
            # the numpy mirror of _pair_multi_train.planes()
            perm = rows_tbl[base + plane_offs[r].astype(np.int64)]
            # permutation: each candidate appears exactly once
            assert len(np.unique(perm)) == len(perm)
            sampled = perm[jmap]
            np.testing.assert_array_equal(row_block[sampled], blk_of_pair)
            assert cond[sampled].all()
            # cyclic coverage: per-candidate counts differ by <= 1
            for b in np.unique(blk_of_pair):
                c = np.bincount(
                    sampled[blk_of_pair == b], minlength=Rr
                )[np.nonzero((row_block == b) & cond)[0]]
                assert c.max() - c.min() <= 1
        # fresh across rounds
        assert (plane_offs[0] != plane_offs[1]).any()


@pytest.fixture
def accelerator(monkeypatch):
    """The capability row of an accelerator, on the CPU: turns on the
    multi-round pair dispatch (solvers/svdpp._pair_multi_ok)."""
    import dataclasses

    from svdfeature_tpu import backend

    caps = dataclasses.replace(backend.capabilities(), accelerator=True)
    monkeypatch.setattr(backend, "capabilities", lambda: caps)
    return caps


def test_pair_host_multi_path_trains_interpret(accelerator):
    """End-to-end host multi-round path (_pair_multi_ok ->
    _train_pair_rounds_host): batched permutation-offset sampling +
    in-dispatch plane assembly + K plain epochs per dispatch, on the
    CPU, learns the pair ordering like the per-round path."""
    ds = _noglobal_pair_ds()
    tr = _mini_rank_trainer(
        [("users_per_batch", "16"), ("num_global", "0"),
         ("num_user", "60"), ("num_item", "100"), ("num_ufeedback", "130"),
         ("learning_rate", "0.02")]
    )
    src = PairSource(ds, IteratorConfig(), seed=9)
    tr._apply_pair_layout()
    assert tr._pair_multi_ok(src)
    tr.update_rounds(src, 10)
    # the multi path ran (geometry cached on the skeleton), over 2 blocks
    assert tr._pair_sk is not None and "geo" in tr._pair_sk
    p = tr.predict_all(PairSource(ds, IteratorConfig(), seed=31).epoch_dataset())
    assert np.mean(p > 0.5) > 0.9


def test_pair_device_path_trains_interpret(accelerator):
    """End-to-end device path (_pair_device_ok -> _train_pair_rounds_device):
    on-device resampling + R plain epochs in one dispatch, on the CPU,
    learns the pair ordering like the host path."""
    ds = _noglobal_pair_ds()
    tr = _mini_rank_trainer(
        [("users_per_batch", "16"), ("num_global", "0"),
         ("num_user", "60"), ("num_item", "100"), ("num_ufeedback", "130"),
         ("learning_rate", "0.02"), ("rank_device_sample", "1")]
    )
    src = PairSource(ds, IteratorConfig(), seed=9)
    tr.update_rounds(src, 10)
    assert tr._pair_sk is not None and "sampler" in tr._pair_sk
    p = tr.predict_all(PairSource(ds, IteratorConfig(), seed=31).epoch_dataset())
    assert np.mean(p > 0.5) > 0.9


def test_pair_mesh_matches_single():
    """pairwiseRank on a (2x2) mesh: the sharded packed path trains the
    same model as the single-device trainer on the same seeded pair
    epochs (the skeleton fast paths refuse the mesh and fall back to
    _train_packed, solvers/svdpp.py)."""
    import jax

    if len(jax.devices("cpu")) < 4:
        pytest.skip("not enough devices")
    ds = _skewed_pair_ds()

    single = _mini_rank_trainer([("users_per_batch", "4")])
    src = PairSource(ds, IteratorConfig(), seed=9)
    single.update_rounds(src, 5)

    meshed = _mini_rank_trainer(
        [("users_per_batch", "4"), ("mesh_data", "2"), ("mesh_model", "2")]
    )
    assert meshed._mesh is not None
    src2 = PairSource(ds, IteratorConfig(), seed=9)
    meshed.update_rounds(src2, 5)

    single._sync_model_from_state()
    meshed._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(meshed.model.w), np.asarray(single.model.w),
        rtol=1e-4, atol=1e-5,
    )
    # sharded scoring parity on a fresh epoch
    ep = PairSource(ds, IteratorConfig(), seed=31).epoch_dataset()
    np.testing.assert_allclose(
        meshed.predict_all(ep), single.predict_all(ep), rtol=1e-4, atol=1e-5
    )


def test_pair_multi_path_zero_rounds_noop(accelerator):
    """update_rounds(src, 0) on the multi-round host-sampled path is a
    no-op (regression: blocks[0] IndexError on an empty lr schedule)."""
    ds = _noglobal_pair_ds()
    tr = _mini_rank_trainer(
        [("users_per_batch", "16"), ("num_global", "0"),
         ("num_user", "60"), ("num_item", "100"), ("num_ufeedback", "130")]
    )
    src = PairSource(ds, IteratorConfig(), seed=9)
    w0 = np.asarray(tr.state.w).copy()
    tr.update_rounds(src, 0)
    np.testing.assert_array_equal(np.asarray(tr.state.w), w0)


# ---- big-table pair paths (augmented epoch behind the skeleton) -----------
def test_pair_big_table_per_round_matches_small(monkeypatch):
    """Above ONEHOT_THRESHOLD the per-round skeleton path routes the
    assembled planes through the augmented big epoch (with user-carry
    when the candidate geometry proves the layout) — same sampling
    stream, so the trained model must match the small-table run."""
    from svdfeature_tpu.ops import embed

    ds = _noglobal_pair_ds()
    cfg = [("users_per_batch", "16"), ("num_global", "0"),
           ("num_user", "60"), ("num_item", "100"),
           ("num_ufeedback", "130"), ("learning_rate", "0.02")]
    tr1 = _mini_rank_trainer(cfg)
    src1 = PairSource(ds, IteratorConfig(), seed=9)
    tr1.update_rounds(src1, 4)
    eval_ds = PairSource(ds, IteratorConfig(), seed=31).epoch_dataset()
    p1 = tr1.predict_all(eval_ds)

    monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    tr2 = _mini_rank_trainer(cfg)
    assert tr2.hp.big_table
    src2 = PairSource(ds, IteratorConfig(), seed=9)
    tr2.update_rounds(src2, 4)
    p2 = tr2.predict_all(eval_ds)
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)


def test_pair_big_multi_path_trains(monkeypatch, accelerator):
    """Big-table host multi-round path: _pair_multi_ok admits big
    tables (the augmented epoch inside _pair_multi_train), the
    candidate-derived chunk_users plan engages the user-carry variant,
    and the model learns the pair ordering."""
    from svdfeature_tpu.ops import embed

    monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    ds = _noglobal_pair_ds()
    tr = _mini_rank_trainer(
        [("users_per_batch", "16"), ("num_global", "0"),
         ("num_user", "60"), ("num_item", "100"), ("num_ufeedback", "130"),
         ("learning_rate", "0.02")]
    )
    assert tr.hp.big_table
    src = PairSource(ds, IteratorConfig(), seed=9)
    tr._apply_pair_layout()
    assert tr._pair_multi_ok(src)
    tr.update_rounds(src, 10)
    assert "geo" in tr._pair_sk
    assert "chunk_users" in tr._pair_sk["fb"]  # carry engaged
    p = tr.predict_all(PairSource(ds, IteratorConfig(), seed=31).epoch_dataset())
    assert np.mean(p > 0.5) > 0.9


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("R", [1, 2, 3])
def test_pair_rounds_in_one_dispatch_match_per_round(monkeypatch, R, big):
    """R rounds in one dispatch (per-round sampled planes stacked
    [R*T, GS], a lax.scan of the plain epoch) train exactly like R
    single-round dispatches on the same sampled pairs — the contract of
    the multi-round pair path (solvers/svdpp._train_rounds_plus)."""
    import jax
    import jax.numpy as jnp

    from svdfeature_tpu.ops import embed
    from svdfeature_tpu.solvers.svdpp import _pair_assemble_train

    if big:
        monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    ds = _noglobal_pair_ds()
    tr = _mini_rank_trainer(
        [("users_per_batch", "16"), ("num_global", "0"),
         ("num_user", "60"), ("num_item", "100"), ("num_ufeedback", "130"),
         ("learning_rate", "0.02")]
    )
    assert tr.hp.big_table == big
    src = PairSource(ds, IteratorConfig(), seed=9)
    tr._apply_pair_layout()
    assert tr._pair_skeleton_ok(src)
    sk = tr._build_pair_skeleton(src)
    flats = [tr._pair_flats(src, sk) for _ in range(R)]
    lrs = [0.02 * 0.9 ** r for r in range(R)]
    common = (tr.consts, sk["dev"], sk["chunk_id"], sk["fb"], sk["overlap"],
              tr._fbh())

    one = _pair_assemble_train(
        jax.tree.map(jnp.copy, tr.state),
        jnp.concatenate([f[0] for f in flats]),
        jnp.concatenate([f[1] for f in flats]),
        jnp.asarray(lrs, jnp.float32), *common, hp=tr.hp, M=sk["M"],
    )
    seq = jax.tree.map(jnp.copy, tr.state)
    for (fp, fn), lr in zip(flats, lrs):
        seq = _pair_assemble_train(
            seq, fp, fn, jnp.asarray([lr], jnp.float32), *common,
            hp=tr.hp, M=sk["M"],
        )
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(
            np.asarray(getattr(one, name)), np.asarray(getattr(seq, name)),
            rtol=1e-5, atol=1e-6, err_msg=name,
        )
    assert int(one.step) == int(seq.step)
