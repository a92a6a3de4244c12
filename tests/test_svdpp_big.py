"""Large-table SVD++ epoch (ops/svdpp_big.py) equivalence tests.

train_epoch_plus_big must reproduce the train_epoch_plus trajectory —
same chunk-carried algorithm, augmented-table execution — across bias
modes, reg modes, rows_per_user and feedback weight decay.
chip_smoke.py repeats the comparison on the card at the KDD geometry.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from svdfeature_tpu.data.text import load_plus_text
from svdfeature_tpu.ops.big_embed import augment_state, deaugment_state
from svdfeature_tpu.ops.svdpp import train_epoch_plus
from svdfeature_tpu.ops.svdpp_big import train_epoch_plus_big
from svdfeature_tpu.params import SVDTypeParam
from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

K = 8


def make_trainer(seed=13, extra=None, fb_bound=15):
    rng = np.random.RandomState(seed)
    data_lines, fb_lines = [], []
    for u in range(10):
        nrows = int(rng.randint(2, 6))
        nfb = int(rng.randint(1, 5))
        fb_lines.append(
            f"{nrows} {nfb} "
            + " ".join(
                f"{rng.randint(0, fb_bound)}:{rng.rand():.3f}"
                for _ in range(nfb)
            )
        )
        for _ in range(nrows):
            data_lines.append(
                f"{rng.randint(1, 6)} 1 1 1 {rng.randint(0, 3)}:1 {u}:1 "
                f"{rng.randint(0, 12)}:1"
            )
    ds = load_plus_text(
        "x", "y", text="\n".join(data_lines), feedback_text="\n".join(fb_lines)
    )
    tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1))
    params = dict(
        num_user=10, num_item=12, num_ufeedback=15, num_global=3,
        num_factor=K, base_score=3, learning_rate=0.01,
        wd_user=0.004, wd_item=0.004, wd_ufeedback=0.003,
        wd_ufeedback_bias=0.002, users_per_batch=4,
    )
    params.update(extra or {})
    for n, v in params.items():
        tr.set_param(n, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr, ds


def run_both(tr, ds, epochs=3, rows_per_user=1):
    stacked, chunk_id, fb, _, overlap = tr._pack_plus(ds)
    args = (
        jnp.float32(0.01), tr.consts, tr.hp,
        tr.tparam.scale_lr_ufeedback, tr.tparam.wd_ufeedback,
        tr.tparam.wd_ufeedback_bias,
    )
    n = int(tr.state.w.shape[0])
    hp_big = dataclasses.replace(
        tr.hp, big_table=True, num_factor=K
    )
    args_big = (
        jnp.float32(0.01), tr.consts, hp_big,
        tr.tparam.scale_lr_ufeedback, tr.tparam.wd_ufeedback,
        tr.tparam.wd_ufeedback_bias,
    )
    st1 = jax.tree.map(jnp.copy, tr.state)
    st2 = augment_state(jax.tree.map(jnp.copy, tr.state), K)
    for _ in range(epochs):
        st1 = train_epoch_plus(
            st1, stacked, chunk_id, fb, overlap, *args,
            rows_per_user=rows_per_user,
        )
        st2 = train_epoch_plus_big(
            st2, stacked, chunk_id, fb, overlap, *args_big,
            rows_per_user=rows_per_user,
        )
    return st1, deaugment_state(st2, K, n_rows=n)


def assert_close(st1, st2):
    np.testing.assert_allclose(
        np.asarray(st1.w), np.asarray(st2.w), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st1.b), np.asarray(st2.b), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st1.g), np.asarray(st2.g), rtol=1e-4, atol=1e-6
    )
    assert int(st1.step) == int(st2.step)


def test_big_epoch_matches_small():
    tr, ds = make_trainer()
    assert_close(*run_both(tr, ds))


def test_big_epoch_no_user_bias():
    tr, ds = make_trainer(seed=7, extra={"no_user_bias": 1})
    assert_close(*run_both(tr, ds))


@pytest.mark.parametrize("reg", [1, 4])
def test_big_epoch_reg_modes(reg):
    tr, ds = make_trainer(seed=5, extra={"reg_method": reg})
    st1, st2 = run_both(tr, ds)
    assert_close(st1, st2)
    if reg >= 4:
        np.testing.assert_array_equal(
            np.asarray(st1.ref_ui), np.asarray(st2.ref_ui)
        )


def test_big_epoch_multirow():
    tr, ds = make_trainer(seed=3, extra={"rows_per_user": 2})
    assert_close(*run_both(tr, ds, rows_per_user=2))


def test_solver_routes_big_table(monkeypatch):
    """Forcing ONEHOT_THRESHOLD below the table size must flip the solver
    onto the augmented epoch with an unchanged training outcome."""
    from svdfeature_tpu.ops import embed

    tr1, ds = make_trainer(seed=11)
    tr1.update_rounds(ds, 2)
    p1 = tr1.predict_all(ds)

    monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    tr2, _ = make_trainer(seed=11)
    assert tr2.hp.big_table
    assert tr2.state.w.ndim == 2 and tr2.state.b.shape == (0,)
    tr2.update_rounds(ds, 2)
    p2 = tr2.predict_all(ds)
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)

    # checkpoint sync round-trips through deaugment_state
    tr2._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(tr1.state.w[:-1]),
        np.asarray(tr2.model.w),
        rtol=1e-4,
        atol=1e-5,
    )


def test_solver_common_space_keeps_small_layout(monkeypatch):
    """common_feedback_space=1 has aliasing pool rows — the solver must
    keep the standard layout even above the threshold."""
    from svdfeature_tpu.ops import embed

    monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    tr, ds = make_trainer(
        seed=9,
        extra={"common_feedback_space": 1, "num_ufeedback": 10},
        fb_bound=10,
    )
    assert not tr.hp.big_table
    tr.update_rounds(ds, 1)  # refresh path, standard layout
    assert tr.state.b.shape[0] > 0


# ---- whole-run dispatch (update_rounds) -----------------------------------


def _round_loop(tr, ds, rounds):
    """The per-round reference: one epoch per round at the schedule's lr."""
    for _ in range(rounds):
        tr._train_packed(tr._pack_plus(ds))
        if tr.tparam.decay_learning_rate:
            tr.learning_rate *= tr.tparam.decay_rate


ROUNDS_CASES = {
    "small": {},
    "small_decay": {"decay_learning_rate": 1, "decay_rate": 0.8},
    "small_multirow": {"rows_per_user": 2},
    "big_carry": {},
    "big_lazy": {"reg_method": 4},
    "common_space": {"common_feedback_space": 1, "num_ufeedback": 10},
}


@pytest.mark.parametrize("case", sorted(ROUNDS_CASES))
def test_update_rounds_matches_round_loop(monkeypatch, case):
    """update_rounds trains a packed dataset's rounds in one dispatch, a
    scan of the epoch over rounds (solvers/svdpp._scan_epochs); the state
    must equal the per-round loop's, on both table layouts and on the
    shared-feedback-space refresh epoch."""
    from svdfeature_tpu.ops import embed

    if case.startswith("big"):
        monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    kw = dict(fb_bound=10) if case == "common_space" else {}
    tr1, ds = make_trainer(seed=21, extra=ROUNDS_CASES[case], **kw)
    tr2, _ = make_trainer(seed=21, extra=ROUNDS_CASES[case], **kw)
    assert tr1.hp.big_table == case.startswith("big")
    if case == "big_carry":
        assert "chunk_users" in tr1._pack_plus(ds)[2]
    tr1.update_rounds(ds, 3)
    _round_loop(tr2, ds, 3)
    for a, b in zip(jax.tree.leaves(tr1.state), jax.tree.leaves(tr2.state)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
        )
    assert tr1.learning_rate == pytest.approx(tr2.learning_rate)


# ---- user-carry variant (carry_users=True) --------------------------------
def _pack_raw(tr, ds, rows_per_user=1):
    from svdfeature_tpu.data.batching_plus import pack_plus

    m = tr.model
    return pack_plus(
        ds, tr.users_per_batch, m.num_rows, m.param.num_global,
        m.off_user, m.off_item, m.off_ufeedback,
        num_user=m.param.num_user, num_item=m.param.num_item,
        num_ufeedback=m.param.num_ufeedback, rows_per_user=rows_per_user,
    )


@pytest.mark.parametrize("rows_per_user", [1, 2])
def test_big_epoch_carry_users_matches_small(rows_per_user):
    """carry_users=True (user rows carried in the scan, dense slab
    updates, one gather + one write per chunk) must reproduce the
    train_epoch_plus trajectory exactly like the entry path does."""
    tr, ds = make_trainer(seed=21, extra={"rows_per_user": rows_per_user})
    packed = _pack_raw(tr, ds, rows_per_user)
    plan = tr._carry_users_plan(packed)
    assert plan is not None
    fb = packed.fb_arrays()
    fb["chunk_users"] = plan
    stacked = packed.device_arrays()
    args = (
        jnp.float32(0.01), tr.consts, tr.hp,
        tr.tparam.scale_lr_ufeedback, tr.tparam.wd_ufeedback,
        tr.tparam.wd_ufeedback_bias,
    )
    n = int(tr.state.w.shape[0])
    hp_big = dataclasses.replace(
        tr.hp, big_table=True, num_factor=K
    )
    args_big = (
        jnp.float32(0.01), tr.consts, hp_big,
        tr.tparam.scale_lr_ufeedback, tr.tparam.wd_ufeedback,
        tr.tparam.wd_ufeedback_bias,
    )
    chunk_id = stacked.pop("chunk_id")
    st1 = jax.tree.map(jnp.copy, tr.state)
    st2 = augment_state(jax.tree.map(jnp.copy, tr.state), K)
    for _ in range(3):
        st1 = train_epoch_plus(
            st1, dict(stacked, chunk_id=chunk_id), chunk_id,
            packed.fb_arrays(), packed.fb_overlap, *args,
            rows_per_user=rows_per_user,
        )
        st2 = train_epoch_plus_big(
            st2, dict(stacked, chunk_id=chunk_id), chunk_id, fb,
            packed.fb_overlap, *args_big, rows_per_user=rows_per_user,
            carry_users=True,
        )
    assert_close(st1, deaugment_state(st2, K, n_rows=n))


def test_big_epoch_carry_no_user_bias_nonneg():
    tr, ds = make_trainer(
        seed=23, extra={"no_user_bias": 1, "user_nonnegative": 1}
    )
    packed = _pack_raw(tr, ds)
    plan = tr._carry_users_plan(packed)
    assert plan is not None
    fb = packed.fb_arrays()
    fb["chunk_users"] = plan
    stacked = packed.device_arrays()
    chunk_id = stacked.pop("chunk_id")
    n = int(tr.state.w.shape[0])
    hp_big = dataclasses.replace(
        tr.hp, big_table=True, num_factor=K
    )
    args = (
        jnp.float32(0.01), tr.consts, tr.hp,
        tr.tparam.scale_lr_ufeedback, tr.tparam.wd_ufeedback,
        tr.tparam.wd_ufeedback_bias,
    )
    args_big = args[:2] + (hp_big,) + args[3:]
    st1 = jax.tree.map(jnp.copy, tr.state)
    st2 = augment_state(jax.tree.map(jnp.copy, tr.state), K)
    for _ in range(2):
        st1 = train_epoch_plus(
            st1, dict(stacked, chunk_id=chunk_id), chunk_id,
            packed.fb_arrays(), packed.fb_overlap, *args,
        )
        st2 = train_epoch_plus_big(
            st2, dict(stacked, chunk_id=chunk_id), chunk_id, fb,
            packed.fb_overlap, *args_big, carry_users=True,
        )
    assert_close(st1, deaugment_state(st2, K, n_rows=n))


def test_carry_plan_rejects_nonconstant_user_segment():
    """Rows of one unit carrying different user-feature ids break the
    carry precondition — the plan must refuse (generic path handles)."""
    rng = np.random.RandomState(3)
    data_lines, fb_lines = [], []
    for u in range(6):
        nrows = 3
        fb_lines.append("3 1 2:0.5")
        for r in range(nrows):
            # user segment id varies per row within the unit
            data_lines.append(
                f"{rng.randint(1, 6)} 0 1 1 {(u + r) % 6}:1 "
                f"{rng.randint(0, 12)}:1"
            )
    ds = load_plus_text(
        "x", "y", text="\n".join(data_lines), feedback_text="\n".join(fb_lines)
    )
    tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1))
    for n, v in dict(
        num_user=6, num_item=12, num_ufeedback=15, num_factor=K,
        base_score=3, learning_rate=0.01, wd_user=0.004, wd_item=0.004,
        wd_ufeedback=0.003, users_per_batch=4,
    ).items():
        tr.set_param(n, str(v))
    tr.init_model()
    tr.init_trainer()
    assert tr._carry_users_plan(_pack_raw(tr, ds)) is None


def test_solver_big_table_engages_carry(monkeypatch):
    """Above the threshold with the classic layout, the solver's packed
    entry must carry chunk_users (i.e. the fast path is actually ON for
    the shape the bench measures) and train identically to the small
    path (already pinned by test_solver_routes_big_table)."""
    from svdfeature_tpu.ops import embed

    monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    tr, ds = make_trainer(seed=11)
    assert tr.hp.big_table
    entry = tr._pack_plus(ds)
    assert "chunk_users" in entry[2]


# ---- factored overlap (O = diag + dup @ dup.T) ----------------------------
def test_factored_overlap_matches_dense():
    """compute_fb_overlap_factored must reproduce the dense O exactly:
    O @ d == diag*d + dup @ (dup.T @ d) for random pools with partial
    in-chunk id duplication."""
    from svdfeature_tpu.data.batching_plus import (
        compute_fb_overlap,
        compute_fb_overlap_factored,
    )

    rng = np.random.RandomState(0)
    C, G, F = 3, 6, 24
    fb_idx = rng.randint(100, 140, (C, F)).astype(np.int64)  # some dups
    fb_val = rng.rand(C, F).astype(np.float32)
    fb_val[:, -4:] = 0.0  # padding entries
    fb_block = rng.randint(0, G, (C, F)).astype(np.int64)
    dense = compute_fb_overlap(fb_idx, fb_val, fb_block, G)
    fac = compute_fb_overlap_factored(fb_idx, fb_val, fb_block, G)
    assert fac is not None
    diag, dup = fac
    d = rng.rand(G + 1, 5).astype(np.float32)
    for c in range(C):
        want = dense[c] @ d
        got = diag[c][:, None] * d + dup[c] @ (dup[c].T @ d)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_factored_overlap_dense_fallback():
    """Densely duplicated pools (Ld > G+1) fall back to the dense O."""
    from svdfeature_tpu.data.batching_plus import compute_fb_overlap_factored

    rng = np.random.RandomState(1)
    C, G, F = 1, 2, 64
    fb_idx = rng.randint(0, 8, (C, F)).astype(np.int64)  # heavy dup... but
    # Ld counts unique DUPLICATED ids (<= 8 here), so force many:
    fb_idx = np.tile(np.arange(32), 2)[None, :].astype(np.int64)
    fb_val = np.ones((C, F), np.float32)
    fb_block = rng.randint(0, G, (C, F)).astype(np.int64)
    assert compute_fb_overlap_factored(fb_idx, fb_val, fb_block, G) is None


def test_big_epoch_factored_overlap_matches_small():
    """The solver's big path with a SPARSE-duplication pool emits the
    factored overlap and still matches the small-table trajectory."""
    from svdfeature_tpu.ops import embed

    # wide fb space + 1-2 fb/user so in-chunk duplication is sparse
    rng = np.random.RandomState(17)
    data_lines, fb_lines = [], []
    for u in range(10):
        nrows = int(rng.randint(2, 6))
        nfb = int(rng.randint(1, 3))
        fb_lines.append(
            f"{nrows} {nfb} "
            + " ".join(f"{rng.randint(0, 200)}:{rng.rand():.3f}"
                       for _ in range(nfb))
        )
        for _ in range(nrows):
            data_lines.append(
                f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 12)}:1"
            )
    ds = load_plus_text(
        "x", "y", text="\n".join(data_lines), feedback_text="\n".join(fb_lines)
    )

    def mk():
        tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1))
        for n, v in dict(
            num_user=10, num_item=12, num_ufeedback=200, num_factor=K,
            base_score=3, learning_rate=0.01, wd_user=0.004, wd_item=0.004,
            wd_ufeedback=0.003, users_per_batch=4,
        ).items():
            tr.set_param(n, str(v))
        tr.init_model()
        tr.init_trainer()
        return tr

    tr1 = mk()
    tr1.update_rounds(ds, 3)
    p1 = tr1.predict_all(ds)

    import pytest as _pytest

    mp = _pytest.MonkeyPatch()
    try:
        mp.setattr(embed, "ONEHOT_THRESHOLD", 4)
        tr2 = mk()
        assert tr2.hp.big_table
        entry = tr2._pack_plus(ds)
        assert isinstance(entry[4], dict)  # factored overlap engaged
        tr2.update_rounds(ds, 3)
        p2 = tr2.predict_all(ds)
    finally:
        mp.undo()
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)
