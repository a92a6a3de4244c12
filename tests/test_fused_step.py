"""The fused one-hot form (ops/embed._train_step_fused, taken where the
backend's capability row asks for one-hot scatters) must match the
general train step numerically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdfeature_tpu.ops.embed import (
    HyperParams,
    _train_step_fused,
    train_step,
)

import __graft_entry__ as ge


@pytest.mark.parametrize("no_user_bias", [0, 1])
@pytest.mark.parametrize("nonneg", [0, 1])
def test_fused_step_matches_general(no_user_bias, nonneg):
    state, batch, hp, consts = ge._toy_setup(batch_size=64, k=8)
    hp = HyperParams(
        active_type=hp.active_type,
        base_score=hp.base_score,
        no_user_bias=no_user_bias,
        user_nonnegative=nonneg,
        item_nonnegative=nonneg,
    )
    # real global features + duplicated rows to exercise every payload lane
    rng = np.random.RandomState(1)
    batch = dict(batch)
    batch["g_idx"] = jnp.asarray(rng.randint(0, 1, (64, 1)).astype(np.int32))
    batch["g_val"] = jnp.asarray(rng.rand(64, 1).astype(np.float32))
    batch["u_idx"] = jnp.asarray((rng.randint(0, 20, (64, 1))).astype(np.int32))
    batch["weight"] = jnp.asarray((rng.rand(64) > 0.1).astype(np.float32))
    lr = jnp.float32(0.01)
    ref = train_step(jax.tree.map(jnp.copy, state), batch, lr, consts, hp)
    out = _train_step_fused(jax.tree.map(jnp.copy, state), batch, lr, consts, hp)
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)),
            np.asarray(getattr(ref, name)),
            rtol=2e-5,
            atol=1e-6,
            err_msg=name,
        )
    assert int(out.step) == int(ref.step)


def test_fb_onehot_forms_match_plain():
    """The one-hot matmul forms of the SVD++ feedback aggregation and pool
    writeback must match the segment_sum/scatter forms."""
    from svdfeature_tpu.ops.svdpp import _fb_aggregates, _fb_writeback

    rng = np.random.RandomState(0)
    N, k, F, G = 50, 8, 37, 6
    w = jnp.asarray(rng.randn(N, k).astype(np.float32))
    b = jnp.asarray(rng.randn(N).astype(np.float32))
    cfb = {
        "fb_idx": jnp.asarray(rng.randint(0, N, F).astype(np.int32)),
        "fb_val": jnp.asarray((rng.rand(F) * (rng.rand(F) > 0.2)).astype(np.float32)),
        "fb_block": jnp.asarray(rng.randint(0, G + 1, F).astype(np.int32)),
    }
    for with_bias in (True, False):
        ref = _fb_aggregates(w, b, cfb, G + 1, with_bias, force_onehot=False)
        out = _fb_aggregates(w, b, cfb, G + 1, with_bias, force_onehot=True)
        for r, o, nm in zip(ref, out, ("fb_sum", "norm", "fb_bias")):
            np.testing.assert_allclose(
                np.asarray(o), np.asarray(r), rtol=2e-5, atol=1e-6, err_msg=nm
            )
        delta = jnp.asarray(rng.randn(G + 1, k).astype(np.float32) * 0.01)
        delta_b = jnp.asarray(rng.randn(G + 1).astype(np.float32) * 0.01)
        rw, rb = _fb_writeback(
            jnp.copy(w), jnp.copy(b), cfb, delta, delta_b, with_bias,
            force_onehot=False,
        )
        ow, ob = _fb_writeback(
            jnp.copy(w), jnp.copy(b), cfb, delta, delta_b, with_bias,
            force_onehot=True,
        )
        np.testing.assert_allclose(np.asarray(ow), np.asarray(rw), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(ob), np.asarray(rb), rtol=2e-5, atol=1e-6)


def test_fused_row_update_with_feedback_extras():
    """_train_step_fused with p_u_extra/bias_extra (the SVD++ per-row path)
    must match the general _row_update."""
    from svdfeature_tpu.ops.embed import _train_step_fused
    from svdfeature_tpu.ops.svdpp import _row_update

    state, batch, hp, consts = ge._toy_setup(batch_size=32, k=8, num_global=3)
    rng = np.random.RandomState(7)
    p_u_extra = jnp.asarray(rng.randn(32, 8).astype(np.float32) * 0.1)
    bias_extra = jnp.asarray(rng.randn(32).astype(np.float32) * 0.1)
    lr = jnp.float32(0.01)
    ref, ref_err, ref_pi = _row_update(
        jax.tree.map(jnp.copy, state), batch, lr, consts, hp, p_u_extra, bias_extra
    )
    out, err, p_i = _train_step_fused(
        jax.tree.map(jnp.copy, state), batch, lr, consts, hp,
        p_u_extra, bias_extra, return_err_pi=True,
    )
    np.testing.assert_allclose(np.asarray(err), np.asarray(ref_err), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(p_i), np.asarray(ref_pi), rtol=2e-5, atol=1e-6)
    for name in ("w", "b", "g"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
            rtol=2e-5, atol=1e-6, err_msg=name,
        )


def test_bilinear_carried_epoch_matches_refresh():
    """train_epoch_bi (overlap closed form, filtered pool) must reproduce
    the per-batch-refresh trajectory."""
    from svdfeature_tpu.data.text import load_plus_text
    from svdfeature_tpu.ops.svdpp_bilinear import (
        train_epoch_bi,
        train_epoch_bi_refresh,
    )
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.bilinear import SVDBiLinearTrainer

    rng = np.random.RandomState(11)
    data_lines, fb_lines = [], []
    for u in range(10):
        nrows = int(rng.randint(2, 6))
        nfb = int(rng.randint(2, 6))
        fb_lines.append(
            f"{nrows} {nfb} "
            + " ".join(f"{rng.randint(0, 15)}:{rng.rand():.3f}" for _ in range(nfb))
        )
        for _ in range(nrows):
            data_lines.append(
                f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 12)}:1"
            )
    ds = load_plus_text(
        "x", "y", text="\n".join(data_lines), feedback_text="\n".join(fb_lines)
    )
    mt = SVDTypeParam(format_type=1, extend_type=15)
    tr = SVDBiLinearTrainer(mt)
    for n, v in dict(
        num_user=10, num_item=12, num_ufeedback=15, num_factor=8, base_score=3,
        learning_rate=0.01, wd_user=0.004, wd_item=0.004, wd_ufeedback=0.004,
        num_bi_feedback=6, start_ufeedback=3, wd_bi_feedback=0.002,
        users_per_batch=4,
    ).items():
        tr.set_param(n, str(v))
    tr.init_model()
    tr.init_trainer()
    stacked, chunk_id, fb, _, up, overlap = tr._pack_plus(ds)
    args_common = (
        jnp.float32(0.01), tr.consts, tr.hp,
        tr.tparam.scale_lr_ufeedback, tr.tparam.wd_ufeedback,
        tr.tparam.wd_ufeedback_bias, tr.slr_bi_feedback,
        tr.wd_bi_feedback, tr.reg_bi_feedback, tr.model.off_item,
    )
    st1, wb1 = jax.tree.map(jnp.copy, tr.state), jnp.copy(tr.W_bi)
    st2, wb2 = jax.tree.map(jnp.copy, tr.state), jnp.copy(tr.W_bi)
    for _ in range(3):
        st1, wb1 = train_epoch_bi(
            st1, wb1, stacked, chunk_id, fb, overlap, up, *args_common
        )
        st2, wb2 = train_epoch_bi_refresh(
            st2, wb2, stacked, chunk_id, fb, up, *args_common
        )
    np.testing.assert_allclose(np.asarray(st1.w), np.asarray(st2.w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st1.b), np.asarray(st2.b), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(wb1), np.asarray(wb2), rtol=1e-4, atol=1e-6)


def test_svdpp_carried_epoch_matches_refresh():
    """train_epoch_plus (overlap closed form) must reproduce the per-batch
    refresh trajectory (train_epoch_plus_refresh)."""
    from svdfeature_tpu.data.text import load_plus_text
    from svdfeature_tpu.ops.svdpp import train_epoch_plus, train_epoch_plus_refresh
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    rng = np.random.RandomState(13)
    data_lines, fb_lines = [], []
    for u in range(10):
        nrows = int(rng.randint(2, 6))
        nfb = int(rng.randint(1, 5))
        fb_lines.append(
            f"{nrows} {nfb} "
            + " ".join(f"{rng.randint(0, 15)}:{rng.rand():.3f}" for _ in range(nfb))
        )
        for _ in range(nrows):
            data_lines.append(
                f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 12)}:1"
            )
    ds = load_plus_text(
        "x", "y", text="\n".join(data_lines), feedback_text="\n".join(fb_lines)
    )
    mt = SVDTypeParam(format_type=1)
    tr = SVDPPFeatureTrainer(mt)
    for n, v in dict(
        num_user=10, num_item=12, num_ufeedback=15, num_factor=8, base_score=3,
        learning_rate=0.01, wd_user=0.004, wd_item=0.004, wd_ufeedback=0.004,
        users_per_batch=4,
    ).items():
        tr.set_param(n, str(v))
    tr.init_model()
    tr.init_trainer()
    stacked, chunk_id, fb, _, overlap = tr._pack_plus(ds)
    args = (
        jnp.float32(0.01), tr.consts, tr.hp,
        tr.tparam.scale_lr_ufeedback, tr.tparam.wd_ufeedback,
        tr.tparam.wd_ufeedback_bias,
    )
    st1 = jax.tree.map(jnp.copy, tr.state)
    st2 = jax.tree.map(jnp.copy, tr.state)
    for _ in range(3):
        st1 = train_epoch_plus(st1, stacked, chunk_id, fb, overlap, *args)
        st2 = train_epoch_plus_refresh(st2, stacked, chunk_id, fb, *args)
    np.testing.assert_allclose(np.asarray(st1.w), np.asarray(st2.w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st1.b), np.asarray(st2.b), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st1.g), np.asarray(st2.g), rtol=1e-4, atol=1e-6)


def test_compute_fb_overlap_brute_force():
    """O[u,v] = sum over shared feedback ids of val_u * val_v."""
    from svdfeature_tpu.data.batching_plus import compute_fb_overlap

    rng = np.random.RandomState(5)
    C, F, G = 2, 30, 4
    fb_idx = rng.randint(0, 10, (C, F)).astype(np.int32)
    fb_val = (rng.rand(C, F) * (rng.rand(C, F) > 0.3)).astype(np.float32)
    fb_block = rng.randint(0, G + 1, (C, F)).astype(np.int32)
    O = compute_fb_overlap(fb_idx, fb_val, fb_block, G)
    for c in range(C):
        want = np.zeros((G + 1, G + 1), np.float32)
        for u in range(G + 1):
            for v in range(G + 1):
                for f1 in range(F):
                    for f2 in range(F):
                        if (
                            fb_block[c, f1] == u
                            and fb_block[c, f2] == v
                            and fb_idx[c, f1] == fb_idx[c, f2]
                        ):
                            want[u, v] += fb_val[c, f1] * fb_val[c, f2]
        np.testing.assert_allclose(O[c], want, rtol=1e-5, atol=1e-6)
