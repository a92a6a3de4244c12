"""The two scatter forms of the small-table path must agree.

The backend capability table (svdfeature_tpu/backend.py) picks one per
backend: ``.at[].add`` / ``segment_sum`` on the CPU and the GPU, [B, N]
one-hot matmuls where ``onehot_scatter`` is set.  The one-hot form
stays reachable through ``backend.override`` (and the ``force_onehot``
switch of the SVD++ pool ops), and must produce the same trajectory
across regularization modes, activation types and SVD++ layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdfeature_tpu import backend
from svdfeature_tpu.ops import embed
from svdfeature_tpu.ops.svdpp import _fb_aggregates, _fb_writeback

N, NG, K = 40, 4, 8


def make_run(seed, reg, active_type, T=3, B=24, Su=2, Si=2):
    rng = np.random.RandomState(seed)
    state = embed.TrainState(
        w=jnp.asarray(rng.normal(0, 0.1, (N, K)).astype(np.float32)).at[-1].set(0.0),
        b=jnp.asarray(rng.normal(0, 0.1, N).astype(np.float32)).at[-1].set(0.0),
        g=jnp.asarray(rng.normal(0, 0.1, NG).astype(np.float32)).at[-1].set(0.0),
        step=jnp.int32(5),
        ref_ui=jnp.asarray(rng.randint(0, 5, N).astype(np.int32)).at[-1].set(0),
        ref_g=jnp.asarray(rng.randint(0, 5, NG).astype(np.int32)),
    )
    if active_type == 0:
        label = rng.randint(1, 6, (T, B)).astype(np.float32)
    else:
        label = (rng.rand(T, B) > 0.5).astype(np.float32)
    stacked = {
        "u_idx": jnp.asarray(rng.randint(0, 15, (T, B, Su)).astype(np.int32)),
        "i_idx": jnp.asarray(rng.randint(15, N - 1, (T, B, Si)).astype(np.int32)),
        "g_idx": jnp.asarray(rng.randint(0, NG - 1, (T, B, 1)).astype(np.int32)),
        "u_val": jnp.asarray(rng.rand(T, B, Su).astype(np.float32)),
        "i_val": jnp.asarray(rng.rand(T, B, Si).astype(np.float32)),
        "g_val": jnp.asarray(rng.rand(T, B, 1).astype(np.float32)),
        "label": jnp.asarray(label),
        "weight": jnp.asarray((rng.rand(T, B) > 0.1).astype(np.float32)),
    }
    consts = embed.TrainConsts(
        wd_u_row=jnp.full((N,), 0.02, jnp.float32).at[-1].set(0.0),
        wd_i_row=jnp.full((N,), 0.03, jnp.float32).at[-1].set(0.0),
        wd_g_row=jnp.full((NG,), 0.01, jnp.float32).at[-1].set(0.0),
        wd_user_bias=jnp.float32(0.01),
        wd_item_bias=jnp.float32(0.02),
    )
    hp = embed.HyperParams(
        reg_method=reg, reg_global=0, active_type=active_type,
        base_score=3.0 if active_type == 0 else 0.0,
    )
    lrs = jnp.asarray([0.05, 0.04], jnp.float32)
    return state, stacked, lrs, consts, hp


def train(state, stacked, lrs, consts, hp):
    return embed.train_rounds(
        jax.tree.map(jnp.copy, state), stacked, lrs, consts, hp
    )


def assert_close(a, b):
    for n in ("w", "b", "g"):
        np.testing.assert_allclose(
            np.asarray(getattr(a, n)), np.asarray(getattr(b, n)),
            rtol=1e-5, atol=2e-6, err_msg=n,
        )
    np.testing.assert_array_equal(np.asarray(a.ref_ui), np.asarray(b.ref_ui))
    assert int(a.step) == int(b.step)


@pytest.mark.parametrize("active_type", [0, 2])
@pytest.mark.parametrize("reg", [0, 1, 2, 3, 4, 5])
def test_onehot_form_matches_scatter_form(reg, active_type):
    args = make_run(reg * 7 + active_type, reg, active_type)
    ref = train(*args)
    with backend.override(onehot_scatter=True):
        assert embed._use_onehot(N)
        got = train(*args)
    assert_close(got, ref)


@pytest.mark.parametrize("nonneg", [0, 1])
def test_fused_onehot_step_matches_scatter_form(nonneg):
    """Single-feature segments under eager L2 take the fused one-hot
    step (_train_step_fused) in the one-hot form."""
    state, stacked, lrs, consts, hp = make_run(3, 0, 0, Su=1, Si=1)
    hp = embed.HyperParams(
        base_score=3.0, user_nonnegative=nonneg, item_nonnegative=nonneg
    )
    ref = train(state, stacked, lrs, consts, hp)
    with backend.override(onehot_scatter=True):
        assert embed._can_fuse(hp, jax.tree.map(lambda a: a[0], stacked), N)
        got = train(state, stacked, lrs, consts, hp)
    assert_close(got, ref)


@pytest.mark.parametrize("rows_per_user", [1, 2])
@pytest.mark.parametrize("no_user_bias", [0, 1])
def test_svdpp_epoch_onehot_matches_scatter(rows_per_user, no_user_bias):
    from tests.test_svdpp_big import make_trainer

    tr, ds = make_trainer(
        seed=17 + rows_per_user,
        extra={"rows_per_user": rows_per_user, "no_user_bias": no_user_bias},
    )
    stacked, chunk_id, fb, _, overlap = tr._pack_plus(ds)
    args = (
        stacked, chunk_id, fb, overlap, jnp.float32(0.01), tr.consts, tr.hp,
        tr.tparam.scale_lr_ufeedback, tr.tparam.wd_ufeedback,
        tr.tparam.wd_ufeedback_bias,
    )
    from svdfeature_tpu.ops.svdpp import train_epoch_plus

    ref = train_epoch_plus(
        jax.tree.map(jnp.copy, tr.state), *args, rows_per_user=rows_per_user
    )
    with backend.override(onehot_scatter=True):
        got = train_epoch_plus(
            jax.tree.map(jnp.copy, tr.state), *args, rows_per_user=rows_per_user
        )
    assert_close(got, ref)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("force", [True, False])
def test_fb_pool_ops_force_onehot(with_bias, force):
    """force_onehot overrides the table row for the SVD++ pool ops."""
    rng = np.random.RandomState(4)
    n, k, F, G = 30, 4, 21, 5
    w = jnp.asarray(rng.randn(n, k).astype(np.float32))
    b = jnp.asarray(rng.randn(n).astype(np.float32))
    cfb = {
        "fb_idx": jnp.asarray(rng.randint(0, n, F).astype(np.int32)),
        "fb_val": jnp.asarray(rng.rand(F).astype(np.float32)),
        "fb_block": jnp.asarray(rng.randint(0, G + 1, F).astype(np.int32)),
    }
    delta = jnp.asarray(rng.randn(G + 1, k).astype(np.float32))
    delta_b = jnp.asarray(rng.randn(G + 1).astype(np.float32))
    plain = _fb_aggregates(w, b, cfb, G + 1, with_bias, force_onehot=False)
    forced = _fb_aggregates(w, b, cfb, G + 1, with_bias, force_onehot=force)
    for x, y in zip(forced, plain):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-5)
    pw = _fb_writeback(w, b, cfb, delta, delta_b if with_bias else None,
                       with_bias, force_onehot=False)
    fw = _fb_writeback(w, b, cfb, delta, delta_b if with_bias else None,
                       with_bias, force_onehot=force)
    for x, y in zip(fw, pw):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-5)
