"""Large-table sorted-dedup step (ops/big_embed.py) equivalence tests.

The big-table path must produce the same batched-SGD semantics as the
general path (ops/embed.train_step) — identical math, different
execution strategy — for every regularization mode, hierarchy segment
shapes, duplicates, no_user_bias and nonnegativity.  chip_smoke.py
repeats the comparison on the card at the KDD table geometry.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from svdfeature_tpu.ops import embed
from svdfeature_tpu.ops.big_embed import (
    augment_state,
    deaugment_state,
    sorted_dedup,
    train_step_big,
)


def run_big(state, batch, lr, consts, hp, k=4):
    """Drive the big path through its augmented layout round trip."""
    hp = dataclasses.replace(hp, big_table=True, num_factor=k)
    out = train_step_big(augment_state(state, k), batch, lr, consts, hp)
    return deaugment_state(out, k)


def make_inputs(seed, n=50, k=4, ng=5, B=16, Su=2, Si=3, lazy_refs=True):
    rng = np.random.RandomState(seed)
    state = embed.TrainState(
        w=jnp.asarray(rng.normal(0, 0.1, (n, k)).astype(np.float32)).at[-1].set(0.0),
        b=jnp.asarray(rng.normal(0, 0.1, n).astype(np.float32)).at[-1].set(0.0),
        g=jnp.asarray(rng.normal(0, 0.1, ng).astype(np.float32)).at[-1].set(0.0),
        step=jnp.int32(37),
        # dummy row's ref pinned to 0: both paths keep it there (the big
        # path lands duplicate zero-writes on the dummy row)
        ref_ui=jnp.asarray(rng.randint(0, 30, n).astype(np.int32)).at[-1].set(0),
        ref_g=jnp.asarray(rng.randint(0, 30, ng).astype(np.int32)),
    )
    batch = {
        "u_idx": jnp.asarray(rng.randint(0, 20, (B, Su)).astype(np.int32)),
        "i_idx": jnp.asarray(rng.randint(20, n - 1, (B, Si)).astype(np.int32)),
        "g_idx": jnp.asarray(rng.randint(0, ng - 1, (B, 1)).astype(np.int32)),
        "u_val": jnp.asarray(rng.rand(B, Su).astype(np.float32)),
        "i_val": jnp.asarray(rng.rand(B, Si).astype(np.float32)),
        "g_val": jnp.asarray(rng.rand(B, 1).astype(np.float32)),
        "label": jnp.asarray(rng.randint(1, 6, B).astype(np.float32)),
        "weight": jnp.asarray(np.ones(B, np.float32)),
    }
    consts = embed.TrainConsts(
        wd_u_row=jnp.asarray((rng.rand(n) * 0.05).astype(np.float32)).at[-1].set(0.0),
        wd_i_row=jnp.asarray((rng.rand(n) * 0.05).astype(np.float32)).at[-1].set(0.0),
        wd_g_row=jnp.asarray((rng.rand(ng) * 0.02).astype(np.float32)).at[-1].set(0.0),
        wd_user_bias=jnp.float32(0.01),
        wd_item_bias=jnp.float32(0.02),
    )
    return state, batch, consts


def clone(state):
    return jax.tree_util.tree_map(jnp.array, state)


def assert_state_close(a, b, atol=2e-5):
    np.testing.assert_allclose(np.asarray(a.w), np.asarray(b.w), atol=atol)
    np.testing.assert_allclose(np.asarray(a.b), np.asarray(b.b), atol=atol)
    np.testing.assert_allclose(np.asarray(a.g), np.asarray(b.g), atol=atol)
    np.testing.assert_array_equal(np.asarray(a.ref_ui), np.asarray(b.ref_ui))
    np.testing.assert_array_equal(np.asarray(a.ref_g), np.asarray(b.ref_g))
    assert int(a.step) == int(b.step)


@pytest.mark.parametrize("reg", [0, 1, 2, 3, 4, 5])
def test_big_matches_general(reg):
    state, batch, consts = make_inputs(reg + 1)
    hp = embed.HyperParams(reg_method=reg, reg_global=0, base_score=3.0)
    lr = jnp.float32(0.05)
    out_gen = embed.train_step(clone(state), batch, lr, consts, hp)
    out_big = run_big(clone(state), batch, lr, consts, hp)
    assert_state_close(out_gen, out_big)


@pytest.mark.parametrize("rg", [0, 1, 4, 5])
def test_big_matches_general_global_modes(rg):
    state, batch, consts = make_inputs(11)
    hp = embed.HyperParams(reg_method=0, reg_global=rg, base_score=3.0)
    lr = jnp.float32(0.05)
    out_gen = embed.train_step(clone(state), batch, lr, consts, hp)
    out_big = run_big(clone(state), batch, lr, consts, hp)
    assert_state_close(out_gen, out_big)


def test_big_no_user_bias_nonneg():
    state, batch, consts = make_inputs(3)
    hp = embed.HyperParams(
        reg_method=0, no_user_bias=1, user_nonnegative=1, item_nonnegative=1,
        base_score=3.0,
    )
    lr = jnp.float32(0.05)
    out_gen = embed.train_step(clone(state), batch, lr, consts, hp)
    out_big = run_big(clone(state), batch, lr, consts, hp)
    assert_state_close(out_gen, out_big)


def test_big_exact_global_batch1():
    state, batch, consts = make_inputs(5, B=1, Su=1, Si=1)
    hp = embed.HyperParams(reg_method=0, base_score=3.0, exact_global=True)
    lr = jnp.float32(0.05)
    out_gen = embed.train_step(clone(state), batch, lr, consts, hp)
    out_big = run_big(clone(state), batch, lr, consts, hp)
    assert_state_close(out_gen, out_big)


def test_big_handles_padding_rows():
    """Padded entries (dummy row target, weight 0) must leave the dummy
    row zero and not disturb real rows."""
    state, batch, consts = make_inputs(7)
    n = state.w.shape[0]
    batch = dict(batch)
    # poison: last 4 examples are padding
    batch["weight"] = batch["weight"].at[-4:].set(0.0)
    batch["u_idx"] = batch["u_idx"].at[-4:].set(n - 1)
    batch["i_idx"] = batch["i_idx"].at[-4:].set(n - 1)
    batch["g_idx"] = batch["g_idx"].at[-4:].set(state.g.shape[0] - 1)
    hp = embed.HyperParams(reg_method=0, base_score=3.0)
    lr = jnp.float32(0.05)
    out_gen = embed.train_step(clone(state), batch, lr, consts, hp)
    out_big = run_big(clone(state), batch, lr, consts, hp)
    assert_state_close(out_gen, out_big)
    assert np.all(np.asarray(out_big.w)[-1] == 0.0)
    assert float(np.asarray(out_big.b)[-1]) == 0.0


def test_sorted_dedup_matches_segment_sum():
    rng = np.random.RandomState(0)
    E, C = 64, 5
    idx = jnp.asarray(rng.randint(0, 10, E).astype(np.int32))
    pay = jnp.asarray(rng.normal(0, 1, (E, C)).astype(np.float32))
    order, si, acc, first, last = sorted_dedup(idx, pay)
    want = np.zeros((10, C), np.float32)
    np.add.at(want, np.asarray(idx), np.asarray(pay))
    si_np, acc_np, last_np = map(np.asarray, (si, acc, last))
    got = {int(r): acc_np[j] for j, r in enumerate(si_np) if last_np[j]}
    for r, v in got.items():
        np.testing.assert_allclose(v, want[r], atol=1e-5)
    assert set(got) == set(int(x) for x in np.asarray(idx))


@pytest.mark.parametrize("reg", [0, 1, 4, 5])
@pytest.mark.parametrize("B", [256, 1024, 4096])
def test_big_matches_general_dense_batches(B, reg):
    """Batches dense enough that every row of a small table is touched
    many times per step (2B/n = 10-160 entries per row; the density at
    which the removed tile-sweep write path used to take over): the
    sorted-dedup step still equals the general step."""
    state, batch, consts = make_inputs(B + reg, n=50, B=B, Su=1, Si=1)
    hp = embed.HyperParams(reg_method=reg, reg_global=0, base_score=3.0)
    lr = jnp.float32(0.002)
    out_gen = embed.train_step(clone(state), batch, lr, consts, hp)
    out_big = run_big(clone(state), batch, lr, consts, hp)
    assert_state_close(out_gen, out_big, atol=5e-5)
