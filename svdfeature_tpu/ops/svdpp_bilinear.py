"""Bilinear-extended SVD++ train epoch (extend_type=15).

Adds the W_bi[item, bi_feedback] interaction of SVDBiLinearTrainer
(solvers/bilinear/apex_svd_bilinear.h) to the one-row-per-user SVD++ step:

  score   += sum_s i_val[g,s] * <W_bi[iid_s], up[g]>      (get_bias_plugin)
  W_bi[iid] += lr_bi * err * i_val * up[g]                 (update_bias_plugin)

where up[g] is the dense user-property vector of block g (feedback entries
with id < num_bi_feedback), precomputed at pack time.

Regularization modes for W_bi (reg_feedback, apex_svd_bilinear.h:93-128):
  0 L2 per touched pair, 1 L1 per touched pair,
  2 L2 whole item row per item-occurrence, 3 L1 whole row,
  4/5 truncated-gradient L1 per touched pair (the reference's lazy k
  counter has the same unsigned-subtraction bug as the base solver; we
  apply the per-touch threshold, i.e. k=1).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .embed import (
    HIGHEST,
    HyperParams,
    TrainConsts,
    TrainState,
    _mm,
    _soft_threshold,
)
from .svdpp import (
    _fb_aggregates,
    _fb_writeback,
    _plus_step,
    _row_update,
    forward_scores,
)


def _bi_bias(W_bi_pad, up_slot, i_idx_local, i_val):
    """[G] plugin bias: sum_s i_val[g,s] * <W_bi[lid], up[g]>."""
    rows = W_bi_pad[i_idx_local]  # [G, S, nbf]
    per = jnp.einsum("gsn,gn->gs", rows, up_slot, precision=HIGHEST)
    return jnp.einsum("gs,gs->g", per, i_val, precision=HIGHEST)


def _local_item_ids(i_idx, off_item, num_item):
    lid = i_idx - off_item
    ok = (lid >= 0) & (lid < num_item)
    return jnp.where(ok, lid, num_item), ok


def _bi_step(W_bi_pad, up_slot, batch, err, lr_bi, wd_bi, reg_bi, off_item):
    """Update + regularize W_bi for one batch; returns new W_bi_pad."""
    num_item = W_bi_pad.shape[0] - 1
    i_idx, i_val = batch["i_idx"], batch["i_val"]
    lid, _ = _local_item_ids(i_idx, off_item, num_item)
    G, S = lid.shape
    coef = (lr_bi * err)[:, None] * i_val  # [G, S]
    upd = coef[..., None] * up_slot[:, None, :]  # [G, S, nbf]
    W_bi_pad = W_bi_pad.at[lid.reshape(-1)].add(upd.reshape(G * S, -1))

    lam = lr_bi * wd_bi
    if reg_bi in (0, 1, 4, 5):
        # per-pair decay on touched (item, prop) pairs, once per touch
        touch = jnp.zeros_like(W_bi_pad)
        pair_touch = (jnp.abs(i_val) > 0)[..., None] * (
            jnp.abs(up_slot) > 0
        )[:, None, :]
        touch = touch.at[lid.reshape(-1)].add(
            pair_touch.reshape(G * S, -1).astype(jnp.float32)
        )
        if reg_bi == 0:
            W_bi_pad = W_bi_pad * jnp.power(1.0 - lam, touch)
        else:
            W_bi_pad = _soft_threshold(W_bi_pad, lam * touch)
    elif reg_bi in (2, 3):
        # whole-row decay per item occurrence
        cnt = jnp.zeros((num_item + 1,), jnp.float32).at[lid.reshape(-1)].add(
            jnp.where(jnp.abs(i_val).reshape(-1) > 0, 1.0, 0.0)
        )
        if reg_bi == 2:
            W_bi_pad = W_bi_pad * jnp.power(1.0 - lam, cnt)[:, None]
        else:
            W_bi_pad = _soft_threshold(W_bi_pad, (lam * cnt)[:, None])
    else:
        raise ValueError(f"unknown bi feedback decay method {reg_bi}")
    return W_bi_pad.at[-1].set(0.0)


@partial(
    jax.jit,
    static_argnames=("hp", "reg_bi", "rows_per_user"),
    donate_argnames=("state", "W_bi"),
)
def train_epoch_bi(
    state: TrainState,
    W_bi,
    stacked,
    chunk_id,
    fb,
    fb_overlap,
    up,
    lr,
    consts: TrainConsts,
    hp: HyperParams,
    scale_lr_ufeedback=1.0,
    wd_ufeedback=0.0,
    wd_ufeedback_bias=0.0,
    slr_bi=1.0,
    wd_bi=0.0,
    reg_bi: int = 0,
    off_item: int = 0,
    rows_per_user: int = 1,
):
    """Pool work O(chunks) via the pack-time overlap closed form — same
    scheme as ops/svdpp.train_epoch_plus (see its docstring), extended
    with the bilinear plugin bias + W_bi update per batch.  fb_overlap
    must be computed from the FILTERED pool values (start_ufeedback).

    rows_per_user (M>1): batches are [T, G*M] with M consecutive slots
    per user (data/batching_plus.py).  The SVD++ feedback recurrence
    uses the same implicitly-damped M-wide Jacobi step as
    train_epoch_plus; the W_bi update needs no extra damping — a user's
    M rows touch (mostly distinct) item rows with gradients computed
    from the pre-batch W_bi, the same hogwild contract as M=1's
    across-user sums (reference sequential loop:
    apex_svd_bilinear.h:130-154)."""
    import dataclasses

    T, GS = stacked["label"].shape
    M = rows_per_user
    G = GS // M
    k = state.w.shape[1]
    lr_fb = lr * scale_lr_ufeedback
    d = 1.0 - lr_fb * wd_ufeedback
    db = 1.0 - lr_fb * wd_ufeedback_bias
    lr_bi = lr * slr_bi
    num_item = W_bi.shape[0]
    with_bias = not hp.no_user_bias
    W_bi_pad = jnp.concatenate([W_bi, jnp.zeros((1, W_bi.shape[1]))], axis=0)
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), chunk_id[1:] != chunk_id[:-1]]
    )

    def flush(st, cid, dacc, dbacc):
        cfb = jax.tree.map(lambda a: a[cid], fb)
        w, b = _fb_writeback(
            st.w, st.b, cfb, dacc, dbacc if with_bias else None, with_bias
        )
        return dataclasses.replace(st, w=w, b=b)

    def body(carry, xs):
        st, Wb, pc, O, fb_sum, fb_bias, norm, inv, dacc, dbacc = carry
        batch, cid, first = xs

        def on_boundary(op):
            st, pc, dacc, dbacc = op
            st = flush(st, pc, dacc, dbacc)
            cfb = jax.tree.map(lambda a: a[cid], fb)
            s, nrm, sb = _fb_aggregates(st.w, st.b, cfb, G + 1, with_bias)
            nrm = nrm[:G]
            inv = jnp.where(nrm > 0, 1.0 / jnp.maximum(nrm, 1e-30), 0.0)
            return (
                st, fb_overlap[cid], s[:G], sb[:G], nrm, inv,
                jnp.zeros_like(dacc), jnp.zeros_like(dbacc),
            )

        def off_boundary(op):
            st, pc, dacc, dbacc = op
            return st, O, fb_sum, fb_bias, norm, inv, dacc, dbacc

        st, O, fb_sum, fb_bias, norm, inv, dacc, dbacc = jax.lax.cond(
            first, on_boundary, off_boundary, (st, pc, dacc, dbacc)
        )
        up_slot = up[cid][:G]  # [G, nbf]
        up_rep = jnp.repeat(up_slot, M, axis=0) if M > 1 else up_slot
        lid, _ = _local_item_ids(batch["i_idx"], off_item, num_item)
        plug = _bi_bias(Wb, up_rep, lid, batch["i_val"])
        fb_slot = jnp.repeat(fb_sum, M, axis=0) if M > 1 else fb_sum
        fbb_slot = (
            (jnp.repeat(fb_bias, M) if M > 1 else fb_bias)
            if with_bias
            else None
        )
        st, err, p_i = _row_update(
            st, batch, lr, consts, hp, fb_slot, fbb_slot, bias_plugin=plug,
        )
        Wb = _bi_step(Wb, up_rep, batch, err, lr_bi, wd_bi, reg_bi, off_item)
        present = batch["weight"]
        # per-user reduction + M-wide Jacobi with the implicit damping of
        # ops/svdpp.train_epoch_plus (see its comment for the law); the
        # power form d**m_g with m_g in {0,1} IS the M=1 recurrence, so
        # single-row users stay bit-identical across M
        m_g = present.reshape(G, M).sum(axis=1)
        errpi = (err[:, None] * p_i).reshape(G, M, k).sum(axis=1)
        err_g = err.reshape(G, M).sum(axis=1)
        if M > 1:
            frac = jnp.where(m_g > 0, (m_g - 1.0) / jnp.maximum(m_g, 1.0), 0.0)
            pip2 = jnp.sum(p_i * p_i, axis=1).reshape(G, M).sum(axis=1)
            errpi = errpi / (1.0 + lr_fb * norm * pip2 * frac)[:, None]
            err_g = err_g / (1.0 + lr_fb * norm * (m_g - 1.0) * (m_g > 0))
        dtmp = (
            fb_sum * (jnp.power(d, m_g) - 1.0)[:, None]
            + lr_fb * norm[:, None] * errpi
        )
        delta_pad = jnp.concatenate([dtmp * inv[:, None], jnp.zeros((1, k))], 0)
        dacc = dacc + delta_pad
        fb_sum = fb_sum + _mm(O, delta_pad)[:G]
        if with_bias:
            dtmp_b = (
                fb_bias * (jnp.power(db, m_g) - 1.0) + lr_fb * norm * err_g
            )
            delta_b_pad = jnp.concatenate([dtmp_b * inv, jnp.zeros((1,))])
            dbacc = dbacc + delta_b_pad
            fb_bias = fb_bias + _mm(O, delta_b_pad)[:G]
        return (st, Wb, cid, O, fb_sum, fb_bias, norm, inv, dacc, dbacc), None

    z = jnp.zeros((G, k), jnp.float32)
    zb = jnp.zeros((G,), jnp.float32)
    init = (
        state, W_bi_pad, jnp.int32(0), jnp.zeros((G + 1, G + 1), jnp.float32),
        z, zb, zb, zb,
        jnp.zeros((G + 1, k), jnp.float32), jnp.zeros((G + 1,), jnp.float32),
    )
    (state, W_bi_pad, last_cid, _, _, _, _, _, dacc, dbacc), _ = jax.lax.scan(
        body, init, (stacked, chunk_id, is_first)
    )
    state = flush(state, last_cid, dacc, dbacc)
    return state, W_bi_pad[:-1]


def _bi_step_big(W_bi_pad, up_slot, batch, err, lr_bi, wd_bi, reg_bi, off_item):
    """_bi_step on a large W_bi: touched-rows-only gather -> sorted-dedup
    merge -> ONE unique-row write (ops/big_embed primitives), instead of
    the table-sized .at[].add + whole-table decay.  Identical math: only
    touched rows change under either form (untouched rows have touch
    count 0, so decay^0 == 1)."""
    from .big_embed import gather_rows, sorted_dedup, write_rows_unique

    num_item = W_bi_pad.shape[0] - 1
    nbf = W_bi_pad.shape[1]
    i_idx, i_val = batch["i_idx"], batch["i_val"]
    lid, _ = _local_item_ids(i_idx, off_item, num_item)  # dummy = num_item
    G, S = lid.shape
    coef = (lr_bi * err)[:, None] * i_val  # [G, S]
    upd = coef[..., None] * up_slot[:, None, :]  # [G, S, nbf]
    lam = lr_bi * wd_bi
    if reg_bi in (0, 1, 4, 5):
        # per-pair touch counters ride the payload next to the update
        pair_touch = (jnp.abs(i_val) > 0)[..., None] & (
            jnp.abs(up_slot) > 0
        )[:, None, :]
        pay = jnp.concatenate(
            [upd, pair_touch.astype(jnp.float32)], axis=-1
        ).reshape(G * S, 2 * nbf)
    elif reg_bi in (2, 3):
        occ = (jnp.abs(i_val) > 0).astype(jnp.float32)  # [G, S]
        pay = jnp.concatenate([upd, occ[..., None]], axis=-1).reshape(
            G * S, nbf + 1
        )
    else:
        raise ValueError(f"unknown bi feedback decay method {reg_bi}")
    order, si, acc, first, last = sorted_dedup(lid.reshape(-1), pay)
    old = gather_rows(W_bi_pad, si)  # [E, nbf]
    new = old + acc[:, :nbf]
    if reg_bi == 0:
        new = new * jnp.power(1.0 - lam, acc[:, nbf:])
    elif reg_bi in (1, 4, 5):
        new = _soft_threshold(new, lam * acc[:, nbf:])
    elif reg_bi == 2:
        new = new * jnp.power(1.0 - lam, acc[:, nbf])[:, None]
    else:  # reg_bi == 3
        new = _soft_threshold(new, (lam * acc[:, nbf])[:, None])
    is_real = last & (si != num_item)
    tgt = jnp.where(is_real, si, num_item)
    new = jnp.where(is_real[:, None], new, 0.0)
    return write_rows_unique(W_bi_pad, tgt, new)


@partial(
    jax.jit,
    static_argnames=("hp", "reg_bi", "rows_per_user"),
    donate_argnames=("state", "W_bi"),
)
def train_epoch_bi_big(
    state: TrainState,
    W_bi,
    stacked,
    chunk_id,
    fb,
    fb_overlap,
    up,
    lr,
    consts: TrainConsts,
    hp: HyperParams,
    scale_lr_ufeedback=1.0,
    wd_ufeedback=0.0,
    wd_ufeedback_bias=0.0,
    slr_bi=1.0,
    wd_bi=0.0,
    reg_bi: int = 0,
    off_item: int = 0,
    rows_per_user: int = 1,
):
    """train_epoch_bi on the augmented big-table layout: the chunk-carried
    SVD++ recurrence of ops/svdpp_big.train_epoch_plus_big plus the
    bilinear plugin bias and the dedup-write W_bi step.  ``state`` must be
    augmented (big_embed.augment_state) with ``hp.big_table`` set; W_bi
    itself also takes the touched-rows-only path (_bi_step_big), so both
    the unified table and the item-property matrix scale past
    ONEHOT_THRESHOLD (the reference imposes no size limit,
    apex_svd_bilinear.h:28-212)."""
    import dataclasses

    from .big_embed import (
        _forward_entries,
        apply_entries,
        gather_rows,
    )
    from .svdpp_big import _fb_writeback_big

    assert hp.big_table
    T, GS = stacked["label"].shape
    M = rows_per_user
    G = GS // M
    k = hp.num_factor
    lr_fb = lr * scale_lr_ufeedback
    d = 1.0 - lr_fb * wd_ufeedback
    db = 1.0 - lr_fb * wd_ufeedback_bias
    lr_bi = lr * slr_bi
    num_item = W_bi.shape[0]
    with_bias = not hp.no_user_bias
    W_bi_pad = jnp.concatenate([W_bi, jnp.zeros((1, W_bi.shape[1]))], axis=0)
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), chunk_id[1:] != chunk_id[:-1]]
    )

    def flush(st, cid, dacc, dbacc):
        cfb = jax.tree.map(lambda a: a[cid], fb)
        w = _fb_writeback_big(
            st.w, cfb, dacc, dbacc if with_bias else None, with_bias, k,
        )
        return dataclasses.replace(st, w=w)

    def body(carry, xs):
        st, Wb, pc, O, fb_sum, fb_bias, norm, inv, dacc, dbacc = carry
        batch, cid, first = xs

        def on_boundary(op):
            st, pc, dacc, dbacc = op
            st = flush(st, pc, dacc, dbacc)
            cfb = jax.tree.map(lambda a: a[cid], fb)
            s, nrm, sb = _fb_aggregates(
                st.w[:, :k], st.w[:, k], cfb, G + 1, with_bias
            )
            nrm = nrm[:G]
            inv = jnp.where(nrm > 0, 1.0 / jnp.maximum(nrm, 1e-30), 0.0)
            return (
                st, fb_overlap[cid], s[:G], sb[:G], nrm, inv,
                jnp.zeros_like(dacc), jnp.zeros_like(dbacc),
            )

        def off_boundary(op):
            st, pc, dacc, dbacc = op
            return st, O, fb_sum, fb_bias, norm, inv, dacc, dbacc

        st, O, fb_sum, fb_bias, norm, inv, dacc, dbacc = jax.lax.cond(
            first, on_boundary, off_boundary, (st, pc, dacc, dbacc)
        )
        up_slot = up[cid][:G]  # [G, nbf]
        up_rep = jnp.repeat(up_slot, M, axis=0) if M > 1 else up_slot
        lid, _ = _local_item_ids(batch["i_idx"], off_item, num_item)
        rows_bi = gather_rows(Wb, lid)  # [GS, S, nbf]
        per = jnp.einsum("gsn,gn->gs", rows_bi, up_rep, precision=HIGHEST)
        plug = jnp.einsum("gs,gs->g", per, batch["i_val"], precision=HIGHEST)
        fb_slot = jnp.repeat(fb_sum, M, axis=0) if M > 1 else fb_sum
        fbb_slot = (
            (jnp.repeat(fb_bias, M) if M > 1 else fb_bias)
            if with_bias
            else None
        )
        g, ref_g, ent_idx, payload, rows_u, rows_i, wu, wi, nstep, err, p_i = (
            _forward_entries(
                st, batch, lr, consts, hp,
                p_u_extra=fb_slot,
                bias_extra=fbb_slot,
                bias_plugin=plug,
            )
        )
        w = apply_entries(
            st.w, st.step, ent_idx, payload, rows_u, rows_i, wu, wi,
            lr, consts, hp,
        )
        st = TrainState(
            w=w, b=st.b, g=g, step=nstep, ref_ui=st.ref_ui, ref_g=ref_g
        )
        Wb = _bi_step_big(
            Wb, up_rep, batch, err, lr_bi, wd_bi, reg_bi, off_item,
        )
        # feedback recurrence — identical math to train_epoch_bi
        present = batch["weight"]
        m_g = present.reshape(G, M).sum(axis=1)
        errpi = (err[:, None] * p_i).reshape(G, M, k).sum(axis=1)
        err_g = err.reshape(G, M).sum(axis=1)
        if M > 1:
            frac = jnp.where(m_g > 0, (m_g - 1.0) / jnp.maximum(m_g, 1.0), 0.0)
            pip2 = jnp.sum(p_i * p_i, axis=1).reshape(G, M).sum(axis=1)
            errpi = errpi / (1.0 + lr_fb * norm * pip2 * frac)[:, None]
            err_g = err_g / (1.0 + lr_fb * norm * (m_g - 1.0) * (m_g > 0))
        dtmp = (
            fb_sum * (jnp.power(d, m_g) - 1.0)[:, None]
            + lr_fb * norm[:, None] * errpi
        )
        delta_pad = jnp.concatenate([dtmp * inv[:, None], jnp.zeros((1, k))], 0)
        dacc = dacc + delta_pad
        fb_sum = fb_sum + _mm(O, delta_pad)[:G]
        if with_bias:
            dtmp_b = (
                fb_bias * (jnp.power(db, m_g) - 1.0) + lr_fb * norm * err_g
            )
            delta_b_pad = jnp.concatenate([dtmp_b * inv, jnp.zeros((1,))])
            dbacc = dbacc + delta_b_pad
            fb_bias = fb_bias + _mm(O, delta_b_pad)[:G]
        return (st, Wb, cid, O, fb_sum, fb_bias, norm, inv, dacc, dbacc), None

    z = jnp.zeros((G, k), jnp.float32)
    zb = jnp.zeros((G,), jnp.float32)
    init = (
        state, W_bi_pad, jnp.int32(0),
        jnp.zeros((G + 1, G + 1), jnp.float32),
        z, zb, zb, zb,
        jnp.zeros((G + 1, k), jnp.float32), jnp.zeros((G + 1,), jnp.float32),
    )
    (state, W_bi_pad, last_cid, _, _, _, _, _, dacc, dbacc), _ = jax.lax.scan(
        body, init, (stacked, chunk_id, is_first)
    )
    state = flush(state, last_cid, dacc, dbacc)
    return state, W_bi_pad[:-1]


@partial(
    jax.jit,
    static_argnames=("hp", "reg_bi", "rows_per_user"),
    donate_argnames=("state", "W_bi"),
)
def train_epoch_bi_refresh(
    state: TrainState,
    W_bi,
    stacked,
    chunk_id,
    fb,
    up,
    lr,
    consts: TrainConsts,
    hp: HyperParams,
    scale_lr_ufeedback=1.0,
    wd_ufeedback=0.0,
    wd_ufeedback_bias=0.0,
    slr_bi=1.0,
    wd_bi=0.0,
    reg_bi: int = 0,
    off_item: int = 0,
    rows_per_user: int = 1,
):
    """Per-batch pool refresh fallback (common_feedback_space=1)."""
    lr_fb = lr * scale_lr_ufeedback
    d = 1.0 - lr_fb * wd_ufeedback
    db = 1.0 - lr_fb * wd_ufeedback_bias
    lr_bi = lr * slr_bi
    num_item = W_bi.shape[0]
    M = rows_per_user
    G = stacked["label"].shape[1] // M
    W_bi_pad = jnp.concatenate([W_bi, jnp.zeros((1, W_bi.shape[1]))], axis=0)

    def body(carry, xs):
        st, Wb = carry
        batch, cid = xs
        cfb = jax.tree.map(lambda a: a[cid], fb)
        up_slot = up[cid][:G]  # [G, nbf]
        up_rep = jnp.repeat(up_slot, M, axis=0) if M > 1 else up_slot
        lid, _ = _local_item_ids(batch["i_idx"], off_item, num_item)
        plug = _bi_bias(Wb, up_rep, lid, batch["i_val"])
        st, err = _plus_step(
            st, batch, cfb, lr, consts, hp, (lr_fb, d, db),
            bias_plugin=plug, return_err=True, rows_per_user=M,
        )
        Wb = _bi_step(Wb, up_rep, batch, err, lr_bi, wd_bi, reg_bi, off_item)
        return (st, Wb), None

    (state, W_bi_pad), _ = jax.lax.scan(body, (state, W_bi_pad), (stacked, chunk_id))
    return state, W_bi_pad[:-1]


@partial(jax.jit, static_argnames=("hp", "rows_per_user"))
def predict_batches_bi(
    state: TrainState, W_bi, stacked, chunk_id, fb, up, hp: HyperParams,
    off_item: int, rows_per_user: int = 1,
):
    """Forward-only predictions; tables are static so feedback aggregates
    are gathered once per CHUNK (boundary cond), like predict_batches_plus."""
    with_bias = not hp.no_user_bias
    num_item = W_bi.shape[0]
    T, GS = stacked["label"].shape
    M = rows_per_user
    G = GS // M
    k = state.w.shape[1]
    W_bi_pad = jnp.concatenate([W_bi, jnp.zeros((1, W_bi.shape[1]))], axis=0)
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), chunk_id[1:] != chunk_id[:-1]]
    )

    def body(carry, xs):
        fb_sum, fb_bias = carry
        batch, cid, first = xs

        def prepare(_):
            cfb = jax.tree.map(lambda a: a[cid], fb)
            s, _, sb = _fb_aggregates(state.w, state.b, cfb, G + 1, with_bias)
            return s[:G], sb[:G]

        fb_sum, fb_bias = jax.lax.cond(
            first, prepare, lambda _: (fb_sum, fb_bias), None
        )
        up_slot = up[cid][:G]
        up_rep = jnp.repeat(up_slot, M, axis=0) if M > 1 else up_slot
        lid, _ = _local_item_ids(batch["i_idx"], off_item, num_item)
        plug = _bi_bias(W_bi_pad, up_rep, lid, batch["i_val"])
        fb_slot = jnp.repeat(fb_sum, M, axis=0) if M > 1 else fb_sum
        fbb_slot = (
            (jnp.repeat(fb_bias, M) if M > 1 else fb_bias)
            if with_bias
            else None
        )
        pred, _, _ = forward_scores(
            state,
            batch,
            hp,
            fb_slot,
            fbb_slot,
            bias_plugin=plug,
        )
        return (fb_sum, fb_bias), pred

    init = (jnp.zeros((G, k), jnp.float32), jnp.zeros((G,), jnp.float32))
    _, preds = jax.lax.scan(body, init, (stacked, chunk_id, is_first))
    return preds
