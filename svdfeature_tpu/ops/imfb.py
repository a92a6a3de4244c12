"""Multi-IMFB train epoch (extend_type=2): stacked local implicit feedback.

Port of SVDPPMultiIMFB (solvers/multi-imfb/apex_multi_imfb.h:31-194):
a row's feedback term is the SUM of its block's active contexts' feedback
sums (prepare_svdpp :66-75); per row every non-disabled active context's
tmp accumulates lr_fb * err * norm_ctx * p_i and decays by d
(update_svdpp :83-94); each context's delta is written back /norm when it
pops (update_ufeedback :134-148).  Batched like the SVD++ step: one row
per block per batch, fresh per-batch context aggregates, incremental
writeback (the sum of per-row deltas equals the pop-time delta).
``disable_level`` masks contexts by stack depth (:54-63).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .. import losses
from .embed import (
    HyperParams,
    TrainConsts,
    TrainState,
    forward_scores,
    _apply_factor_reg,
    _lazy_catchup,
    _mm,
    _scatter_rows,
    _scatter_vals,
    _soft_threshold,
    _touch_counts,
    _update_global,
)


def _ctx_aggregates(w, b, cfb, nseg: int, with_bias: bool):
    rows = w[cfb["fb_idx"]] * cfb["fb_val"][:, None]
    fb_sum = jax.ops.segment_sum(rows, cfb["fb_ctx"], num_segments=nseg)
    norm = jax.ops.segment_sum(
        cfb["fb_val"] * cfb["fb_val"], cfb["fb_ctx"], num_segments=nseg
    )
    if with_bias:
        fb_bias = jax.ops.segment_sum(
            b[cfb["fb_idx"]] * cfb["fb_val"], cfb["fb_ctx"], num_segments=nseg
        )
    else:
        fb_bias = jnp.zeros((nseg,), jnp.float32)
    return fb_sum, norm, fb_bias


def _damp_widened(S, S_b, present, flat_ctx, nrow, norm, p_i, lr_fb,
                  rows_per_user: int, D: int, nseg: int, with_bias: bool):
    """Implicitly-damped widened Jacobi step for rows_per_user (RM) > 1 —
    the per-CONTEXT form of ops/svdpp._plus_step's per-user damping.
    Only the WITHIN-unit excess is damped: U = distinct units feeding the
    context this batch (sum of present/m_unit), so excess = nrow - U is 0
    whenever every unit contributes one row — cross-unit sharing already
    sums undamped at RM=1 (golden-validated), and the RM>1 path
    degenerates bit-identically on single-row units."""
    RM = rows_per_user
    m_unit = present.reshape(present.shape[0] // RM, RM).sum(axis=1)
    ind = (
        jnp.repeat(
            jnp.where(m_unit > 0, 1.0 / jnp.maximum(m_unit, 1.0), 0.0), RM
        )
        * present
    )
    U = jnp.zeros((nseg,)).at[flat_ctx].add(jnp.repeat(ind, D))
    pip2 = jnp.zeros((nseg,)).at[flat_ctx].add(
        jnp.repeat(jnp.sum(p_i * p_i, axis=1), D)
    )
    excess = jnp.maximum(nrow - U, 0.0)
    frac = jnp.where(nrow > 0, excess / jnp.maximum(nrow, 1.0), 0.0)
    S = S / (1.0 + lr_fb * norm * pip2 * frac)[:, None]
    if with_bias:
        S_b = S_b / (1.0 + lr_fb * norm * excess)
    return S, S_b



def _imfb_step(state, batch, cfb, enabled, lr, consts, hp, fb_hyper,
               rows_per_user: int = 1):
    lr_fb, d, db = fb_hyper
    w, b, g = state.w, state.b, state.g
    n_ui, n_g = w.shape[0], g.shape[0]
    u_idx, i_idx, g_idx = batch["u_idx"], batch["i_idx"], batch["g_idx"]
    ctx = batch["ctx_slots"]  # [G, D]
    with_bias = not hp.no_user_bias
    M = enabled.shape[0] - 1  # local context count
    nseg = M + 1

    fb_sum, norm, fb_bias = _ctx_aggregates(w, b, cfb, nseg, with_bias)

    cu = _touch_counts(n_ui, u_idx)
    ci = _touch_counts(n_ui, i_idx)
    cg = _touch_counts(n_g, g_idx)

    # lazy catch-up AFTER the block's aggregates (the reference computes
    # prepare_ufeedback before any regularize call, apex_svd_base.h:568-582)
    # and before the forward — same order as ops/svdpp._plus_step
    state = _lazy_catchup(state, cu, ci, cg, lr, consts, hp)
    w, g = state.w, state.g

    p_u_extra = fb_sum[ctx].sum(axis=1)  # [G, k]
    bias_extra = fb_bias[ctx].sum(axis=1) if with_bias else None
    pred, p_u, p_i = forward_scores(state, batch, hp, p_u_extra, bias_extra)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    lr_err = lr * err

    g = _update_global(g, g_idx, batch["g_val"], err, lr, hp.exact_global)
    coef_u = lr_err[:, None] * batch["u_val"]
    coef_i = lr_err[:, None] * batch["i_val"]
    w = _scatter_rows(w, u_idx, coef_u, p_i)
    w = _scatter_rows(w, i_idx, coef_i, p_u)
    b = _scatter_vals(b, i_idx, coef_i)
    if with_bias:
        b = _scatter_vals(b, u_idx, coef_u)

    # per-context accumulation over this batch's rows
    G, D = ctx.shape
    k = w.shape[1]
    flat_ctx = ctx.reshape(-1)
    S = jnp.zeros((nseg, k)).at[flat_ctx].add(
        jnp.repeat(err[:, None] * p_i, D, axis=0).reshape(G * D, k)
    )
    nrow = jnp.zeros((nseg,)).at[flat_ctx].add(
        jnp.repeat(batch["weight"], D)
    )
    gate = enabled * jnp.where(norm > 0, 1.0, 0.0)
    inv_norm = jnp.where(norm > 0, 1.0 / jnp.maximum(norm, 1e-30), 0.0)
    S_b = (
        jnp.zeros((nseg,)).at[flat_ctx].add(jnp.repeat(err, D))
        if with_bias
        else None
    )
    if rows_per_user > 1:
        S, S_b = _damp_widened(
            S, S_b, batch["weight"], flat_ctx, nrow, norm, p_i, lr_fb,
            rows_per_user, D, nseg, with_bias,
        )
    dtmp = fb_sum * (jnp.power(d, nrow) - 1.0)[:, None] + lr_fb * norm[:, None] * S
    delta = dtmp * (inv_norm * gate)[:, None]
    w = w.at[cfb["fb_idx"]].add(delta[cfb["fb_ctx"]] * cfb["fb_val"][:, None])
    if with_bias:
        dtmp_b = fb_bias * (jnp.power(db, nrow) - 1.0) + lr_fb * norm * S_b
        delta_b = dtmp_b * inv_norm * gate
        b = b.at[cfb["fb_idx"]].add(delta_b[cfb["fb_ctx"]] * cfb["fb_val"])

    if hp.reg_method < 4:
        w = _apply_factor_reg(w, cu, ci, lr, consts, hp)
    if hp.reg_global < 4:
        if hp.reg_global == 0:
            g = g * jnp.power(1.0 - lr * consts.wd_g_row, cg)
        elif hp.reg_global == 1:
            g = _soft_threshold(g, lr * consts.wd_g_row * cg)
        else:
            raise ValueError(f"unknown global decay method {hp.reg_global}")
    fac_b = jnp.power(1.0 - lr * consts.wd_item_bias, ci)
    if with_bias:
        fac_b = fac_b * jnp.power(1.0 - lr * consts.wd_user_bias, cu)
    b = b * fac_b

    w = w.at[-1].set(0.0)
    b = b.at[-1].set(0.0)
    g = g.at[-1].set(0.0)
    nstep = state.step + jnp.sum(batch["weight"] > 0).astype(jnp.int32)
    return TrainState(
        w=w, b=b, g=g, step=nstep, ref_ui=state.ref_ui, ref_g=state.ref_g
    )


@partial(
    jax.jit, static_argnames=("hp", "rows_per_user"), donate_argnames=("state",)
)
def train_epoch_imfb(
    state: TrainState,
    stacked,
    chunk_id,
    fb,
    disable_mask,  # [C, M+1] 1.0 = enabled
    lr,
    consts: TrainConsts,
    hp: HyperParams,
    scale_lr_ufeedback=1.0,
    wd_ufeedback=0.0,
    wd_ufeedback_bias=0.0,
    rows_per_user: int = 1,
):
    lr_fb = lr * scale_lr_ufeedback
    d = 1.0 - lr_fb * wd_ufeedback
    db = 1.0 - lr_fb * wd_ufeedback_bias

    def body(st, xs):
        batch, cid = xs
        cfb = jax.tree.map(lambda a: a[cid], fb)
        st = _imfb_step(
            st, batch, cfb, disable_mask[cid], lr, consts, hp, (lr_fb, d, db),
            rows_per_user=rows_per_user,
        )
        return st, None

    state, _ = jax.lax.scan(body, state, (stacked, chunk_id))
    return state


@partial(
    jax.jit, static_argnames=("hp", "rows_per_user"), donate_argnames=("state",)
)
def train_epoch_imfb_carried(
    state: TrainState,
    stacked,
    chunk_id,
    fb,
    fb_overlap,
    disable_mask,  # [C, M+1] 1.0 = enabled
    lr,
    consts: TrainConsts,
    hp: HyperParams,
    scale_lr_ufeedback=1.0,
    wd_ufeedback=0.0,
    wd_ufeedback_bias=0.0,
    rows_per_user: int = 1,
):
    """train_epoch_imfb with pool work O(chunks), not O(batches).

    The exact train_epoch_plus reformulation applied to the stacked-
    context case: segments are the chunk's LOCAL CONTEXTS (fb_ctx slots)
    instead of user blocks, so the pack-time overlap matrix is O[c,c'] =
    sum_f val_cf * val_c'f over shared pool ids (compute_fb_overlap keyed
    by fb_ctx), the carried per-context aggregates evolve as
    ``fb_sum += O @ delta`` and the pool itself is touched twice per
    chunk — one aggregate gather at entry, one accumulated scatter at
    exit — replacing the per-batch O(F*k) refresh (_imfb_step).

    Requires a disjoint feedback row range (common_feedback_space=0 —
    the solver keeps the refresh epoch otherwise), so mid-chunk u/i row
    updates never alias pool rows and the closed form stays exact.
    Trajectory-identical to train_epoch_imfb by linearity of the
    writeback (pinned by tests/test_side_solvers.py)."""
    import dataclasses

    from .svdpp import _row_update

    T, G = stacked["label"].shape
    k = state.w.shape[1]
    nseg = disable_mask.shape[1]  # M + 1 (last = pad slot, always masked)
    lr_fb = lr * scale_lr_ufeedback
    d = 1.0 - lr_fb * wd_ufeedback
    db = 1.0 - lr_fb * wd_ufeedback_bias
    with_bias = not hp.no_user_bias
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), chunk_id[1:] != chunk_id[:-1]]
    )

    def flush(st, cid, dacc, dbacc):
        cfb = jax.tree.map(lambda a: a[cid], fb)
        from .svdpp import _fb_writeback

        w, b = _fb_writeback(
            st.w, st.b,
            {"fb_idx": cfb["fb_idx"], "fb_val": cfb["fb_val"],
             "fb_block": cfb["fb_ctx"]},
            dacc, dbacc if with_bias else None, with_bias,
        )
        return dataclasses.replace(st, w=w, b=b)

    def body(carry, xs):
        st, pc, O, fb_sum, fb_bias, norm, inv, dacc, dbacc = carry
        batch, cid, first = xs

        def on_boundary(op):
            st, pc, dacc, dbacc = op
            st = flush(st, pc, dacc, dbacc)
            cfb = jax.tree.map(lambda a: a[cid], fb)
            s, nrm, sb = _ctx_aggregates(st.w, st.b, cfb, nseg, with_bias)
            inv = jnp.where(nrm > 0, 1.0 / jnp.maximum(nrm, 1e-30), 0.0)
            return (
                st, fb_overlap[cid], s, sb, nrm, inv,
                jnp.zeros_like(dacc), jnp.zeros_like(dbacc),
            )

        def off_boundary(op):
            st, pc, dacc, dbacc = op
            return st, O, fb_sum, fb_bias, norm, inv, dacc, dbacc

        st, O, fb_sum, fb_bias, norm, inv, dacc, dbacc = jax.lax.cond(
            first, on_boundary, off_boundary, (st, pc, dacc, dbacc)
        )
        ctx = batch["ctx_slots"]  # [G, D]
        p_u_extra = fb_sum[ctx].sum(axis=1)
        bias_extra = fb_bias[ctx].sum(axis=1) if with_bias else None
        st, err, p_i = _row_update(
            st, batch, lr, consts, hp, p_u_extra, bias_extra
        )
        # per-context accumulation — identical math to _imfb_step
        G_, D = ctx.shape
        flat_ctx = ctx.reshape(-1)
        S = jnp.zeros((nseg, k)).at[flat_ctx].add(
            jnp.repeat(err[:, None] * p_i, D, axis=0).reshape(G_ * D, k)
        )
        nrow = jnp.zeros((nseg,)).at[flat_ctx].add(
            jnp.repeat(batch["weight"], D)
        )
        gate = disable_mask[cid] * jnp.where(norm > 0, 1.0, 0.0)
        S_b = (
            jnp.zeros((nseg,)).at[flat_ctx].add(jnp.repeat(err, D))
            if with_bias
            else None
        )
        if rows_per_user > 1:
            S, S_b = _damp_widened(
                S, S_b, batch["weight"], flat_ctx, nrow, norm, p_i,
                lr_fb, rows_per_user, D, nseg, with_bias,
            )
        dtmp = (
            fb_sum * (jnp.power(d, nrow) - 1.0)[:, None]
            + lr_fb * norm[:, None] * S
        )
        delta = dtmp * (inv * gate)[:, None]
        dacc = dacc + delta
        fb_sum = fb_sum + _mm(O, delta)
        if with_bias:
            dtmp_b = fb_bias * (jnp.power(db, nrow) - 1.0) + lr_fb * norm * S_b
            delta_b = dtmp_b * inv * gate
            dbacc = dbacc + delta_b
            fb_bias = fb_bias + _mm(O, delta_b)
        return (st, cid, O, fb_sum, fb_bias, norm, inv, dacc, dbacc), None

    z = jnp.zeros((nseg, k), jnp.float32)
    zb = jnp.zeros((nseg,), jnp.float32)
    init = (
        state, jnp.int32(0), jnp.zeros((nseg, nseg), jnp.float32),
        z, zb, zb, zb, z, zb,
    )
    (state, last_cid, _, _, _, _, _, dacc, dbacc), _ = jax.lax.scan(
        body, init, (stacked, chunk_id, is_first)
    )
    return flush(state, last_cid, dacc, dbacc)


def _imfb_step_big(state, batch, cfb, enabled, lr, consts, hp, fb_hyper,
                   rows_per_user: int = 1):
    """_imfb_step on the augmented big-table layout: row updates through
    big_embed._forward_entries/apply_entries (touched-rows-only reg, one
    dedup write) and the per-batch context writeback through
    svdpp_big._fb_writeback_big keyed by fb_ctx — no table-sized scatter
    or whole-table decay anywhere.  Same per-batch refresh formulation
    (and therefore the same trajectory) as the small step."""
    import dataclasses

    from .big_embed import _forward_entries, apply_entries
    from .svdpp_big import _fb_writeback_big

    lr_fb, d, db = fb_hyper
    k = hp.num_factor
    with_bias = not hp.no_user_bias
    ctx = batch["ctx_slots"]  # [G, D]
    nseg = enabled.shape[0]

    w = state.w
    fb_sum, norm, fb_bias = _ctx_aggregates(
        w[:, :k], w[:, k], cfb, nseg, with_bias
    )
    p_u_extra = fb_sum[ctx].sum(axis=1)  # [G, k]
    bias_extra = fb_bias[ctx].sum(axis=1) if with_bias else None
    g, ref_g, ent_idx, payload, rows_u, rows_i, wu, wi, nstep, err, p_i = (
        _forward_entries(
            state, batch, lr, consts, hp,
            p_u_extra=p_u_extra, bias_extra=bias_extra,
        )
    )
    w = apply_entries(
        state.w, state.step, ent_idx, payload, rows_u, rows_i, wu, wi,
        lr, consts, hp,
    )
    st = TrainState(
        w=w, b=state.b, g=g, step=nstep, ref_ui=state.ref_ui, ref_g=ref_g
    )

    # per-context deltas — identical math to _imfb_step
    G, D = ctx.shape
    flat_ctx = ctx.reshape(-1)
    S = jnp.zeros((nseg, k)).at[flat_ctx].add(
        jnp.repeat(err[:, None] * p_i, D, axis=0).reshape(G * D, k)
    )
    nrow = jnp.zeros((nseg,)).at[flat_ctx].add(jnp.repeat(batch["weight"], D))
    gate = enabled * jnp.where(norm > 0, 1.0, 0.0)
    inv_norm = jnp.where(norm > 0, 1.0 / jnp.maximum(norm, 1e-30), 0.0)
    S_b = (
        jnp.zeros((nseg,)).at[flat_ctx].add(jnp.repeat(err, D))
        if with_bias
        else None
    )
    if rows_per_user > 1:
        S, S_b = _damp_widened(
            S, S_b, batch["weight"], flat_ctx, nrow, norm, p_i, lr_fb,
            rows_per_user, D, nseg, with_bias,
        )
    dtmp = fb_sum * (jnp.power(d, nrow) - 1.0)[:, None] + lr_fb * norm[:, None] * S
    delta = dtmp * (inv_norm * gate)[:, None]
    if with_bias:
        dtmp_b = fb_bias * (jnp.power(db, nrow) - 1.0) + lr_fb * norm * S_b
        delta_b = dtmp_b * inv_norm * gate
    else:
        delta_b = None
    w = _fb_writeback_big(
        st.w,
        {
            "fb_idx": cfb["fb_idx"],
            "fb_block": cfb["fb_ctx"],
            "fb_val": cfb["fb_val"],
        },
        delta,
        delta_b,
        with_bias,
        k,
    )
    return dataclasses.replace(st, w=w)


@partial(
    jax.jit, static_argnames=("hp", "rows_per_user"), donate_argnames=("state",)
)
def train_epoch_imfb_big(
    state: TrainState,
    stacked,
    chunk_id,
    fb,
    disable_mask,  # [C, M+1] 1.0 = enabled
    lr,
    consts: TrainConsts,
    hp: HyperParams,
    scale_lr_ufeedback=1.0,
    wd_ufeedback=0.0,
    wd_ufeedback_bias=0.0,
    rows_per_user: int = 1,
):
    """train_epoch_imfb on the augmented big-table layout (``state`` from
    big_embed.augment_state, ``hp.big_table`` set).  The reference trains
    extend_type=2 at any table size (apex_multi_imfb.h:31-194); this is
    the path that keeps that true past ONEHOT_THRESHOLD."""
    assert hp.big_table
    lr_fb = lr * scale_lr_ufeedback
    d = 1.0 - lr_fb * wd_ufeedback
    db = 1.0 - lr_fb * wd_ufeedback_bias

    def body(st, xs):
        batch, cid = xs
        cfb = jax.tree.map(lambda a: a[cid], fb)
        st = _imfb_step_big(
            st, batch, cfb, disable_mask[cid], lr, consts, hp, (lr_fb, d, db),
            rows_per_user=rows_per_user,
        )
        return st, None

    state, _ = jax.lax.scan(body, state, (stacked, chunk_id))
    return state


@partial(jax.jit, static_argnames=("hp",))
def predict_batches_imfb(state: TrainState, stacked, chunk_id, fb, hp: HyperParams):
    """Forward-only predictions; tables are static so the per-context
    aggregates are gathered once per CHUNK (boundary cond)."""
    with_bias = not hp.no_user_bias
    nseg = fb["ctx_depth"].shape[1] + 1
    k = state.w.shape[1]
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), chunk_id[1:] != chunk_id[:-1]]
    )

    def body(carry, xs):
        fb_sum, fb_bias = carry
        batch, cid, first = xs

        def prepare(_):
            cfb = jax.tree.map(lambda a: a[cid], fb)
            s, _, sb = _ctx_aggregates(state.w, state.b, cfb, nseg, with_bias)
            return s, sb

        fb_sum, fb_bias = jax.lax.cond(
            first, prepare, lambda _: (fb_sum, fb_bias), None
        )
        ctx = batch["ctx_slots"]
        pred, _, _ = forward_scores(
            state,
            batch,
            hp,
            fb_sum[ctx].sum(axis=1),
            fb_bias[ctx].sum(axis=1) if with_bias else None,
        )
        return (fb_sum, fb_bias), pred

    init = (jnp.zeros((nseg, k), jnp.float32), jnp.zeros((nseg,), jnp.float32))
    _, preds = jax.lax.scan(body, init, (stacked, chunk_id, is_first))
    return preds
