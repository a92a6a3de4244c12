"""Fused SVD++ (user-group) train epoch.

Re-design of SVDPPFeature (solvers/base-solver/apex_svd_base.h:484-592).
Reference semantics, per user block: compute the implicit-feedback factor
sum (prepare_ufeedback :523-538), train the rows sequentially while the
feedback state evolves (update_svdpp :512-520), write the accumulated
delta back scaled by 1/||feedback||^2 (update_ufeedback :539-554).

Batched formulation (layout in data/batching_plus.py): each batch holds ONE
row of each of G users; every step

  1. gathers its chunk's feedback pool and segment_sums the per-user
     aggregates  fb_sum[g] = sum_f val_f W[fb_idx_f],  norm[g],  fb_bias[g]
     from the live tables (per-batch freshness — fresher than the
     reference's per-block);
  2. runs the standard fused row update with p_u += fb_sum[g];
  3. applies the reference's per-row feedback update in closed form:
         tmp_1 - tmp_0 = fb_sum (d - 1) + lr_fb * norm * err * p_i,
         d = 1 - lr_fb * wd_ufeedback
     scattered back as  W_fb[f] += (tmp_1 - tmp_0)/norm * val_f
     (and likewise the feedback bias when user bias is enabled).

Because each user contributes one row per step, this matches the
reference's sequential per-row feedback recurrence exactly (up to
simultaneous-users summation of width G on shared rows, stable for
lr * G * overlap << 2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import losses
from .embed import (
    HIGHEST,
    HyperParams,
    TrainConsts,
    TrainState,
    forward_scores,
    _apply_factor_reg,
    _can_fuse,
    _lazy_catchup,
    _mm,
    _onehot,
    _scatter_rows,
    _scatter_vals,
    _soft_threshold,
    _touch_counts,
    _train_step_fused,
    _update_global,
    _use_onehot,
)


def _fb_aggregates(w, b, cfb, nseg: int, with_bias: bool, force_onehot=None):
    """(fb_sum [nseg,k], norm [nseg], fb_bias [nseg]) from a chunk pool.

    In the one-hot form (backend capability row, or ``force_onehot``)
    the three segment reductions are stacked into ONE [F, k+2] payload
    applied by a single one-hot matmul; otherwise three segment_sums.
    """
    fval = cfb["fb_val"]
    use_onehot = (
        _use_onehot(nseg) if force_onehot is None else force_onehot
    )
    if use_onehot:
        k = w.shape[1]
        A = _onehot(cfb["fb_block"], nseg)  # [F, nseg] bf16 (0/1 exact)
        rows = w[cfb["fb_idx"]] * fval[:, None]
        bcol = (b[cfb["fb_idx"]] * fval)[:, None] if with_bias else fval[:, None] * 0
        pay = jnp.concatenate([rows, bcol, (fval * fval)[:, None]], axis=1)
        out = jnp.einsum("fn,fc->nc", A, pay, precision=HIGHEST)
        return out[:, :k], out[:, k + 1], out[:, k]
    rows = w[cfb["fb_idx"]] * fval[:, None]
    fb_sum = jax.ops.segment_sum(rows, cfb["fb_block"], num_segments=nseg)
    norm = jax.ops.segment_sum(fval * fval, cfb["fb_block"], num_segments=nseg)
    if with_bias:
        fb_bias = jax.ops.segment_sum(
            b[cfb["fb_idx"]] * fval, cfb["fb_block"], num_segments=nseg
        )
    else:
        fb_bias = jnp.zeros((nseg,), jnp.float32)
    return fb_sum, norm, fb_bias


def _fb_writeback(w, b, cfb, delta_pad, delta_b_pad, with_bias, force_onehot=None):
    """Scatter the per-user feedback delta over the pool rows.

    w[fb_idx_f] += delta[fb_block_f] * fval_f (and the bias analogue).
    One-hot form: one [F, N] one-hot read, [dw | db] stacked; scatter
    form: an F-row ``.at[].add``.
    """
    n_ui = w.shape[0]
    fval = cfb["fb_val"]
    use_onehot = _use_onehot(n_ui) if force_onehot is None else force_onehot
    if use_onehot:
        k = w.shape[1]
        E = _onehot(cfb["fb_idx"], n_ui)  # [F, N]
        dw = delta_pad[cfb["fb_block"]] * fval[:, None]  # [F, k]
        if with_bias:
            pay = jnp.concatenate(
                [dw, (delta_b_pad[cfb["fb_block"]] * fval)[:, None]], axis=1
            )
            out = jnp.einsum("fn,fc->nc", E, pay, precision=HIGHEST)
            return w + out[:, :k], b + out[:, k]
        out = jnp.einsum("fn,fk->nk", E, dw, precision=HIGHEST)
        return w + out, b
    w = w.at[cfb["fb_idx"]].add(delta_pad[cfb["fb_block"]] * fval[:, None])
    if with_bias:
        b = b.at[cfb["fb_idx"]].add(delta_b_pad[cfb["fb_block"]] * fval)
    return w, b


def _plus_step(
    state, batch, cfb, lr, consts, hp, fb_hyper,
    bias_plugin=None, return_err=False, rows_per_user: int = 1,
):
    """One batch (M rows per user) with fresh feedback + direct writeback."""
    lr_fb, d, db = fb_hyper
    w, b, g = state.w, state.b, state.g
    n_ui, n_g = w.shape[0], g.shape[0]
    u_idx, i_idx, g_idx = batch["u_idx"], batch["i_idx"], batch["g_idx"]
    with_bias = not hp.no_user_bias
    M = rows_per_user
    GS = batch["label"].shape[0]
    G = GS // M
    k = w.shape[1]
    nseg = G + 1

    fb_sum, norm, fb_bias = _fb_aggregates(w, b, cfb, nseg, with_bias)

    cu = _touch_counts(n_ui, u_idx)
    ci = _touch_counts(n_ui, i_idx)
    cg = _touch_counts(n_g, g_idx)

    # lazy catch-up AFTER the block's aggregates (the reference computes
    # prepare_ufeedback before any of the block's regularize calls,
    # apex_svd_base.h:568-582) and before the forward
    state = _lazy_catchup(state, cu, ci, cg, lr, consts, hp)
    w, g = state.w, state.g

    # slot = g*M + m: expand per-user aggregates to slots
    p_u_extra = jnp.repeat(fb_sum[:G], M, axis=0) if M > 1 else fb_sum[:G]
    bias_extra = (
        (jnp.repeat(fb_bias[:G], M) if M > 1 else fb_bias[:G])
        if with_bias
        else None
    )
    pred, p_u, p_i = forward_scores(
        state, batch, hp, p_u_extra, bias_extra, bias_plugin
    )
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

    # feedback writeback: the reference per-row recurrence applied for the
    # user's M simultaneous rows (update_svdpp, apex_svd_base.h:512-520)
    present = batch["weight"]  # [GS]
    m_g = present.reshape(G, M).sum(axis=1)
    errpi = (err[:, None] * p_i).reshape(G, M, k).sum(axis=1)
    err_g = err.reshape(G, M).sum(axis=1)
    if M > 1:
        # implicit damping of the M-wide Jacobi step (see train_epoch_plus)
        frac = jnp.where(m_g > 0, (m_g - 1.0) / jnp.maximum(m_g, 1.0), 0.0)
        pip2 = jnp.sum(p_i * p_i, axis=1).reshape(G, M).sum(axis=1)
        errpi = errpi / (1.0 + lr_fb * norm[:G] * pip2 * frac)[:, None]
        err_g = err_g / (1.0 + lr_fb * norm[:G] * (m_g - 1.0) * (m_g > 0))
    inv_norm = jnp.where(norm[:G] > 0, 1.0 / jnp.maximum(norm[:G], 1e-30), 0.0)
    dtmp = (
        fb_sum[:G] * (jnp.power(d, m_g) - 1.0)[:, None]
        + lr_fb * norm[:G, None] * errpi
    )
    delta = dtmp * inv_norm[:, None]  # [G, k]
    delta_pad = jnp.concatenate([delta, jnp.zeros((1, k))], axis=0)
    if with_bias:
        dtmp_b = (
            fb_bias[:G] * (jnp.power(db, m_g) - 1.0) + lr_fb * norm[:G] * err_g
        )
        delta_b = dtmp_b * inv_norm
        delta_b_pad = jnp.concatenate([delta_b, jnp.zeros((1,))])
    else:
        delta_b_pad = None
    w, b = _fb_writeback(w, b, cfb, delta_pad, delta_b_pad, with_bias)

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

    if hp.user_nonnegative:
        w = jnp.where((cu > 0)[:, None], jnp.maximum(w, 0.0), w)
    if hp.item_nonnegative:
        w = jnp.where((ci > 0)[:, None], jnp.maximum(w, 0.0), w)

    w = w.at[-1].set(0.0)
    b = b.at[-1].set(0.0)
    g = g.at[-1].set(0.0)
    nstep = state.step + jnp.sum(batch["weight"] > 0).astype(jnp.int32)
    new_state = TrainState(
        w=w, b=b, g=g, step=nstep, ref_ui=state.ref_ui, ref_g=state.ref_g
    )
    if return_err:
        return new_state, err
    return new_state


def _row_update(
    state, batch, lr, consts, hp, p_u_extra, bias_extra, bias_plugin=None
):
    """One batch of per-row updates WITHOUT feedback aggregation/writeback
    (those are chunk-level in train_epoch_plus).  Returns (state, err, p_i)
    for the caller's feedback recurrence."""
    if bias_plugin is None and _can_fuse(hp, batch, state.w.shape[0]):
        return _train_step_fused(
            state, batch, lr, consts, hp, p_u_extra, bias_extra,
            return_err_pi=True,
        )
    w, b, g = state.w, state.b, state.g
    n_ui, n_g = w.shape[0], g.shape[0]
    u_idx, i_idx, g_idx = batch["u_idx"], batch["i_idx"], batch["g_idx"]
    with_bias = not hp.no_user_bias

    cu = _touch_counts(n_ui, u_idx)
    ci = _touch_counts(n_ui, i_idx)
    cg = _touch_counts(n_g, g_idx)

    state = _lazy_catchup(state, cu, ci, cg, lr, consts, hp)
    w, g = state.w, state.g
    pred, p_u, p_i = forward_scores(
        state, batch, hp, p_u_extra, bias_extra, bias_plugin
    )
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

    if hp.user_nonnegative:
        w = jnp.where((cu > 0)[:, None], jnp.maximum(w, 0.0), w)
    if hp.item_nonnegative:
        w = jnp.where((ci > 0)[:, None], jnp.maximum(w, 0.0), w)

    w = w.at[-1].set(0.0)
    b = b.at[-1].set(0.0)
    g = g.at[-1].set(0.0)
    nstep = state.step + jnp.sum(batch["weight"] > 0).astype(jnp.int32)
    new_state = TrainState(
        w=w, b=b, g=g, step=nstep, ref_ui=state.ref_ui, ref_g=state.ref_g
    )
    return new_state, err, p_i


@partial(
    jax.jit,
    static_argnames=("hp", "rows_per_user"),
    donate_argnames=("state",),
)
def train_epoch_plus(
    state: TrainState,
    stacked,
    chunk_id,
    fb,
    fb_overlap,
    lr: jax.Array,
    consts: TrainConsts,
    hp: HyperParams,
    scale_lr_ufeedback=1.0,
    wd_ufeedback=0.0,
    wd_ufeedback_bias=0.0,
    rows_per_user: int = 1,
):
    """One pass over [T, G] batches, pool work O(chunks) not O(batches).

    Trajectory-identical reformulation of the per-batch-refresh design
    (each batch re-gathers fb_sum from the live pool and writes its delta
    straight back — the configuration whose stability and golden parity
    are verified).  The re-gather is replaced by its closed form: a batch's
    writeback of per-user deltas shifts user v's re-gathered sum by
    ``sum_u O[v,u] * delta_u`` with O the pack-time overlap matrix
    (O[u,v] = sum_f val_uf*val_vf, data/batching_plus.py), so the carried
    state evolves as ``fb_sum += O @ delta`` (one [G,G]x[G,k] matmul) and
    the pool itself is touched twice per CHUNK: one aggregate gather at
    entry, one accumulated scatter at exit.

    Requires the feedback row range to be disjoint from the u/i feature
    rows (common_feedback_space=0 — the solver falls back to
    train_epoch_plus_refresh otherwise), so mid-chunk row updates never
    alias pool rows and the closed form stays exact.
    """
    import dataclasses

    T, GS = stacked["label"].shape
    M = rows_per_user
    G = GS // M  # users per batch; slot = g*M + m (data/batching_plus.py)
    k = state.w.shape[1]
    lr_fb = lr * scale_lr_ufeedback
    d = 1.0 - lr_fb * wd_ufeedback
    db = 1.0 - lr_fb * wd_ufeedback_bias
    with_bias = not hp.no_user_bias
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
        st, pc, O, fb_sum, fb_bias, norm, inv, dacc, dbacc = carry
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
        # each of a user's M rows this batch reads the same feedback state
        # (within-user Jacobi of width M; reference is the M=1 sequential
        # recurrence update_svdpp, apex_svd_base.h:512-520)
        fb_slot = jnp.repeat(fb_sum, M, axis=0) if M > 1 else fb_sum
        fbb_slot = (
            (jnp.repeat(fb_bias, M) if M > 1 else fb_bias) if with_bias else None
        )
        st, err, p_i = _row_update(st, batch, lr, consts, hp, fb_slot, fbb_slot)
        present = batch["weight"]
        m_g = present.reshape(G, M).sum(axis=1)  # rows of user g this batch
        errpi = (err[:, None] * p_i).reshape(G, M, k).sum(axis=1)
        err_g = err.reshape(G, M).sum(axis=1)
        if M > 1:
            # implicit damping of the M-wide Jacobi feedback step: the
            # sequential recurrence is self-correcting (each row's err is
            # computed after the previous row's tmp shift, and the shift
            # scales with norm — update_svdpp, apex_svd_base.h:512-520);
            # summing M rows at the raw scale diverges for heavy users
            # (lr*norm*M*|p_i|^2 > 2).  Divide by the step's own score
            # sensitivity, the scalar form of (I + lr*norm*Sum p p^T)^-1.
            # scaled by (m-1)/m: a user's first row needs no damping
            # (the sequential recurrence starts exact), so m_g=1 users
            # are bit-identical to the M=1 path
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
        return (st, cid, O, fb_sum, fb_bias, norm, inv, dacc, dbacc), None

    z = jnp.zeros((G, k), jnp.float32)
    zb = jnp.zeros((G,), jnp.float32)
    init = (
        state, jnp.int32(0), jnp.zeros((G + 1, G + 1), jnp.float32),
        z, zb, zb, zb,
        jnp.zeros((G + 1, k), jnp.float32), jnp.zeros((G + 1,), jnp.float32),
    )
    (state, last_cid, _, _, _, _, _, dacc, dbacc), _ = jax.lax.scan(
        body, init, (stacked, chunk_id, is_first)
    )
    return flush(state, last_cid, dacc, dbacc)


@partial(
    jax.jit,
    static_argnames=("hp", "rows_per_user"),
    donate_argnames=("state",),
)
def train_epoch_plus_refresh(
    state: TrainState,
    stacked,
    chunk_id,
    fb,
    lr: jax.Array,
    consts: TrainConsts,
    hp: HyperParams,
    scale_lr_ufeedback=1.0,
    wd_ufeedback=0.0,
    wd_ufeedback_bias=0.0,
    rows_per_user: int = 1,
):
    """Per-batch pool refresh fallback (common_feedback_space=1): each step
    dynamically gathers its chunk's feedback pool and writes straight back.
    Same trajectory as train_epoch_plus, O(batches) pool work."""
    lr_fb = lr * scale_lr_ufeedback
    d = 1.0 - lr_fb * wd_ufeedback
    db = 1.0 - lr_fb * wd_ufeedback_bias

    def body(st, xs):
        batch, cid = xs
        cfb = jax.tree.map(lambda a: a[cid], fb)
        st = _plus_step(
            st, batch, cfb, lr, consts, hp, (lr_fb, d, db),
            rows_per_user=rows_per_user,
        )
        return st, None

    state, _ = jax.lax.scan(body, state, (stacked, chunk_id))
    return state


@partial(jax.jit, static_argnames=("hp", "rows_per_user"))
def predict_batches_plus(
    state: TrainState, stacked, chunk_id, fb, hp: HyperParams,
    rows_per_user: int = 1,
):
    """Forward-only predictions -> [T, G*M].

    Tables are static during prediction, so the feedback aggregates are
    gathered once per CHUNK (boundary cond), not per batch."""
    with_bias = not hp.no_user_bias
    M = rows_per_user
    T, GS = stacked["label"].shape
    G = GS // M
    k = state.w.shape[1]
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
        fb_slot = jnp.repeat(fb_sum, M, axis=0) if M > 1 else fb_sum
        fbb_slot = (
            (jnp.repeat(fb_bias, M) if M > 1 else fb_bias) if with_bias else None
        )
        pred, _, _ = forward_scores(state, batch, hp, fb_slot, fbb_slot)
        return (fb_sum, fb_bias), pred

    init = (jnp.zeros((G, k), jnp.float32), jnp.zeros((G,), jnp.float32))
    _, preds = jax.lax.scan(body, init, (stacked, chunk_id, is_first))
    return preds
