"""Large-table train step: sort -> dedup -> unique-row update.

The one-hot formulation (ops/embed.py) caps out at ONEHOT_THRESHOLD
rows because the [B, N] one-hot traffic grows linearly in N.  This
module is the path for everything above the threshold: the batched
equivalent of the reference's per-example scatter update at KDD-Cup
scale (update_no_decay, solvers/base-solver/apex_svd_base.h:383-427).

Augmented row layout.  The big path stores each row as
``[factors(k) | bias | ref_bits | 0pad]``, so one row read or write
moves the factor vector, the bias and the lazy-regularization timestamp
together (the reference's separate W/bias/ref arrays,
apex_svd_base.h:92-97, fused into the row).  ``ref_bits`` is the int32
sample counter bitcast into the float column, exact at any step count.
The width is k+2 rounded up to ROW_ALIGN floats (see aug_width).

Shape of the step (all regularization modes, hierarchy segments S>=1):

  1. forward: row gathers (lazy catch-up applied to the gathered copies,
     apex_svd_base.h:188-310) -> scores -> err.
  2. entries: the batch's (row, payload) pairs — one entry per (example,
     feature-slot) occurrence in the user/item segments, payload
     [dw(k) | db | cnt_u | cnt_i].
  3. sort entries by row; merge duplicates WITHOUT scatter via cumsum +
     boundary differences (cummax first-position trick).
  4. new-row values computed in the gathered domain: catch-up (lazy) or
     eager decay with per-row multiplicity, nonnegativity clamp — the
     same math as ops/embed, restricted to touched rows.
  5. ONE unique-row write of the assembled rows (``.at[].set``):
     last-entry positions carry the final row; duplicate positions
     write zeros to the dummy row (concurrent identical writes are
     benign and keep the dummy clean).

Batched-SGD semantics are the same hogwild-equivalent contract as
ops/embed.train_step: within a batch every example reads pre-update
parameters, duplicate-row gradients sum, decay compounds per touch.
Equivalence with the general path is pinned by tests/test_big_embed.py.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from .. import losses
from .embed import HIGHEST


def _soft_threshold(w, lam):
    return jnp.sign(w) * jnp.maximum(jnp.abs(w) - lam, 0.0)


# Row alignment in floats: 8 x f32 is one 32-byte sector, the unit of a
# GPU memory transaction, so every row starts on a sector boundary and a
# row gather or write touches only its own sectors.
ROW_ALIGN = 8


def aug_width(k: int) -> int:
    """Row width: factors + bias + ref, rounded up to ROW_ALIGN floats
    (k=64: 72, about 9% over the 66 floats of data)."""
    return -(-(k + 2) // ROW_ALIGN) * ROW_ALIGN


def augment_state(state, k: int):
    """Standard TrainState -> augmented big-path layout.

    w becomes [N, W] rows ``[factors | bias | ref_bits | 0]``; b/ref_ui
    shrink to size 0 (single source of truth is the augmented table).
    """
    n = state.w.shape[0]
    W = aug_width(k)
    aug = jnp.zeros((n, W), jnp.float32)
    aug = aug.at[:n, :k].set(state.w)
    aug = aug.at[:n, k].set(state.b)
    aug = aug.at[:n, k + 1].set(
        jax.lax.bitcast_convert_type(state.ref_ui, jnp.float32)
    )
    return dataclasses.replace(
        state,
        w=aug,
        b=jnp.zeros((0,), jnp.float32),
        ref_ui=jnp.zeros((0,), jnp.int32),
    )


def deaugment_state(state, k: int, n_rows: int = 0):
    """Inverse of augment_state (used for checkpointing / prediction).

    n_rows: row count to slice back to; 0 = every row.
    """
    aug = state.w
    if n_rows:
        aug = aug[:n_rows]
    return dataclasses.replace(
        state,
        w=aug[:, :k],
        b=aug[:, k],
        ref_ui=jax.lax.bitcast_convert_type(aug[:, k + 1], jnp.int32),
    )


def sorted_dedup(ent_idx: jax.Array, payload: jax.Array, layout=None):
    """Sort entries by row id and accumulate duplicate payloads.

    Returns (order, si, acc, first, last):
      order   [E]   permutation that sorts ent_idx
      si      [E]   sorted row ids
      acc     [E,C] cumulative payload within each row's run; at ``last``
                    positions this is the row's total
      first   [E]   True at the first entry of each row run
      last    [E]   True at the last entry of each row run

    No scatter anywhere: duplicates are merged with a cumsum and
    boundary differences (the first-position lookup is a cummax).

    ``layout``: optional PRECOMPUTED (order, si, fpos, last) for
    STATIC entry schedules — packed batches repeat the same ent_idx
    every round, so the argsort and the boundary masks can be built
    once at pack time (make_dedup_layout) and only the payload cumsum
    stays per-round.  The ``first`` output is None on this branch (no
    caller consumes it).
    """
    if layout is not None:
        order, si, fpos, last = layout
        pay = payload[order]
        P = jnp.cumsum(pay, axis=0)
        Pprev = jnp.concatenate(
            [jnp.zeros((1, P.shape[1]), P.dtype), P[:-1]], axis=0
        )
        return order, si, P - Pprev[fpos], None, last
    E = ent_idx.shape[0]
    order = jnp.argsort(ent_idx)
    si = ent_idx[order]
    pay = payload[order]
    P = jnp.cumsum(pay, axis=0)
    neq = si[1:] != si[:-1]
    first = jnp.concatenate([jnp.ones((1,), bool), neq])
    last = jnp.concatenate([neq, jnp.ones((1,), bool)])
    iota = jnp.arange(E, dtype=jnp.int32)
    fpos = jax.lax.cummax(jnp.where(first, iota, -1))
    Pprev = jnp.concatenate([jnp.zeros((1, P.shape[1]), P.dtype), P[:-1]], axis=0)
    acc = P - Pprev[fpos]
    return order, si, acc, first, last


def make_dedup_layout(ent_idx):
    """Host-side layout for sorted_dedup over a STATIC entry schedule:
    (order, si, fpos, last) as numpy arrays, batched over any leading
    dims of ent_idx ([..., E])."""
    import numpy as np

    order = np.argsort(ent_idx, axis=-1, kind="stable").astype(np.int32)
    si = np.take_along_axis(ent_idx, order, axis=-1).astype(np.int32)
    neq = si[..., 1:] != si[..., :-1]
    shape1 = si.shape[:-1] + (1,)
    first = np.concatenate([np.ones(shape1, bool), neq], axis=-1)
    last = np.concatenate([neq, np.ones(shape1, bool)], axis=-1)
    iota = np.arange(si.shape[-1], dtype=np.int32)
    fpos = np.maximum.accumulate(
        np.where(first, iota, -1), axis=-1
    ).astype(np.int32)
    return order, si, fpos, last


def write_rows_unique(w, rows_idx, rows_val):
    """w[rows_idx[j]] = rows_val[j] with unique targets except the dummy
    row (which only ever receives zeros, so concurrent writes are benign).
    """
    return w.at[rows_idx].set(rows_val, mode="drop")


def gather_rows(w, idx):
    """Row gather w[idx] (the native XLA gather)."""
    return w[idx]


def _forward_entries(
    state, batch, lr, consts, hp, p_u_extra=None, bias_extra=None,
    bias_plugin=None,
):
    """Shared front half of the big-table step: lazy-global catch-up,
    forward, error, global-bias update, and the batch's (row, payload)
    entry stream.  Used by the sorted-dedup write path below and the
    big-table SVD++ epoch (ops/svdpp_big.py).

    p_u_extra/bias_extra inject the SVD++ feedback term exactly as in
    ops/embed.forward_scores (prepare_svdpp / get_bias_svdpp,
    apex_svd_base.h:429-437): the extra joins p_u BEFORE the item
    payload is formed, so item rows are updated with the full
    tmp_ufactor including feedback (update_no_decay, :408-416).

    Returns (g, ref_g, ent_idx, payload, rows_u, rows_i, wu, wi, nstep,
    err, p_i) where payload is [E, k+3] = [dw | db | cnt_u | cnt_i].
    """
    from .embed import _gather_sum, _touch_counts, _update_global

    w, g = state.w, state.g
    n_tbl, Wd = w.shape
    k = hp.num_factor
    assert 0 < k <= Wd - 2, "augmented layout requires hp.num_factor"
    dummy = n_tbl - 1
    u_idx, i_idx, g_idx = batch["u_idx"], batch["i_idx"], batch["g_idx"]
    u_val, i_val = batch["u_val"], batch["i_val"]
    B, Su = u_idx.shape
    Si = i_idx.shape[1]
    step0 = state.step
    ref_g = state.ref_g
    lazy = hp.reg_method >= 4
    f32 = jnp.float32

    # ---- lazy global catch-up BEFORE the forward (the dense path order:
    # regularize(pre) then pred, apex_svd_base.h:457) ----------------------
    n_g = g.shape[0]
    cg = _touch_counts(n_g, g_idx)
    if hp.reg_global >= 4:
        elapsed_g = (step0 - ref_g).astype(f32)
        kg = jnp.where(cg > 0, elapsed_g, 0.0)
        lam_g = lr * consts.wd_g_row
        if hp.reg_global == 4:
            g = g * jnp.power(1.0 - lam_g, kg)
        else:
            g = _soft_threshold(g, lam_g * kg)
        ref_g = jnp.where(cg > 0, step0, ref_g)

    # ---- forward: augmented-row gathers with per-entry lazy catch-up ------
    rows_u = gather_rows(w, u_idx)  # [B,Su,W]
    rows_i = gather_rows(w, i_idx)
    wu, bu = rows_u[..., :k], rows_u[..., k]
    wi, bi = rows_i[..., :k], rows_i[..., k]
    if lazy:
        ref_u = jax.lax.bitcast_convert_type(rows_u[..., k + 1], jnp.int32)
        ref_i = jax.lax.bitcast_convert_type(rows_i[..., k + 1], jnp.int32)
        el_u = (step0 - ref_u).astype(f32)
        el_i = (step0 - ref_i).astype(f32)
        lam_u = lr * consts.wd_u_row[u_idx]
        lam_i = lr * consts.wd_i_row[i_idx]
        if hp.reg_method == 4:
            wu = wu * jnp.power(1.0 - lam_u, el_u)[..., None]
            wi = wi * jnp.power(1.0 - lam_i, el_i)[..., None]
        else:
            wu = _soft_threshold(wu, (lam_u * el_u)[..., None])
            wi = _soft_threshold(wi, (lam_i * el_i)[..., None])
    p_u = jnp.einsum("bs,bsk->bk", u_val, wu, precision=HIGHEST)
    p_i = jnp.einsum("bs,bsk->bk", i_val, wi, precision=HIGHEST)
    if p_u_extra is not None:
        p_u = p_u + p_u_extra
    score = hp.base_score + _gather_sum(g, g_idx, batch["g_val"])
    score = score + jnp.einsum("bs,bs->b", i_val, bi, precision=HIGHEST)
    if bias_plugin is not None:
        # solver plugin bias (get_bias_plugin, apex_svd_base.h:436-438) —
        # outside the no_user_bias gate, like ops/embed.forward_scores
        score = score + bias_plugin
    if not hp.no_user_bias:
        score = score + jnp.einsum("bs,bs->b", u_val, bu, precision=HIGHEST)
        if bias_extra is not None:
            score = score + bias_extra
    score = score + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
    pred = losses.map_active(score, hp.active_type)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    lr_err = lr * err

    # ---- global bias (small table; one-hot/damped machinery reused) -------
    g = _update_global(g, g_idx, batch["g_val"], err, lr, hp.exact_global)
    if hp.reg_global < 4:
        if hp.reg_global == 0:
            g = g * jnp.power(1.0 - lr * consts.wd_g_row, cg)
        elif hp.reg_global == 1:
            g = _soft_threshold(g, lr * consts.wd_g_row * cg)
        else:
            raise ValueError(f"unknown global decay method {hp.reg_global}")
    g = g.at[-1].set(0.0)

    # ---- entries ----------------------------------------------------------
    coef_u = lr_err[:, None] * u_val  # [B,Su]
    coef_i = lr_err[:, None] * i_val
    ent_idx = jnp.concatenate([u_idx.reshape(-1), i_idx.reshape(-1)])
    pay_w = jnp.concatenate(
        [
            (coef_u[..., None] * p_i[:, None, :]).reshape(-1, k),
            (coef_i[..., None] * p_u[:, None, :]).reshape(-1, k),
        ]
    )
    db_u = jnp.zeros((B * Su,), f32) if hp.no_user_bias else coef_u.reshape(-1)
    pay_b = jnp.concatenate([db_u, coef_i.reshape(-1)])
    cnt_u = jnp.concatenate([jnp.ones((B * Su,), f32), jnp.zeros((B * Si,), f32)])
    cnt_i = 1.0 - cnt_u
    payload = jnp.concatenate(
        [pay_w, pay_b[:, None], cnt_u[:, None], cnt_i[:, None]], axis=1
    )  # [E, k+3]
    nstep = step0 + jnp.sum(batch["weight"] > 0).astype(jnp.int32)
    return g, ref_g, ent_idx, payload, rows_u, rows_i, wu, wi, nstep, err, p_i


def apply_entries(w, step0, ent_idx, payload, rows_u, rows_i, wu, wi, lr, consts, hp, layout=None):
    """Back half of the big-table step: sorted-dedup merge of the entry
    stream, per-touched-row regularization, ONE unique-row write.

    Shared by train_step_big and the big-table SVD++ epoch
    (ops/svdpp_big.py).  Same reference citations as the module header
    (update_no_decay apex_svd_base.h:383-427, regularize modes :188-310).
    """
    n_tbl, Wd = w.shape
    k = hp.num_factor
    dummy = n_tbl - 1
    lazy = hp.reg_method >= 4
    f32 = jnp.float32

    order, si, acc, first, last = sorted_dedup(ent_idx, payload, layout)
    dw = acc[:, :k]
    db = acc[:, k]
    cu = acc[:, k + 1]
    ci = acc[:, k + 2]

    # ---- new-row values in the gathered domain ----------------------------
    # carry the forward-gathered rows through the same permutation instead
    # of re-reading the table
    raw_rows = jnp.concatenate([rows_u.reshape(-1, Wd), rows_i.reshape(-1, Wd)])[
        order
    ]
    raw_old_w = raw_rows[:, :k]
    old_b = raw_rows[:, k]
    fwd_w = jnp.concatenate([wu.reshape(-1, k), wi.reshape(-1, k)])[order]

    wd_u = consts.wd_u_row[si]
    wd_i = consts.wd_i_row[si]
    if lazy:
        # writeback base: catch up the raw row once, with the same
        # row-level wd choice as the dense lazy path (cu>0 -> user rate)
        ref_row = jax.lax.bitcast_convert_type(raw_rows[:, k + 1], jnp.int32)
        el = (step0 - ref_row).astype(f32)
        lam = lr * jnp.where(cu > 0, wd_u, wd_i)
        if hp.reg_method == 4:
            base_w = raw_old_w * jnp.power(1.0 - lam, el)[:, None]
        else:
            base_w = _soft_threshold(raw_old_w, (lam * el)[:, None])
        new_w = base_w + dw
        new_ref = jnp.broadcast_to(step0, si.shape)
    else:
        new_w = fwd_w + dw
        m = hp.reg_method
        lam_u = lr * wd_u
        lam_i = lr * wd_i
        if m == 0:
            fac = jnp.power(1.0 - lam_u, cu) * jnp.power(1.0 - lam_i, ci)
            new_w = new_w * fac[:, None]
        elif m == 1:
            new_w = _soft_threshold(new_w, (lam_u * cu + lam_i * ci)[:, None])
        elif m == 2:
            wd_row = jnp.where(cu > 0, wd_u, wd_i)
            sq = jnp.sum(new_w * new_w, axis=1)
            scale = jnp.where(
                sq > wd_row, jnp.sqrt(wd_row / jnp.maximum(sq, 1e-30)), 1.0
            )
            new_w = new_w * scale[:, None]
        elif m == 3:
            new_w = _soft_threshold(new_w, (lam_u * cu)[:, None])
            new_w = new_w * jnp.power(1.0 - lam_i, ci)[:, None]
        else:
            raise ValueError(f"unknown reg_method {m}")
        new_ref = jnp.zeros(si.shape, jnp.int32)
    if hp.user_nonnegative:
        new_w = jnp.where((cu > 0)[:, None], jnp.maximum(new_w, 0.0), new_w)
    if hp.item_nonnegative:
        new_w = jnp.where((ci > 0)[:, None], jnp.maximum(new_w, 0.0), new_w)

    fac_b = jnp.power(1.0 - lr * consts.wd_item_bias, ci)
    if not hp.no_user_bias:
        fac_b = fac_b * jnp.power(1.0 - lr * consts.wd_user_bias, cu)
    new_b = (old_b + db) * fac_b

    # ---- assemble augmented rows + single unique-row write ----------------
    # duplicates and the padding row collapse onto the dummy row, which
    # only ever receives zeros (so concurrent writes are benign and
    # the dummy stays clean without a separate reset)
    is_real = last & (si != dummy)
    tgt = jnp.where(is_real, si, dummy)
    # lazy: stamp the touch (ref = step0); otherwise carry the stored
    # ref bits through unchanged (ref is inert outside lazy modes)
    ref_col = (
        jax.lax.bitcast_convert_type(new_ref, f32) if lazy else raw_rows[:, k + 1]
    )
    E = si.shape[0]
    out_rows = jnp.zeros((E, Wd), f32)
    out_rows = out_rows.at[:, :k].set(new_w)
    out_rows = out_rows.at[:, k].set(new_b)
    out_rows = out_rows.at[:, k + 1].set(ref_col)
    out_rows = jnp.where(is_real[:, None], out_rows, 0.0)
    return write_rows_unique(w, tgt, out_rows)


@partial(jax.jit, static_argnames=("hp",), donate_argnames=("state",))
def train_step_big(state, batch, lr, consts, hp):
    """One batched SGD step for tables above ONEHOT_THRESHOLD.

    ``state.w`` must be in the augmented layout (augment_state) with
    ``hp.num_factor`` holding k.  Semantics mirror ops/embed.train_step
    (same reference citations); the round loop can scan either step.
    """
    from .embed import TrainState

    k = hp.num_factor
    assert 0 < k <= state.w.shape[1] - 2, "augmented layout requires hp.num_factor"

    g, ref_g, ent_idx, payload, rows_u, rows_i, wu, wi, nstep, _err, _pi = (
        _forward_entries(state, batch, lr, consts, hp)
    )
    w = apply_entries(
        state.w, state.step, ent_idx, payload, rows_u, rows_i, wu, wi,
        lr, consts, hp,
    )
    return TrainState(
        w=w, b=state.b, g=g, step=nstep, ref_ui=state.ref_ui, ref_g=ref_g
    )
