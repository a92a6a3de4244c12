"""Large-table SVD++ epoch: the train_epoch_plus algorithm on the
augmented big-table layout (ops/big_embed.py).

Above ONEHOT_THRESHOLD the small-table SVD++ layout stops fitting the
job: its dense [N, k] per-batch updates and the chunk flush grow with
the table size.  This module keeps the exact chunk-carried algorithm of
ops/svdpp.train_epoch_plus — pack-time overlap matrices, fb_sum += O @
delta closed form, pool touched twice per chunk (train_epoch_plus's
docstring has the derivation; reference semantics prepare_ufeedback /
update_ufeedback, apex_svd_base.h:523-554) — but re-routes all
table-sized work through the big-table primitives:

  - per-batch row updates: big_embed._forward_entries (native row
    gathers + the SVD++ p_u_extra/bias_extra feedback injection) and
    big_embed.apply_entries (sort -> dedup -> unique-row write);
  - chunk-boundary aggregates: gathers from the augmented table + the
    small [F, G+1] one-hot payload matmul (G is users-per-batch, never
    table-sized);
  - chunk-exit flush: sorted-dedup accumulate of the pool deltas +
    ONE unique-row write (``_fb_writeback_big``) instead of the
    [F, N] one-hot.

Requires common_feedback_space=0 (disjoint feedback rows — the same
precondition as train_epoch_plus; the solver falls back to the
small-table layout otherwise).  Trajectory parity with
train_epoch_plus is pinned by tests/test_svdpp_big.py.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from .. import losses
from .big_embed import (
    _forward_entries,
    _soft_threshold,
    apply_entries,
    gather_rows,
    sorted_dedup,
    write_rows_unique,
)
from .embed import HIGHEST, TrainState, _mm
from .svdpp import _fb_aggregates


def _fb_writeback_big(w, cfb, delta_pad, delta_b_pad, with_bias, k):
    """Accumulate the chunk's pool deltas into the augmented table.

    w[fb_idx_f, :k] += delta[fb_block_f] * fval_f (and the bias column
    analogue) — update_ufeedback's writeback (apex_svd_base.h:539-554)
    accumulated over the chunk.  Duplicate pool rows (feedback items
    shared between the chunk's users) are merged by sorted_dedup;
    padded entries carry fval=0 and target the dummy row, which only
    ever receives zeros.
    """
    n_tbl = w.shape[0]
    dummy = n_tbl - 1
    fval = cfb["fb_val"]
    dw = delta_pad[cfb["fb_block"]] * fval[:, None]  # [F, k]
    if with_bias:
        db = delta_b_pad[cfb["fb_block"]] * fval
    else:
        db = jnp.zeros_like(fval)
    pay = jnp.concatenate([dw, db[:, None]], axis=1)  # [F, k+1]
    order, si, acc, first, last = sorted_dedup(cfb["fb_idx"], pay)
    old = gather_rows(w, si)  # [F, W]
    new_rows = old.at[:, :k].add(acc[:, :k])
    if with_bias:
        new_rows = new_rows.at[:, k].add(acc[:, k])
    is_real = last & (si != dummy)
    tgt = jnp.where(is_real, si, dummy)
    new_rows = jnp.where(is_real[:, None], new_rows, 0.0)
    return write_rows_unique(w, tgt, new_rows)


# ---- overlap representations --------------------------------------------
# fb_overlap arrives either dense ([C, G+1, G+1]) or FACTORED as
# {"diag": [C, G+1], "dup": [C, G+1, Ld]} with O = diag + dup @ dup.T
# (exact; data/batching_plus.compute_fb_overlap_factored) — the dense O
# is ~1.7 GB at the bench's G=4096 and its 16.8 MB read per batch was
# measurable, while Ld is ~1e2 at KDD scale.
def _ov_slice(fb_overlap, cid):
    if isinstance(fb_overlap, dict):
        return (fb_overlap["diag"][cid], fb_overlap["dup"][cid])
    return fb_overlap[cid]


def _ov_zero(fb_overlap, G):
    if isinstance(fb_overlap, dict):
        Ld = fb_overlap["dup"].shape[2]
        return (
            jnp.zeros((G + 1,), jnp.float32),
            jnp.zeros((G + 1, Ld), jnp.float32),
        )
    return jnp.zeros((G + 1, G + 1), jnp.float32)


def _ov_mul(O, d):
    """O @ d for either representation; d is [G+1, k] or [G+1]."""
    if isinstance(O, tuple):
        dg, Pd = O
        if d.ndim == 2:
            return dg[:, None] * d + _mm(Pd, _mm(Pd.T, d))
        return dg * d + _mm(Pd, _mm(Pd.T, d))
    return _mm(O, d)


def _forward_entries_carry(
    state, batch, uslab, lr, consts, hp, M, p_u_extra=None, bias_extra=None,
):
    """_forward_entries with the batch's user rows read from the carried
    chunk slab ``uslab`` [G, W] instead of table gathers, and only ITEM
    entries emitted for the sorted-dedup write.

    Valid when every slot's user segment is the single id of its unit
    (Su == 1, constant across the unit's rows — the classic SVD++
    shape) and reg_method < 4; the caller (train_epoch_plus_big
    carry_users=True) checks both.  Padded slots carry u_val = 0, so
    their p_u contribution vanishes without masking; their touch counts
    are masked by u_idx != dummy.

    Returns (g, ref_g, ent_idx_i, payload_i, rows_i, wi, nstep, err,
    p_i, du, dbu, cu_g) — the first block mirrors _forward_entries'
    item half; (du, dbu, cu_g) are the dense per-user [G] update
    inputs for _update_uslab.
    """
    from .embed import _gather_sum, _touch_counts, _update_global

    w, g = state.w, state.g
    n_tbl, Wd = w.shape
    k = hp.num_factor
    dummy = n_tbl - 1
    u_idx, i_idx, g_idx = batch["u_idx"], batch["i_idx"], batch["g_idx"]
    u_val, i_val = batch["u_val"], batch["i_val"]
    B, Su = u_idx.shape
    Si = i_idx.shape[1]
    assert Su == 1, "carry path requires single-id user segments"
    G = B // M
    step0 = state.step
    ref_g = state.ref_g
    f32 = jnp.float32

    # ---- lazy global catch-up (identical to _forward_entries) -----------
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

    # ---- forward: user factors from the slab, item rows gathered --------
    rows_i = gather_rows(w, i_idx)  # [B,Si,W]
    wi, bi = rows_i[..., :k], rows_i[..., k]
    wu_g = uslab[:, :k]  # [G,k] — the live user rows
    bu_g = uslab[:, k]
    uv = u_val[:, 0].reshape(G, M)  # padded slots are 0
    p_u = (uv[..., None] * wu_g[:, None, :]).reshape(B, k)
    p_i = jnp.einsum("bs,bsk->bk", i_val, wi, precision=HIGHEST)
    if p_u_extra is not None:
        p_u = p_u + p_u_extra
    score = hp.base_score + _gather_sum(g, g_idx, batch["g_val"])
    score = score + jnp.einsum("bs,bs->b", i_val, bi, precision=HIGHEST)
    if not hp.no_user_bias:
        score = score + (uv * bu_g[:, None]).reshape(B)
        if bias_extra is not None:
            score = score + bias_extra
    score = score + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
    pred = losses.map_active(score, hp.active_type)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    lr_err = lr * err

    # ---- global bias ----------------------------------------------------
    g = _update_global(g, g_idx, batch["g_val"], err, lr, hp.exact_global)
    if hp.reg_global < 4:
        if hp.reg_global == 0:
            g = g * jnp.power(1.0 - lr * consts.wd_g_row, cg)
        elif hp.reg_global == 1:
            g = _soft_threshold(g, lr * consts.wd_g_row * cg)
        else:
            raise ValueError(f"unknown global decay method {hp.reg_global}")
    g = g.at[-1].set(0.0)

    # ---- item entry stream (half of _forward_entries') ------------------
    coef_i = lr_err[:, None] * i_val
    ent_idx = i_idx.reshape(-1)
    pay_w = (coef_i[..., None] * p_u[:, None, :]).reshape(-1, k)
    pay_b = coef_i.reshape(-1)
    zero = jnp.zeros((B * Si,), f32)
    payload = jnp.concatenate(
        [pay_w, pay_b[:, None], zero[:, None], jnp.ones((B * Si, 1), f32)],
        axis=1,
    )  # [E, k+3] with cnt_u = 0 (items only)

    # ---- dense per-user updates for the slab ----------------------------
    coef_u = (lr_err * u_val[:, 0]).reshape(G, M)
    du = jnp.einsum("gm,gmk->gk", coef_u, p_i.reshape(G, M, k), precision=HIGHEST)
    dbu = jnp.zeros((G,), f32) if hp.no_user_bias else coef_u.sum(axis=1)
    cu_g = (u_idx[:, 0] != dummy).astype(f32).reshape(G, M).sum(axis=1)

    nstep = step0 + jnp.sum(batch["weight"] > 0).astype(jnp.int32)
    return g, ref_g, ent_idx, payload, rows_i, wi, nstep, err, p_i, du, dbu, cu_g


def _update_uslab(uslab, du, dbu, cu_g, lr, wd_u_g, consts, hp):
    """Per-batch user-row update on the carried chunk slab — the exact
    apply_entries math specialized to user rows (ci = 0, reg_method
    0-3): new_w = (w + dw) * reg(counts), bias analogue, nonneg clamp.
    The ref column (k+1) rides through untouched (inert outside lazy
    modes)."""
    k = hp.num_factor
    new_w = uslab[:, :k] + du
    m = hp.reg_method
    lam_u = lr * wd_u_g
    if m == 0:
        new_w = new_w * jnp.power(1.0 - lam_u, cu_g)[:, None]
    elif m == 1:
        new_w = _soft_threshold(new_w, (lam_u * cu_g)[:, None])
    elif m == 2:
        sq = jnp.sum(new_w * new_w, axis=1)
        scale = jnp.where(
            sq > wd_u_g, jnp.sqrt(wd_u_g / jnp.maximum(sq, 1e-30)), 1.0
        )
        # match apply_entries: mode-2 scaling only where the row was
        # touched this batch (untouched rows have cu=ci=0 there too, but
        # the entry stream never carries them — the slab does)
        new_w = jnp.where(
            (cu_g > 0)[:, None], new_w * scale[:, None], new_w
        )
    elif m == 3:
        new_w = _soft_threshold(new_w, (lam_u * cu_g)[:, None])
    else:
        raise ValueError(f"unknown reg_method {m}")
    if hp.user_nonnegative:
        new_w = jnp.where((cu_g > 0)[:, None], jnp.maximum(new_w, 0.0), new_w)
    new_b = uslab[:, k] + dbu
    if not hp.no_user_bias:
        new_b = new_b * jnp.power(1.0 - lr * consts.wd_user_bias, cu_g)
    out = uslab.at[:, :k].set(new_w)
    return out.at[:, k].set(new_b)


def _epoch_carry(
    state, stacked, chunk_id, fb, fb_overlap, lr, consts, hp,
    lr_fb, d, db, with_bias, is_first, flush, G, M, k,
):
    """The carry_users=True scan: user rows live in the carry as a
    [G, W] slab per chunk (see train_epoch_plus_big's docstring)."""
    n_tbl = state.w.shape[0]
    dummy = n_tbl - 1
    chunk_users = fb["chunk_users"]  # [C, G] i32, dummy where padded

    def write_uslab(w, ids, uslab):
        rows = jnp.where((ids != dummy)[:, None], uslab, 0.0)
        return write_rows_unique(w, ids, rows)

    def body(carry, xs):
        st, pc, O, fb_sum, fb_bias, norm, inv, dacc, dbacc, uslab, wdu = carry
        batch, cid, first = xs

        def on_boundary(op):
            st, pc, dacc, dbacc, uslab = op
            st = flush(st, pc, dacc, dbacc)
            # previous chunk's user rows leave the carry...
            w = write_uslab(st.w, chunk_users[pc], uslab)
            # ...and the new chunk's enter it (after the pool flush and
            # the writeback: regions are disjoint, users are chunk-unique)
            ids = chunk_users[cid]
            uslab = gather_rows(w, ids)
            uslab = jnp.where((ids != dummy)[:, None], uslab, 0.0)
            wdu = consts.wd_u_row[ids]
            st = dataclasses.replace(st, w=w)
            cfb = jax.tree.map(
                lambda a: a[cid],
                {kk: v for kk, v in fb.items() if kk != "chunk_users"},
            )
            s, nrm, sb = _fb_aggregates(
                st.w[:, :k], st.w[:, k], cfb, G + 1, with_bias
            )
            nrm = nrm[:G]
            inv = jnp.where(nrm > 0, 1.0 / jnp.maximum(nrm, 1e-30), 0.0)
            return (
                st, _ov_slice(fb_overlap, cid), s[:G], sb[:G], nrm, inv,
                jnp.zeros_like(dacc), jnp.zeros_like(dbacc), uslab, wdu,
            )

        def off_boundary(op):
            st, pc, dacc, dbacc, uslab = op
            return st, O, fb_sum, fb_bias, norm, inv, dacc, dbacc, uslab, wdu

        st, O, fb_sum, fb_bias, norm, inv, dacc, dbacc, uslab, wdu = (
            jax.lax.cond(
                first, on_boundary, off_boundary, (st, pc, dacc, dbacc, uslab)
            )
        )
        fb_slot = jnp.repeat(fb_sum, M, axis=0) if M > 1 else fb_sum
        fbb_slot = (
            (jnp.repeat(fb_bias, M) if M > 1 else fb_bias)
            if with_bias
            else None
        )
        (g, ref_g, ent_idx, payload, rows_i, wi, nstep, err, p_i, du, dbu,
         cu_g) = _forward_entries_carry(
            st, batch, uslab, lr, consts, hp, M,
            p_u_extra=fb_slot, bias_extra=fbb_slot,
        )
        Wd = st.w.shape[1]
        # static dedup layout for the item stream when the pack shipped
        # it (keys ride the stacked dict; the scan slices them per batch)
        layout = None
        if "i_order" in batch:
            layout = (batch["i_order"], batch["i_si"], batch["i_fpos"],
                      batch["i_last"])
        w = apply_entries(
            st.w, st.step, ent_idx, payload,
            jnp.zeros((0, 1, Wd), jnp.float32), rows_i,
            jnp.zeros((0, 1, k), jnp.float32), wi,
            lr, consts, hp, layout=layout,
        )
        uslab = _update_uslab(uslab, du, dbu, cu_g, lr, wdu, consts, hp)
        st = TrainState(
            w=w, b=st.b, g=g, step=nstep, ref_ui=st.ref_ui, ref_g=ref_g
        )
        # feedback recurrence — identical to the non-carry body
        m_g = batch["weight"].reshape(G, M).sum(axis=1)
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
        fb_sum = fb_sum + _ov_mul(O, delta_pad)[:G]
        if with_bias:
            dtmp_b = (
                fb_bias * (jnp.power(db, m_g) - 1.0) + lr_fb * norm * err_g
            )
            delta_b_pad = jnp.concatenate([dtmp_b * inv, jnp.zeros((1,))])
            dbacc = dbacc + delta_b_pad
            fb_bias = fb_bias + _ov_mul(O, delta_b_pad)[:G]
        return (
            st, cid, O, fb_sum, fb_bias, norm, inv, dacc, dbacc, uslab, wdu
        ), None

    z = jnp.zeros((G, k), jnp.float32)
    zb = jnp.zeros((G,), jnp.float32)
    ids0 = chunk_users[0]
    uslab0 = gather_rows(state.w, ids0)
    uslab0 = jnp.where((ids0 != dummy)[:, None], uslab0, 0.0)
    init = (
        state, jnp.int32(0), _ov_zero(fb_overlap, G),
        z, zb, zb, zb,
        jnp.zeros((G + 1, k), jnp.float32), jnp.zeros((G + 1,), jnp.float32),
        uslab0, consts.wd_u_row[ids0],
    )
    (state, last_cid, _, _, _, _, _, dacc, dbacc, uslab, _), _ = jax.lax.scan(
        body, init, (stacked, chunk_id, is_first)
    )
    state = flush(state, last_cid, dacc, dbacc)
    return dataclasses.replace(
        state, w=write_uslab(state.w, chunk_users[last_cid], uslab)
    )


@partial(
    jax.jit,
    static_argnames=("hp", "rows_per_user", "carry_users"),
    donate_argnames=("state",),
)
def train_epoch_plus_big(
    state: TrainState,
    stacked,
    chunk_id,
    fb,
    fb_overlap,
    lr: jax.Array,
    consts,
    hp,
    scale_lr_ufeedback=1.0,
    wd_ufeedback=0.0,
    wd_ufeedback_bias=0.0,
    rows_per_user: int = 1,
    carry_users: bool = False,
):
    return train_epoch_plus_big_impl(
        state, stacked, chunk_id, fb, fb_overlap, lr, consts, hp,
        scale_lr_ufeedback, wd_ufeedback, wd_ufeedback_bias,
        rows_per_user=rows_per_user, carry_users=carry_users,
    )


def train_epoch_plus_big_impl(
    state: TrainState,
    stacked,
    chunk_id,
    fb,
    fb_overlap,
    lr: jax.Array,
    consts,
    hp,
    scale_lr_ufeedback=1.0,
    wd_ufeedback=0.0,
    wd_ufeedback_bias=0.0,
    rows_per_user: int = 1,
    carry_users: bool = False,
):
    """One pass over [T, G*M] batches on the augmented table.
    (Un-jitted impl — call this from inside an outer trace, e.g. the
    multi-round pair scan; the jit wrapper above owns donation.)

    Same carried-state recurrence as ops/svdpp.train_epoch_plus (see
    its docstring for the closed-form derivation and the M-wide Jacobi
    damping); only the table-sized reads/writes differ.  ``state`` must
    be in the augmented layout (big_embed.augment_state) with
    ``hp.big_table`` set.

    carry_users=True (requires fb["chunk_users"] [C, G] and the classic
    SVD++ user layout — one constant id per unit, Su == 1,
    reg_method < 4; the solver checks all three at pack time,
    solvers/svdpp._carry_users_plan) keeps the chunk's G user rows in
    the scan carry: gathered once at chunk entry, updated densely per
    batch (_update_uslab — the apply_entries math), written back once
    at chunk exit.  This is the batched form of the reference's locality
    (the user block stays hot in cache while its rows stream,
    apex_svd_base.h:523-554): it halves the per-batch entry stream —
    sort, payload permute/cumsum, and unique-row writes all shrink by
    the user half — which is where the profile says the time goes
    (scripts/prof_svdpp_big.py).  Trajectory is bit-equal to the
    non-carry path modulo float association (tests/test_svdpp_big.py).
    """
    assert hp.big_table
    if carry_users:
        assert hp.reg_method < 4, "carry path is eager-reg only"
    T, GS = stacked["label"].shape
    M = rows_per_user
    G = GS // M
    k = hp.num_factor
    lr_fb = lr * scale_lr_ufeedback
    d = 1.0 - lr_fb * wd_ufeedback
    db = 1.0 - lr_fb * wd_ufeedback_bias
    with_bias = not hp.no_user_bias
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), chunk_id[1:] != chunk_id[:-1]]
    )

    def flush(st, cid, dacc, dbacc):
        cfb = jax.tree.map(
            lambda a: a[cid],
            {kk: v for kk, v in fb.items() if kk != "chunk_users"},
        )
        w = _fb_writeback_big(
            st.w, cfb, dacc, dbacc if with_bias else None, with_bias, k,
        )
        return dataclasses.replace(st, w=w)

    if carry_users:
        return _epoch_carry(
            state, stacked, chunk_id, fb, fb_overlap, lr, consts, hp,
            lr_fb, d, db, with_bias, is_first, flush, G, M, k,
        )

    def body(carry, xs):
        st, pc, O, fb_sum, fb_bias, norm, inv, dacc, dbacc = carry
        batch, cid, first = xs

        def on_boundary(op):
            st, pc, dacc, dbacc = op
            st = flush(st, pc, dacc, dbacc)
            cfb = jax.tree.map(lambda a: a[cid], fb)
            # table-sized gathers on the augmented views; the one-hot
            # inside is [F, G+1] — small in the table dimension
            s, nrm, sb = _fb_aggregates(
                st.w[:, :k], st.w[:, k], cfb, G + 1, with_bias
            )
            nrm = nrm[:G]
            inv = jnp.where(nrm > 0, 1.0 / jnp.maximum(nrm, 1e-30), 0.0)
            return (
                st, _ov_slice(fb_overlap, cid), s[:G], sb[:G], nrm, inv,
                jnp.zeros_like(dacc), jnp.zeros_like(dbacc),
            )

        def off_boundary(op):
            st, pc, dacc, dbacc = op
            return st, O, fb_sum, fb_bias, norm, inv, dacc, dbacc

        st, O, fb_sum, fb_bias, norm, inv, dacc, dbacc = jax.lax.cond(
            first, on_boundary, off_boundary, (st, pc, dacc, dbacc)
        )
        fb_slot = jnp.repeat(fb_sum, M, axis=0) if M > 1 else fb_sum
        fbb_slot = (
            (jnp.repeat(fb_bias, M) if M > 1 else fb_bias)
            if with_bias
            else None
        )
        g, ref_g, ent_idx, payload, rows_u, rows_i, wu, wi, nstep, err, p_i = (
            _forward_entries(
                st, batch, lr, consts, hp,
                p_u_extra=fb_slot, bias_extra=fbb_slot,
            )
        )
        w = apply_entries(
            st.w, st.step, ent_idx, payload, rows_u, rows_i, wu, wi,
            lr, consts, hp,
        )
        st = TrainState(
            w=w, b=st.b, g=g, step=nstep, ref_ui=st.ref_ui, ref_g=ref_g
        )
        # feedback recurrence — identical math to train_epoch_plus
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
        fb_sum = fb_sum + _ov_mul(O, delta_pad)[:G]
        if with_bias:
            dtmp_b = (
                fb_bias * (jnp.power(db, m_g) - 1.0) + lr_fb * norm * err_g
            )
            delta_b_pad = jnp.concatenate([dtmp_b * inv, jnp.zeros((1,))])
            dbacc = dbacc + delta_b_pad
            fb_bias = fb_bias + _ov_mul(O, delta_b_pad)[:G]
        return (st, cid, O, fb_sum, fb_bias, norm, inv, dacc, dbacc), None

    z = jnp.zeros((G, k), jnp.float32)
    zb = jnp.zeros((G,), jnp.float32)
    init = (
        state, jnp.int32(0), _ov_zero(fb_overlap, G),
        z, zb, zb, zb,
        jnp.zeros((G + 1, k), jnp.float32), jnp.zeros((G + 1,), jnp.float32),
    )
    (state, last_cid, _, _, _, _, _, dacc, dbacc), _ = jax.lax.scan(
        body, init, (stacked, chunk_id, is_first)
    )
    return flush(state, last_cid, dacc, dbacc)
