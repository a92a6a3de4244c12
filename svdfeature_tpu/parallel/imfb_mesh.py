"""Sharded multi-IMFB step: dp over rows, tp over table rows, SP over
stacked context pools.

The SVD++ sharded recipe (svdpp_mesh.py) applied to the stacked-context
solver (extend_type=2, apex_multi_imfb.h:31-194): segments are the
chunk's LOCAL CONTEXTS (fb_ctx slots) instead of user blocks, a row's
feedback term sums its ctx_slots' aggregates, and the per-batch context
writeback is replicated over the full pool masked to model-owned rows —
per-batch refresh semantics, trajectory-identical to the small-table
refresh/carried epochs (ops/imfb.py; pinned by tests/test_side_solvers.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import losses
from ..ops.embed import HIGHEST, HyperParams, TrainConsts, TrainState
from ..ops.svdpp import _fb_writeback
from .mesh import (
    _apply_row_updates,
    _count_present,
    _decay_clamp_scrub,
    _global_update_psum,
    _lazy_catchup_sharded,
    _seg_sum_stacked,
    _sharded_forward,
    _touch_counts_sharded,
)


def _make_imfb_body(
    hp: HyperParams, n_pad: int, n_model: int, n_data: int, G: int, F: int,
    nseg: int, M: int = 1,
):
    """Per-shard stacked-context step body.

    Batch: row arrays [G] sharded over data (ctx_slots values are
    chunk-local slots, valid on every shard); cfb pool arrays [F]
    replicated — each data shard reduces its F/n_data slice for the
    per-context aggregates and applies the full-pool writeback
    identically.  ``enabled`` [nseg] gates disabled stack levels and the
    pad slot.  All 6 reg modes ride the shared mesh helpers.
    """
    n_local = n_pad // n_model
    assert G % n_data == 0, "rows padded to a multiple of the data axis"
    assert G % (n_data * M) == 0, "units must not straddle data shards"
    assert F % n_data == 0, "pool padded to a multiple of the data axis"
    f_local = F // n_data

    def step(state: TrainState, batch, cfb, enabled, lr, fb_hyper, consts):
        lr_fb, d, db = fb_hyper
        w, b = state.w, state.b  # local slabs
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_local
        dummy = n_local - 1
        with_bias = not hp.no_user_bias
        k = w.shape[1]

        # ---- SP: per-context aggregates from this shard's pool slice
        sl = jax.lax.dynamic_slice_in_dim(cfb["fb_idx"], did * f_local, f_local)
        sv = jax.lax.dynamic_slice_in_dim(cfb["fb_val"], did * f_local, f_local)
        sc = jax.lax.dynamic_slice_in_dim(cfb["fb_ctx"], did * f_local, f_local)
        loc = sl - lo
        own = (loc >= 0) & (loc < n_local)
        locc = jnp.where(own, loc, dummy)
        v = jnp.where(own, sv, 0.0)
        agg = _seg_sum_stacked(
            nseg,
            sc,
            jnp.concatenate(
                [w[locc] * v[:, None], (b[locc] * v)[:, None], (sv * sv)[:, None]],
                axis=1,
            ),
        )
        fb_sum = jax.lax.psum(jax.lax.psum(agg[:, :k], "model"), "data")
        norm = jax.lax.psum(agg[:, k + 1], "data")
        fb_bias = jax.lax.psum(jax.lax.psum(agg[:, k], "model"), "data")

        # ---- lazy catch-up AFTER the aggregates (reference order)
        step0 = state.step
        cu, ci = _touch_counts_sharded(batch, lo, n_local)
        w, gbias, ref_ui, ref_g = _lazy_catchup_sharded(
            w, state.g, state.ref_ui, state.ref_g, batch, cu, ci, step0,
            lr, consts, hp,
        )

        # ---- forward: feedback term = sum of the row's active contexts
        ctx = batch["ctx_slots"]  # [g_local, D] chunk-local slots
        p_u, p_i, bias = _sharded_forward(w, b, batch, hp, lo, n_local, dummy)
        p_u = p_u + fb_sum[ctx].sum(axis=1)
        if with_bias:
            bias = bias + fb_bias[ctx].sum(axis=1)
        score = hp.base_score + bias + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
        score = score + jnp.einsum(
            "bs,bs->b", batch["g_val"], gbias[batch["g_idx"]], precision=HIGHEST)
        pred = losses.map_active(score, hp.active_type)
        err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

        # ---- all-gathered sparse row updates + damped global update
        w, b = _apply_row_updates(
            w, b, batch, lr * err, p_u, p_i, hp, lo, n_local, dummy
        )
        gbias = _global_update_psum(gbias, batch, err, lr)

        # ---- per-context reduction [err*p_i | weight | err], psum'd
        g_local, D = ctx.shape
        flat_ctx = ctx.reshape(-1)
        present = batch["weight"]
        cols = [
            jnp.repeat(err[:, None] * p_i, D, axis=0).reshape(
                g_local * D, k
            ),
            jnp.repeat(present, D)[:, None],
            jnp.repeat(err, D)[:, None],
        ]
        if M > 1:
            # extra M>1 columns: per-row |p_i|^2 and the present/m_unit
            # unit indicator (U); omitted at M=1 so the cross-shard psum
            # payload stays [nseg, k+2]
            m_unit = present.reshape(g_local // M, M).sum(axis=1)
            ind = (
                jnp.repeat(
                    jnp.where(m_unit > 0, 1.0 / jnp.maximum(m_unit, 1.0), 0.0),
                    M,
                )
                * present
            )
            cols += [
                jnp.repeat(jnp.sum(p_i * p_i, axis=1), D)[:, None],
                jnp.repeat(ind, D)[:, None],
            ]
        red = jax.lax.psum(
            _seg_sum_stacked(
                nseg, flat_ctx, jnp.concatenate(cols, axis=1)
            ),
            "data",
        )
        S, nrow, S_b = red[:, :k], red[:, k], red[:, k + 1]
        if M > 1:
            # implicitly-damped widened Jacobi step (rows_per_user>1):
            # only the within-unit excess nrow - U is damped — see
            # ops/imfb._imfb_step for the law.  U rides the psum'd
            # reduction as the present/m_unit indicator column; the
            # factory asserts G % (n_data*M) == 0 so every unit's M
            # slots live on one data shard and the local reshape is
            # the unit grouping.
            pip2, U = red[:, k + 2], red[:, k + 3]
            excess = jnp.maximum(nrow - U, 0.0)
            frac = jnp.where(nrow > 0, excess / jnp.maximum(nrow, 1.0), 0.0)
            S = S / (1.0 + lr_fb * norm * pip2 * frac)[:, None]
            S_b = S_b / (1.0 + lr_fb * norm * excess)
        gate = enabled * jnp.where(norm > 0, 1.0, 0.0)
        inv = jnp.where(norm > 0, 1.0 / jnp.maximum(norm, 1e-30), 0.0)
        dtmp = (
            fb_sum * (jnp.power(d, nrow) - 1.0)[:, None]
            + lr_fb * norm[:, None] * S
        )
        delta = dtmp * (inv * gate)[:, None]
        if with_bias:
            dtmp_b = fb_bias * (jnp.power(db, nrow) - 1.0) + lr_fb * norm * S_b
            delta_b = dtmp_b * inv * gate
        else:
            delta_b = None
        # full-pool writeback masked to model-owned rows (identical on
        # every data replica — same recipe as svdpp_mesh)
        floc = cfb["fb_idx"] - lo
        fown = (floc >= 0) & (floc < n_local)
        flocc = jnp.where(fown, floc, dummy)
        fval = jnp.where(fown, cfb["fb_val"], 0.0)
        w, b = _fb_writeback(
            w, b,
            {"fb_idx": flocc, "fb_block": cfb["fb_ctx"], "fb_val": fval},
            delta, delta_b, with_bias,
        )

        # ---- decay / clamp / scrub (shared with the base sharded step)
        w, b, gbias = _decay_clamp_scrub(
            w, b, gbias, batch, cu, ci, lr, consts, hp, lo, n_local, n_pad
        )
        nstep = step0 + _count_present(batch)
        return TrainState(
            w=w, b=b, g=gbias, step=nstep, ref_ui=ref_ui, ref_g=ref_g
        )

    return step


def _specs():
    state_spec = TrainState(
        w=P("model", None), b=P("model"), g=P(), step=P(),
        ref_ui=P("model"), ref_g=P(),
    )
    batch_keys = (
        "label", "weight", "g_idx", "g_val", "u_idx", "u_val", "i_idx",
        "i_val", "ctx_slots",
    )
    stacked_spec = {
        k: (P(None, "data") if k in ("label", "weight") else P(None, "data", None))
        for k in batch_keys
    }
    cfb_spec = {"fb_idx": P(), "fb_val": P(), "fb_ctx": P()}
    consts_spec = TrainConsts(
        wd_u_row=P("model"), wd_i_row=P("model"), wd_g_row=P(),
        wd_user_bias=P(), wd_item_bias=P(),
    )
    return state_spec, stacked_spec, cfb_spec, consts_spec


def sharded_imfb_rounds(
    mesh: Mesh,
    hp: HyperParams,
    n_pad: int,
    G: int,
    F: int,
    nseg: int,
    scale_lr_ufeedback: float = 1.0,
    wd_ufeedback: float = 0.0,
    wd_ufeedback_bias: float = 0.0,
    M: int = 1,
):
    """Whole multi-round multi-IMFB run in ONE dispatch on the mesh.

    Signature: (state, stacked, chunk_id, fb, enabled, lrs, consts) ->
    state.  ``stacked``: [T, G, ...] batches (rows sharded over data,
    ctx_slots [T, G, D]); ``fb``: [C, F] replicated pools keyed fb_ctx;
    ``enabled``: [C, nseg] replicated disable masks; lr decay on device.
    """
    from jax import shard_map

    step = _make_imfb_body(
        hp, n_pad, mesh.shape["model"], mesh.shape["data"], G, F, nseg, M
    )
    state_spec, stacked_spec, cfb_spec, consts_spec = _specs()

    def run(state, stacked, chunk_id, fb, enabled, lrs, consts):
        def round_body(st, lr):
            lr_fb = lr * scale_lr_ufeedback
            fbh = (
                lr_fb,
                1.0 - lr_fb * wd_ufeedback,
                1.0 - lr_fb * wd_ufeedback_bias,
            )

            def batch_body(s, xs):
                batch, cid = xs
                cfb = jax.tree.map(lambda a: a[cid], fb)
                return step(s, batch, cfb, enabled[cid], lr, fbh, consts), None

            st, _ = jax.lax.scan(batch_body, st, (stacked, chunk_id))
            return st, None

        state, _ = jax.lax.scan(round_body, state, lrs)
        return state

    fb_spec = {k: P(None, None) for k in cfb_spec}
    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(
            state_spec, stacked_spec, P(), fb_spec, P(), P(), consts_spec,
        ),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def sharded_imfb_predict(
    mesh: Mesh, hp: HyperParams, n_pad: int, G: int, F: int, nseg: int
):
    """Multi-IMFB inference ON the mesh — tables stay row-sharded.
    Counterpart of ops/imfb.predict_batches_imfb."""
    from jax import shard_map

    n_model, n_data = mesh.shape["model"], mesh.shape["data"]
    n_local = n_pad // n_model
    assert G % n_data == 0 and F % n_data == 0
    f_local = F // n_data
    state_spec, stacked_spec, cfb_spec, consts_spec = _specs()

    def run(state: TrainState, stacked, chunk_id, fb):
        w, b, gbias = state.w, state.b, state.g
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_local
        dummy = n_local - 1
        with_bias = not hp.no_user_bias
        k = w.shape[1]

        def body(_, xs):
            batch, cid = xs
            cfb = jax.tree.map(lambda a: a[cid], fb)
            sl = jax.lax.dynamic_slice_in_dim(cfb["fb_idx"], did * f_local, f_local)
            sv = jax.lax.dynamic_slice_in_dim(cfb["fb_val"], did * f_local, f_local)
            sc = jax.lax.dynamic_slice_in_dim(cfb["fb_ctx"], did * f_local, f_local)
            loc = sl - lo
            own = (loc >= 0) & (loc < n_local)
            locc = jnp.where(own, loc, dummy)
            v = jnp.where(own, sv, 0.0)
            agg = _seg_sum_stacked(
                nseg,
                sc,
                jnp.concatenate(
                    [w[locc] * v[:, None], (b[locc] * v)[:, None]], axis=1
                ),
            )
            agg = jax.lax.psum(jax.lax.psum(agg, "model"), "data")
            ctx = batch["ctx_slots"]
            p_u, p_i, bias = _sharded_forward(w, b, batch, hp, lo, n_local, dummy)
            p_u = p_u + agg[:, :k][ctx].sum(axis=1)
            if with_bias:
                bias = bias + agg[:, k][ctx].sum(axis=1)
            score = hp.base_score + bias + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
            score = score + jnp.einsum(
                "bs,bs->b", batch["g_val"], gbias[batch["g_idx"]], precision=HIGHEST)
            return None, losses.map_active(score, hp.active_type)

        _, preds = jax.lax.scan(body, None, (stacked, chunk_id))
        return preds

    fb_spec = {k: P(None, None) for k in cfb_spec}
    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(state_spec, stacked_spec, P(), fb_spec),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    return jax.jit(fn)


def pad_imfb_for_mesh(arrays, fb, G: int, n_data: int, dummy_row: int,
                      num_global: int, nseg: int, M: int = 1):
    """Pad packed imfb batches so G (slots) and F (pool) divide the data
    axis.  Padded row slots are absent rows (weight 0, dummy ids,
    ctx_slots = pad slot); pool padding targets the dummy row with value
    0 and the pad context slot.  M>1 (rows_per_user): slots are padded
    to a multiple of n_data*M so no unit's M consecutive slots straddle
    a data shard (the mesh bodies' damping groups slots by unit)."""
    T = arrays["label"].shape[0]
    Gp = -(-G // (n_data * M)) * (n_data * M)
    if Gp != G:
        out = {}
        for k, v in arrays.items():
            if k == "ctx_slots":
                fill = nseg - 1  # pad slot (gated off)
            elif k == "g_idx":
                fill = num_global
            elif k.endswith("_idx"):
                fill = dummy_row
            else:
                fill = 0
            pad = np.full((T, Gp - G) + v.shape[2:], fill, v.dtype)
            out[k] = np.concatenate([v, pad], axis=1)
        arrays = out
    F = fb["fb_idx"].shape[1]
    Fp = -(-F // n_data) * n_data
    if Fp != F:
        C = fb["fb_idx"].shape[0]
        fb = {
            "fb_idx": np.concatenate(
                [fb["fb_idx"], np.full((C, Fp - F), dummy_row, np.int32)], axis=1
            ),
            "fb_val": np.concatenate(
                [fb["fb_val"], np.zeros((C, Fp - F), np.float32)], axis=1
            ),
            "fb_ctx": np.concatenate(
                [fb["fb_ctx"], np.full((C, Fp - F), nseg - 1, np.int32)], axis=1
            ),
        }
    return arrays, fb, Gp, Fp
