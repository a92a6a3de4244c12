"""Sharded SVD++ step: dp over users, tp over table rows, SP over feedback.

Extends the base sharded step (mesh.py) to the user-group solver:

* batch rows (one per user) are sharded over ``data``;
* the unified table is row-sharded over ``model`` (masked local gathers +
  psum, all-gathered sparse updates — same recipe as mesh.py);
* the **feedback pool is the sequence axis** (SURVEY.md §5: a user's
  unbounded history is the reference's 'long context').  Each data shard
  reduces its slice of the pool (local masked gather over its model slab,
  then segment_sum) and the per-user aggregates are psum'd over BOTH axes
  — the moral equivalent of context-parallel blockwise reduction with
  carries;
* the closed-form feedback writeback is computed from the replicated
  aggregates and applied by every data replica over the full pool
  (identical updates), masked to model-owned rows.
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


def _make_svdpp_body(
    hp: HyperParams, n_pad: int, n_model: int, n_data: int, G: int, F: int,
    M: int = 1,
):
    """Per-shard M-rows-per-user SVD++ step body.

    Batch: row arrays [G*M] sharded over data (local block = this shard's
    contiguous user slots, M consecutive slots per user — a user's rows
    never straddle a data shard since G % n_data == 0); cfb pool arrays
    [F] replicated — each data shard reduces its F/n_data slice for the
    aggregates and applies the full-pool writeback identically.

    All 6 regularization modes are supported: eager 0-3 on the local
    slabs, lazy 4/5 via the sharded ref counters (the base mesh already
    shards them; catch-up runs AFTER the block aggregates, the reference
    order — prepare_ufeedback precedes the block's regularize calls,
    apex_svd_base.h:568-582).  M>1 uses the same implicitly-damped
    M-wide Jacobi feedback step as ops/svdpp._plus_step.
    """
    n_local = n_pad // n_model
    assert G % n_data == 0, "users_per_batch padded to a multiple of data axis"
    assert F % n_data == 0, "feedback pool padded to a multiple of the data axis"
    g_local = G // n_data
    f_local = F // n_data

    def step(state: TrainState, batch, cfb, lr, fb_hyper, consts: TrainConsts):
        lr_fb, d, db = fb_hyper
        w, b = state.w, state.b  # local slabs [n_local, k], [n_local]
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_local
        dummy = n_local - 1
        with_bias = not hp.no_user_bias
        nseg = G + 1
        # global user slot of each local row (M consecutive rows per user)
        slot = did * g_local + jnp.arange(g_local * M, dtype=jnp.int32) // M

        # ---- SP: feedback aggregates from this data-shard's pool slice,
        # gathered over the local model slab, reduced over both axes
        sl = jax.lax.dynamic_slice_in_dim(cfb["fb_idx"], did * f_local, f_local)
        sv = jax.lax.dynamic_slice_in_dim(cfb["fb_val"], did * f_local, f_local)
        sb = jax.lax.dynamic_slice_in_dim(cfb["fb_block"], did * f_local, f_local)
        loc = sl - lo
        own = (loc >= 0) & (loc < n_local)
        locc = jnp.where(own, loc, dummy)
        v = jnp.where(own, sv, 0.0)
        k = w.shape[1]
        # stacked one-hot aggregate: [rows*v | b*v | sv^2] in ONE matmul
        # (norm uses the RAW value — it is model-replicated)
        agg = _seg_sum_stacked(
            nseg,
            sb,
            jnp.concatenate(
                [w[locc] * v[:, None], (b[locc] * v)[:, None], (sv * sv)[:, None]],
                axis=1,
            ),
        )
        fb_sum = jax.lax.psum(jax.lax.psum(agg[:, :k], "model"), "data")
        norm = jax.lax.psum(agg[:, k + 1], "data")
        fb_bias = jax.lax.psum(jax.lax.psum(agg[:, k], "model"), "data")

        # ---- lazy catch-up AFTER the block aggregates (reference order),
        # before the forward; ref counters stay sharded with the rows
        step0 = state.step
        ref_ui, ref_g = state.ref_ui, state.ref_g
        cu, ci = _touch_counts_sharded(batch, lo, n_local)
        w, gbias, ref_ui, ref_g = _lazy_catchup_sharded(
            w, state.g, ref_ui, ref_g, batch, cu, ci, step0, lr, consts, hp
        )

        # ---- forward (rows sharded over data)
        p_u, p_i, bias = _sharded_forward(w, b, batch, hp, lo, n_local, dummy)
        p_u = p_u + fb_sum[slot]
        if with_bias:
            bias = bias + fb_bias[slot]
        score = hp.base_score + bias + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
        score = score + jnp.einsum("bs,bs->b", batch["g_val"], gbias[batch["g_idx"]], precision=HIGHEST)
        pred = losses.map_active(score, hp.active_type)
        err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

        # ---- all-gathered sparse updates + damped global update
        w, b = _apply_row_updates(
            w, b, batch, lr * err, p_u, p_i, hp, lo, n_local, dummy
        )
        gbias = _global_update_psum(gbias, batch, err, lr)

        # ---- feedback writeback: replicated delta over the FULL pool,
        # masked to model-owned rows.  Per-user reduction
        # [err*p_i | present | err | p_i.p_i] in one matmul; a user's M
        # rows all live on one data shard, so the psum just merges shards
        present = batch["weight"]
        red = jax.lax.psum(
            _seg_sum_stacked(
                nseg,
                slot,
                jnp.concatenate(
                    [
                        err[:, None] * p_i,
                        present[:, None],
                        err[:, None],
                        jnp.sum(p_i * p_i, axis=1, keepdims=True),
                    ],
                    axis=1,
                ),
            ),
            "data",
        )
        errpi, m_g, err_g = red[:, :k], red[:, k], red[:, k + 1]
        if M > 1:
            # implicitly-damped M-wide Jacobi feedback step — the exact
            # math of ops/svdpp._plus_step (measured stability analysis
            # in PERF.md "Multirow stability")
            pip2 = red[:, k + 2]
            frac = jnp.where(m_g > 0, (m_g - 1.0) / jnp.maximum(m_g, 1.0), 0.0)
            errpi = errpi / (1.0 + lr_fb * norm * pip2 * frac)[:, None]
            err_g = err_g / (1.0 + lr_fb * norm * (m_g - 1.0) * (m_g > 0))
        inv_norm = jnp.where(norm > 0, 1.0 / jnp.maximum(norm, 1e-30), 0.0)
        dtmp = (
            fb_sum * (jnp.power(d, m_g) - 1.0)[:, None]
            + lr_fb * norm[:, None] * errpi
        )
        delta = dtmp * inv_norm[:, None]  # [G+1, k] replicated
        floc = cfb["fb_idx"] - lo
        fown = (floc >= 0) & (floc < n_local)
        flocc = jnp.where(fown, floc, dummy)
        fval = jnp.where(fown, cfb["fb_val"], 0.0)
        if with_bias:
            dtmp_b = fb_bias * (jnp.power(db, m_g) - 1.0) + lr_fb * norm * err_g
            delta_b = dtmp_b * inv_norm
        else:
            delta_b = None
        # one-hot [F, n_local] writeback (ops/svdpp._fb_writeback: w/b
        # deltas ride one stacked matmul in the one-hot form, .at[].add
        # otherwise)
        cfb_local = {"fb_idx": flocc, "fb_block": cfb["fb_block"], "fb_val": fval}
        w, b = _fb_writeback(w, b, cfb_local, delta, delta_b, with_bias)

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
        w=P("model", None), b=P("model"), g=P(), step=P(), ref_ui=P("model"), ref_g=P()
    )
    batch_keys = ("label", "weight", "g_idx", "g_val", "u_idx", "u_val", "i_idx", "i_val")
    batch_spec = {
        k: (P("data") if k in ("label", "weight") else P("data", None))
        for k in batch_keys
    }
    cfb_spec = {"fb_idx": P(), "fb_val": P(), "fb_block": P()}
    consts_spec = TrainConsts(
        wd_u_row=P("model"), wd_i_row=P("model"), wd_g_row=P(),
        wd_user_bias=P(), wd_item_bias=P(),
    )
    return state_spec, batch_spec, cfb_spec, consts_spec


def sharded_svdpp_step(
    mesh: Mesh, hp: HyperParams, n_pad: int, G: int, F: int, M: int = 1
):
    """Per-batch jitted step: (state, batch, cfb, lr, fb_hyper, consts)."""
    from jax import shard_map

    step = _make_svdpp_body(
        hp, n_pad, mesh.shape["model"], mesh.shape["data"], G, F, M
    )
    state_spec, batch_spec, cfb_spec, consts_spec = _specs()
    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(state_spec, batch_spec, cfb_spec, P(), P(), consts_spec),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def sharded_svdpp_rounds(
    mesh: Mesh,
    hp: HyperParams,
    n_pad: int,
    G: int,
    F: int,
    scale_lr_ufeedback: float = 1.0,
    wd_ufeedback: float = 0.0,
    wd_ufeedback_bias: float = 0.0,
    M: int = 1,
):
    """Whole multi-round SVD++ run in ONE dispatch on the mesh.

    Signature: (state, stacked, chunk_id, fb, lrs, consts) -> state.
    ``stacked``: [T, G*M, ...] batches (user slots sharded over data);
    ``fb``: [C, F] replicated chunk pools; ``chunk_id``: [T].  Per-round
    lr decay is applied on device (multi-chip analogue of
    ops/svdpp.train_epoch_plus).
    """
    from jax import shard_map

    step = _make_svdpp_body(
        hp, n_pad, mesh.shape["model"], mesh.shape["data"], G, F, M
    )
    state_spec, batch_spec, cfb_spec, consts_spec = _specs()

    def run(state, stacked, chunk_id, fb, lrs, consts):
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
                return step(s, batch, cfb, lr, fbh, consts), None

            st, _ = jax.lax.scan(batch_body, st, (stacked, chunk_id))
            return st, None

        state, _ = jax.lax.scan(round_body, state, lrs)
        return state

    stacked_spec = {
        k: (P(None, "data") if k in ("label", "weight") else P(None, "data", None))
        for k in batch_spec
    }
    fb_spec = {k: P(None, None) for k in cfb_spec}
    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(state_spec, stacked_spec, P(), fb_spec, P(), consts_spec),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def pad_plus_for_mesh(
    arrays, fb, G: int, n_data: int, dummy_row: int, num_global: int,
    M: int = 1,
):
    """Pad packed plus batches so G (users) and F divide the data axis.

    ``arrays``: dict of [T, G*M, ...] host arrays (M consecutive slots
    per user); ``fb``: dict of [C, F] pools.  Padded user slots are
    absent rows (weight 0, per-segment dummy ids, value 0); pool padding
    entries carry value 0 and block slot G' (the always-empty segment).
    Returns (arrays, fb, G', F').
    """
    T = arrays["label"].shape[0]
    Gp = -(-G // n_data) * n_data
    if Gp != G:
        out = {}
        for k, v in arrays.items():
            fill = 0
            if k == "g_idx":
                fill = num_global
            elif k.endswith("_idx"):
                fill = dummy_row
            pad = np.full((T, (Gp - G) * M) + v.shape[2:], fill, v.dtype)
            out[k] = np.concatenate([v, pad], axis=1)
        arrays = out
    F = fb["fb_idx"].shape[1]
    Fp = -(-F // n_data) * n_data
    if Fp != F:
        C = fb["fb_idx"].shape[0]
        fb = {
            "fb_idx": np.concatenate(
                [fb["fb_idx"], np.zeros((C, Fp - F), np.int32)], axis=1
            ),
            "fb_val": np.concatenate(
                [fb["fb_val"], np.zeros((C, Fp - F), np.float32)], axis=1
            ),
            "fb_block": np.concatenate(
                [fb["fb_block"], np.full((C, Fp - F), G, np.int32)], axis=1
            ),
        }
    if Gp != G:
        # remap pool padding block slot G -> Gp (always-empty segment)
        fb = dict(fb)
        fb["fb_block"] = np.where(fb["fb_block"] >= G, Gp, fb["fb_block"])
    return arrays, fb, Gp, Fp


def sharded_svdpp_predict(
    mesh: Mesh, hp: HyperParams, n_pad: int, G: int, F: int, M: int = 1
):
    """SVD++ inference ON the mesh — tables stay row-sharded.

    The forward half of ``_make_svdpp_body`` (feedback aggregates reduced
    over data+model, masked local gathers + psum) without any updates;
    predictions come back [T, G*M] sharded over ``data``.  Counterpart of
    ops/svdpp.predict_batches_plus (SVDPPFeature::predict(vector, block),
    apex_svd_base.h:583-591) for the copy-free sharded eval path.
    """
    from jax import shard_map

    n_model, n_data = mesh.shape["model"], mesh.shape["data"]
    n_local = n_pad // n_model
    assert G % n_data == 0 and F % n_data == 0
    g_local = G // n_data
    f_local = F // n_data
    state_spec, batch_spec, cfb_spec, consts_spec = _specs()

    def run(state: TrainState, stacked, chunk_id, fb):
        w, b, gbias = state.w, state.b, state.g
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_local
        dummy = n_local - 1
        with_bias = not hp.no_user_bias
        nseg = G + 1
        slot = did * g_local + jnp.arange(g_local * M, dtype=jnp.int32) // M

        def body(_, xs):
            batch, cid = xs
            cfb = jax.tree.map(lambda a: a[cid], fb)
            sl = jax.lax.dynamic_slice_in_dim(cfb["fb_idx"], did * f_local, f_local)
            sv = jax.lax.dynamic_slice_in_dim(cfb["fb_val"], did * f_local, f_local)
            sb = jax.lax.dynamic_slice_in_dim(cfb["fb_block"], did * f_local, f_local)
            loc = sl - lo
            own = (loc >= 0) & (loc < n_local)
            locc = jnp.where(own, loc, dummy)
            v = jnp.where(own, sv, 0.0)
            k = w.shape[1]
            agg = _seg_sum_stacked(
                nseg,
                sb,
                jnp.concatenate(
                    [w[locc] * v[:, None], (b[locc] * v)[:, None]], axis=1
                ),
            )
            agg = jax.lax.psum(jax.lax.psum(agg, "model"), "data")
            p_u, p_i, bias = _sharded_forward(w, b, batch, hp, lo, n_local, dummy)
            p_u = p_u + agg[:, :k][slot]
            if with_bias:
                bias = bias + agg[:, k][slot]
            score = hp.base_score + bias + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
            score = score + jnp.einsum(
                "bs,bs->b", batch["g_val"], gbias[batch["g_idx"]], precision=HIGHEST)
            return None, losses.map_active(score, hp.active_type)

        _, preds = jax.lax.scan(body, None, (stacked, chunk_id))
        return preds

    stacked_spec = {
        k: (P(None, "data") if k in ("label", "weight") else P(None, "data", None))
        for k in batch_spec
    }
    fb_spec = {k: P(None, None) for k in cfb_spec}
    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(state_spec, stacked_spec, P(), fb_spec),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    return jax.jit(fn)
