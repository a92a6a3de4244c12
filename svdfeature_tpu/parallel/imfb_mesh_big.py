"""Sharded multi-IMFB on BIG augmented slabs: mesh x big tables for the
stacked-context solver (extend_type=2).

parallel/imfb_mesh.py's step body applies its row updates and context
writebacks on standard slabs (one-hot form up to ONEHOT_THRESHOLD local
rows); parallel/mesh_big.py removes that limit for the base solver
and parallel/svdpp_mesh_big.py for SVD++.  This module is the stacked-
context member of the family — the per-batch-refresh imfb step of
imfb_mesh with every table-sized read/write routed through the big-table
primitives:

  * per-context aggregates: each data shard row-gathers its pool slice
    from the LOCAL augmented slab (ops/big_embed.gather_rows), segment-
    sums per CONTEXT slot (fb_ctx), psum over model + data;
  * forward: mesh_big._fwd_big with the stacked injection — a row's
    feedback term sums its ctx_slots' aggregates (prepare_svdpp stack
    walk, apex_multi_imfb.h:66-76);
  * u/i row updates: the all-gathered entry stream merged into each
    shard's slab by ops/big_embed.apply_entries (sort -> dedup ->
    unique-row DMA write), verbatim mesh_big;
  * context writeback: ops/svdpp_big._fb_writeback_big keyed fb_ctx on
    the local slab, gated by ``enabled`` (ufeedback_disable_level,
    apex_multi_imfb.h:54-63) — non-owned pool ids redirect to the
    scratch row with value 0.

Slab layout and shard/unshard are mesh_big's (augmented
``[factors | bias | ref_bits | pad]`` rows + one scratch row per
shard).  All 6 reg modes: eager 0-3 inside apply_entries, lazy 4/5 via
the ref-bit lane.  Parity with the single-device stacked epochs is
pinned by tests/test_mesh_big.py::test_imfb_mesh_big_config_path.

Reference contract: extend_type=2 trains like any other solver at any
table size (apex_multi_imfb.h:31-194 rides the uniform O(nnz*k) update
of apex_svd_base.h:456-462).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import losses
from ..ops.big_embed import apply_entries, gather_rows
from ..ops.embed import HyperParams, TrainConsts, TrainState
from ..ops.svdpp_big import _fb_writeback_big
from .mesh import _count_present, _global_update_psum, _seg_sum, _seg_sum_stacked
from .mesh_big import _fwd_big, _soft_threshold


def _make_imfb_body_big(
    hp: HyperParams, n_real: int, n_model: int, n_data: int, G: int, F: int,
    nseg: int, M: int = 1,
):
    """Per-shard stacked-context step on augmented slabs [n_real+1, W].

    Batch rows [G] sharded over data (ctx_slots values are chunk-local
    slots, valid on every shard); cfb pool arrays [F] replicated — each
    data shard reduces its F/n_data slice for the per-context aggregates
    and applies the full masked writeback identically.  ``enabled``
    [nseg] gates disabled stack levels and the pad slot.
    """
    k = hp.num_factor
    assert k > 0, "mesh big path requires hp.num_factor"
    assert G % n_data == 0, "rows padded to a multiple of the data axis"
    assert G % (n_data * M) == 0, "units must not straddle data shards"
    assert F % n_data == 0, "pool padded to a multiple of the data axis"
    f_local = F // n_data

    def step(state: TrainState, batch, cfb, enabled, lr, fb_hyper, consts):
        lr_fb, d, db = fb_hyper
        w, g = state.w, state.g  # w local augmented slab [n_real+1, W]
        step0, ref_g = state.step, state.ref_g
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_real
        scratch = n_real
        f32 = jnp.float32
        with_bias = not hp.no_user_bias

        # ---- SP: per-context aggregates from this data shard's pool
        # slice, row-gathered from the local augmented slab (stacked
        # prepare_svdpp, apex_multi_imfb.h:66-76).  Pool rows never decay
        # through wd_user/wd_item, so no catch-up here — same discipline
        # as svdpp_mesh_big.
        sl = jax.lax.dynamic_slice_in_dim(cfb["fb_idx"], did * f_local, f_local)
        sv = jax.lax.dynamic_slice_in_dim(cfb["fb_val"], did * f_local, f_local)
        sc = jax.lax.dynamic_slice_in_dim(cfb["fb_ctx"], did * f_local, f_local)
        loc = sl - lo
        own = (loc >= 0) & (loc < n_real)
        locc = jnp.where(own, loc, scratch)
        v = jnp.where(own, sv, 0.0)
        rows = gather_rows(w, locc)  # [f_local, W]
        agg = _seg_sum_stacked(
            nseg,
            sc,
            jnp.concatenate(
                [
                    rows[:, :k] * v[:, None],
                    (rows[:, k] * v)[:, None],
                    (sv * sv)[:, None],  # norm uses the RAW value
                ],
                axis=1,
            ),
        )
        fb_sum = jax.lax.psum(jax.lax.psum(agg[:, :k], "model"), "data")
        fb_bias = jax.lax.psum(jax.lax.psum(agg[:, k], "model"), "data")
        norm = jax.lax.psum(agg[:, k + 1], "data")

        # ---- lazy global catch-up (regularize(pre) order — identical to
        # mesh_big._make_step_body_big)
        cg = _seg_sum(
            g.shape[0], batch["g_idx"],
            jnp.ones(batch["g_idx"].shape, f32),
        )
        cg = jax.lax.psum(cg, "data")
        if hp.reg_global >= 4:
            elapsed_g = (step0 - ref_g).astype(f32)
            kg = jnp.where(cg > 0, elapsed_g, 0.0)
            lam_g = lr * consts.wd_g_row
            if hp.reg_global == 4:
                g = g * jnp.power(1.0 - lam_g, kg)
            else:
                g = _soft_threshold(g, lam_g * kg)
            ref_g = jnp.where(cg > 0, step0, ref_g)

        # ---- forward: feedback term = sum of the row's active contexts
        ctx = batch["ctx_slots"]  # [g_local, D] chunk-local slots
        p_u, p_i, score, (lu, uv), (li, iv) = _fwd_big(
            w, g, batch, hp, lr, consts, step0, lo, n_real, k,
            p_u_extra=fb_sum[ctx].sum(axis=1),
            bias_extra=fb_bias[ctx].sum(axis=1) if with_bias else None,
        )
        pred = losses.map_active(score, hp.active_type)
        err = losses.cal_grad(batch["label"], pred, hp.active_type)
        err = err * batch["weight"]

        # ---- replicated global-bias update + eager decay + dummy scrub
        g = _global_update_psum(g, batch, err, lr)
        if hp.reg_global < 4:
            if hp.reg_global == 0:
                g = g * jnp.power(1.0 - lr * consts.wd_g_row, cg)
            elif hp.reg_global == 1:
                g = _soft_threshold(g, lr * consts.wd_g_row * cg)
            else:
                raise ValueError(f"unknown global decay method {hp.reg_global}")
        g = g.at[-1].set(0.0)

        # ---- u/i updates: all-gathered entry stream -> sorted-dedup merge
        # (verbatim mesh_big._make_step_body_big)
        own_u = (lu < n_real).astype(f32)
        own_i = (li < n_real).astype(f32)
        lr_err = lr * err
        coef_u = lr_err[:, None] * uv
        coef_i = lr_err[:, None] * iv
        ag = lambda x: jax.lax.all_gather(x, "data")
        g_lu, g_li = ag(lu), ag(li)
        g_cu, g_ci = ag(coef_u), ag(coef_i)
        g_pu, g_pi = ag(p_u), ag(p_i)
        g_ou, g_oi = ag(own_u), ag(own_i)
        D_, B, Su = g_lu.shape
        Si = g_li.shape[2]
        Eu, Ei = D_ * B * Su, D_ * B * Si
        ent_idx = jnp.concatenate([g_lu.reshape(-1), g_li.reshape(-1)])
        dw = jnp.concatenate(
            [
                (g_cu[..., None] * g_pi[:, :, None, :]).reshape(-1, k),
                (g_ci[..., None] * g_pu[:, :, None, :]).reshape(-1, k),
            ]
        )
        db_u = (
            jnp.zeros((Eu,), f32) if hp.no_user_bias else g_cu.reshape(-1)
        )
        pay_b = jnp.concatenate([db_u, g_ci.reshape(-1)])
        cnt_u = jnp.concatenate([g_ou.reshape(-1), jnp.zeros((Ei,), f32)])
        cnt_i = jnp.concatenate([jnp.zeros((Eu,), f32), g_oi.reshape(-1)])
        payload = jnp.concatenate(
            [dw, pay_b[:, None], cnt_u[:, None], cnt_i[:, None]], axis=1
        )
        raw_u = gather_rows(w, g_lu.reshape(-1))
        raw_i = gather_rows(w, g_li.reshape(-1))
        w = apply_entries(
            w, step0, ent_idx, payload, raw_u, raw_i,
            raw_u[:, :k], raw_i[:, :k], lr, consts, hp,
        )

        # ---- per-context reduction [err*p_i | weight | err], psum'd over
        # data; the writeback is replicated over the FULL pool, masked to
        # owned rows, merged by ONE dedup write (stacked update_svdpp,
        # apex_multi_imfb.h:78-94)
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
        floc = cfb["fb_idx"] - lo
        fown = (floc >= 0) & (floc < n_real)
        cfb_local = {
            "fb_idx": jnp.where(fown, floc, scratch),
            "fb_val": jnp.where(fown, cfb["fb_val"], 0.0),
            "fb_block": cfb["fb_ctx"],
        }
        w = _fb_writeback_big(
            w, cfb_local, delta, delta_b, with_bias, k
        )

        nstep = step0 + _count_present(batch)
        return TrainState(
            w=w, b=state.b, g=g, step=nstep, ref_ui=state.ref_ui, ref_g=ref_g
        )

    return step


def _specs_big_imfb():
    state_spec = TrainState(
        w=P("model", None), b=P(), g=P(), step=P(), ref_ui=P(), ref_g=P(),
    )
    keys = (
        "label", "weight", "g_idx", "g_val", "u_idx", "u_val", "i_idx",
        "i_val", "ctx_slots",
    )
    stacked_spec = {
        k: (P(None, "data") if k in ("label", "weight") else P(None, "data", None))
        for k in keys
    }
    fb_spec = {k: P(None, None) for k in ("fb_idx", "fb_val", "fb_ctx")}
    consts_spec = TrainConsts(
        wd_u_row=P("model"), wd_i_row=P("model"), wd_g_row=P(),
        wd_user_bias=P(), wd_item_bias=P(),
    )
    return state_spec, stacked_spec, fb_spec, consts_spec


def sharded_imfb_rounds_big(
    mesh: Mesh,
    hp: HyperParams,
    n_real: int,
    G: int,
    F: int,
    nseg: int,
    scale_lr_ufeedback: float = 1.0,
    wd_ufeedback: float = 0.0,
    wd_ufeedback_bias: float = 0.0,
    M: int = 1,
):
    """Whole multi-round multi-IMFB run in ONE dispatch on big slabs.

    Signature: (state, stacked, chunk_id, fb, enabled, lrs, consts) ->
    state — identical to parallel/imfb_mesh.sharded_imfb_rounds; state
    must be in mesh_big's augmented slab layout."""
    from jax import shard_map

    step = _make_imfb_body_big(
        hp, n_real, mesh.shape["model"], mesh.shape["data"], G, F, nseg, M
    )
    state_spec, stacked_spec, fb_spec, consts_spec = _specs_big_imfb()

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


def sharded_imfb_predict_big(
    mesh: Mesh, hp: HyperParams, n_real: int, G: int, F: int, nseg: int
):
    """Multi-IMFB inference ON the mesh with big augmented slabs.

    The forward half of _make_imfb_body_big without updates; predictions
    come back [T, G] sharded over data (counterpart of
    imfb_mesh.sharded_imfb_predict)."""
    from jax import shard_map

    n_model, n_data = mesh.shape["model"], mesh.shape["data"]
    assert G % n_data == 0 and F % n_data == 0
    f_local = F // n_data
    k = hp.num_factor
    state_spec, stacked_spec, fb_spec, consts_spec = _specs_big_imfb()

    def run(state: TrainState, stacked, chunk_id, fb, consts):
        w, g = state.w, state.g
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_real
        scratch = n_real
        with_bias = not hp.no_user_bias

        def body(_, xs):
            batch, cid = xs
            cfb = jax.tree.map(lambda a: a[cid], fb)
            sl = jax.lax.dynamic_slice_in_dim(cfb["fb_idx"], did * f_local, f_local)
            sv = jax.lax.dynamic_slice_in_dim(cfb["fb_val"], did * f_local, f_local)
            sc = jax.lax.dynamic_slice_in_dim(cfb["fb_ctx"], did * f_local, f_local)
            loc = sl - lo
            own = (loc >= 0) & (loc < n_real)
            locc = jnp.where(own, loc, scratch)
            v = jnp.where(own, sv, 0.0)
            rows = gather_rows(w, locc)
            agg = _seg_sum_stacked(
                nseg, sc,
                jnp.concatenate(
                    [rows[:, :k] * v[:, None], (rows[:, k] * v)[:, None]],
                    axis=1,
                ),
            )
            agg = jax.lax.psum(jax.lax.psum(agg, "model"), "data")
            ctx = batch["ctx_slots"]
            _, _, score, _, _ = _fwd_big(
                w, g, batch, hp, 0.0, consts, state.step, lo, n_real, k,
                p_u_extra=agg[:, :k][ctx].sum(axis=1),
                bias_extra=agg[:, k][ctx].sum(axis=1) if with_bias else None,
            )
            return None, losses.map_active(score, hp.active_type)

        _, preds = jax.lax.scan(body, None, (stacked, chunk_id))
        return preds

    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(state_spec, stacked_spec, P(), fb_spec, consts_spec),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    return jax.jit(fn)
