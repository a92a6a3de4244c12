"""Sharded SVD++ on BIG augmented slabs: mesh x big tables for the
user-group solver family.

parallel/svdpp_mesh.py's step body applies its row updates and pool
writebacks on standard slabs (one-hot form up to ONEHOT_THRESHOLD local
rows); parallel/mesh_big.py removes that limit for the base solver.
This module is their composition — the SVD++ per-batch-refresh step of
svdpp_mesh (exact; the chunk-carried closed form is an off-mesh
optimization) with every table-sized read/write routed through the
big-table primitives:

  * feedback aggregates: each data shard gathers its pool slice's rows
    from the LOCAL augmented slab (ops/big_embed.gather_rows — native
    row gathers, no one-hot), segment-sums per user block, and the
    [G+1, k] aggregates are psum'd over model + data — identical
    collective shape to svdpp_mesh (SP over the pool);
  * forward: mesh_big._fwd_big with the SVD++ feedback injection
    (p_u += fb_sum[slot] after the model psum — prepare_svdpp,
    apex_svd_base.h:506-509);
  * u/i row updates: the all-gathered entry stream merged into each
    shard's slab by ops/big_embed.apply_entries (sort -> dedup ->
    unique-row DMA write), exactly as mesh_big;
  * pool writeback: ops/svdpp_big._fb_writeback_big on the local slab
    (sorted-dedup accumulate + ONE unique-row write; non-owned pool ids
    redirect to the scratch row with value 0).

Slab layout, scratch-row redirect discipline, and shard/unshard are
mesh_big's (augmented ``[factors | bias | ref_bits | pad]`` rows + one
scratch row per shard).  All 6 reg modes: eager 0-3 inside
apply_entries, lazy 4/5 via the ref-bit lane (catch-up at gather time in
_fwd_big / at merge time in apply_entries); rows_per_user>1 uses the
same implicitly-damped M-wide feedback step as svdpp_mesh.  Parity with
the small-slab mesh path is pinned by tests/test_mesh_big.py.

Reference contract being preserved: one execution mode runs every
workload at any table size (apex_svd_base.h:456-462 is uniform
O(nnz*k)/example; the KDD-Cup scale this path exists for is the
reference's home turf).
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


def _make_svdpp_body_big(
    hp: HyperParams, n_real: int, n_model: int, n_data: int, G: int, F: int,
    M: int = 1,
):
    """Per-shard SVD++ step on augmented slabs [n_real+1, W].

    Batch rows [G*M] sharded over data (M consecutive slots per user,
    G % n_data == 0); cfb pool arrays [F] replicated — each data shard
    reduces its F/n_data slice for the aggregates and applies the full
    masked writeback identically (same contract as svdpp_mesh).
    """
    k = hp.num_factor
    assert k > 0, "mesh big path requires hp.num_factor"
    assert G % n_data == 0, "users_per_batch padded to a multiple of data axis"
    assert F % n_data == 0, "feedback pool padded to a multiple of data axis"
    g_local = G // n_data
    f_local = F // n_data

    def step(state: TrainState, batch, cfb, lr, fb_hyper, consts: TrainConsts):
        lr_fb, d, db = fb_hyper
        w, g = state.w, state.g  # w local augmented slab [n_real+1, W]
        step0, ref_g = state.step, state.ref_g
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_real
        scratch = n_real
        f32 = jnp.float32
        with_bias = not hp.no_user_bias
        nseg = G + 1
        slot = did * g_local + jnp.arange(g_local * M, dtype=jnp.int32) // M

        # ---- SP: feedback aggregates from this data shard's pool slice,
        # row-gathered from the local augmented slab, reduced over both
        # axes (prepare_ufeedback, apex_svd_base.h:523-538).  Pool rows
        # never decay (wd_ufeedback rides d), so no catch-up here — the
        # same discipline as svdpp_mesh's aggregate gathers.
        sl = jax.lax.dynamic_slice_in_dim(cfb["fb_idx"], did * f_local, f_local)
        sv = jax.lax.dynamic_slice_in_dim(cfb["fb_val"], did * f_local, f_local)
        sb = jax.lax.dynamic_slice_in_dim(cfb["fb_block"], did * f_local, f_local)
        loc = sl - lo
        own = (loc >= 0) & (loc < n_real)
        locc = jnp.where(own, loc, scratch)
        v = jnp.where(own, sv, 0.0)
        rows = gather_rows(w, locc)  # [f_local, W]
        agg = _seg_sum_stacked(
            nseg,
            sb,
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

        # ---- forward with the feedback injection
        p_u, p_i, score, (lu, uv), (li, iv) = _fwd_big(
            w, g, batch, hp, lr, consts, step0, lo, n_real, k,
            p_u_extra=fb_sum[slot],
            bias_extra=fb_bias[slot] if with_bias else None,
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
        D, B, Su = g_lu.shape
        Si = g_li.shape[2]
        Eu, Ei = D * B * Su, D * B * Si
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

        # ---- feedback writeback: replicated delta over the FULL pool,
        # masked to owned rows, merged by ONE dedup write
        # (update_svdpp/update_ufeedback, apex_svd_base.h:512-554)
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
        if with_bias:
            dtmp_b = fb_bias * (jnp.power(db, m_g) - 1.0) + lr_fb * norm * err_g
            delta_b = dtmp_b * inv_norm
        else:
            delta_b = None
        floc = cfb["fb_idx"] - lo
        fown = (floc >= 0) & (floc < n_real)
        cfb_local = {
            "fb_idx": jnp.where(fown, floc, scratch),
            "fb_val": jnp.where(fown, cfb["fb_val"], 0.0),
            "fb_block": cfb["fb_block"],
        }
        w = _fb_writeback_big(
            w, cfb_local, delta, delta_b, with_bias, k
        )

        nstep = step0 + _count_present(batch)
        return TrainState(
            w=w, b=state.b, g=g, step=nstep, ref_ui=state.ref_ui, ref_g=ref_g
        )

    return step


def _specs_big_plus():
    state_spec = TrainState(
        w=P("model", None), b=P(), g=P(), step=P(), ref_ui=P(), ref_g=P(),
    )
    keys = ("label", "weight", "g_idx", "g_val", "u_idx", "u_val", "i_idx", "i_val")
    stacked_spec = {
        k: (P(None, "data") if k in ("label", "weight") else P(None, "data", None))
        for k in keys
    }
    fb_spec = {k: P(None, None) for k in ("fb_idx", "fb_val", "fb_block")}
    consts_spec = TrainConsts(
        wd_u_row=P("model"), wd_i_row=P("model"), wd_g_row=P(),
        wd_user_bias=P(), wd_item_bias=P(),
    )
    return state_spec, stacked_spec, fb_spec, consts_spec


def sharded_svdpp_rounds_big(
    mesh: Mesh,
    hp: HyperParams,
    n_real: int,
    G: int,
    F: int,
    scale_lr_ufeedback: float = 1.0,
    wd_ufeedback: float = 0.0,
    wd_ufeedback_bias: float = 0.0,
    M: int = 1,
):
    """Whole multi-round SVD++ run in ONE dispatch on big slabs.

    Signature: (state, stacked, chunk_id, fb, lrs, consts) -> state —
    identical to parallel/svdpp_mesh.sharded_svdpp_rounds; state must be
    in mesh_big's augmented slab layout."""
    from jax import shard_map

    step = _make_svdpp_body_big(
        hp, n_real, mesh.shape["model"], mesh.shape["data"], G, F, M
    )
    state_spec, stacked_spec, fb_spec, consts_spec = _specs_big_plus()

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

    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(state_spec, stacked_spec, P(), fb_spec, P(), consts_spec),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def sharded_svdpp_predict_big(
    mesh: Mesh, hp: HyperParams, n_real: int, G: int, F: int, M: int = 1
):
    """SVD++ inference ON the mesh with big augmented slabs.

    The forward half of _make_svdpp_body_big without updates;
    predictions come back [T, G*M] sharded over data (counterpart of
    svdpp_mesh.sharded_svdpp_predict / apex_svd_base.h:583-591)."""
    from jax import shard_map

    n_model, n_data = mesh.shape["model"], mesh.shape["data"]
    assert G % n_data == 0 and F % n_data == 0
    g_local = G // n_data
    f_local = F // n_data
    k = hp.num_factor
    state_spec, stacked_spec, fb_spec, consts_spec = _specs_big_plus()

    def run(state: TrainState, stacked, chunk_id, fb, consts):
        w, g = state.w, state.g
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_real
        scratch = n_real
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
            own = (loc >= 0) & (loc < n_real)
            locc = jnp.where(own, loc, scratch)
            v = jnp.where(own, sv, 0.0)
            rows = gather_rows(w, locc)
            agg = _seg_sum_stacked(
                nseg, sb,
                jnp.concatenate(
                    [rows[:, :k] * v[:, None], (rows[:, k] * v)[:, None]],
                    axis=1,
                ),
            )
            fb_sum = jax.lax.psum(jax.lax.psum(agg[:, :k], "model"), "data")
            fb_bias = jax.lax.psum(jax.lax.psum(agg[:, k], "model"), "data")
            _, _, score, _, _ = _fwd_big(
                w, g, batch, hp, 0.0, consts, state.step, lo, n_real, k,
                p_u_extra=fb_sum[slot],
                bias_extra=fb_bias[slot] if with_bias else None,
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
