"""Sharded bilinear step: the SVD++ mesh recipe + the W_bi coupling.

Extends svdpp_mesh.py to extend_type=15 (apex_svd_bilinear.h:28-212):

* the unified table rides the standard sharded SVD++ step (masked local
  gathers + psum, all-gathered sparse updates, SP feedback reduction);
* W_bi[item, bi_feedback] is row-sharded over ``model`` (padded, dummy
  last row).  The plugin bias is a masked local gather + psum over
  ``model``; the W_bi update all-gathers each batch's (item, coef)
  entries over ``data`` (same recipe as mesh._apply_row_updates) and
  every data replica of a model shard applies the identical update +
  per-pair/row decay to its slab;
* the dense per-block user-property matrix ``up`` [C, G+1, nbf] is
  replicated (pack-time artifact, solvers/bilinear.py).

Per-batch refresh semantics — trajectory-identical to the small-table
bilinear epochs (ops/svdpp_bilinear.py; pinned by tests/test_side_solvers.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import losses
from ..ops.embed import (
    HIGHEST,
    HyperParams,
    TrainConsts,
    TrainState,
    _soft_threshold,
)
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


def pad_bi_rows(num_item: int, n_model: int) -> int:
    """W_bi padded row count: dummy row appended, rounded up so each
    model shard gets an equal slab."""
    return -(-(num_item + 1) // n_model) * n_model


def _bi_plug_and_update(
    Wb, up_g, lid_all, coef_all, vals_all, g_of_entry, lo_bi, nb_local,
    lr_bi, wd_bi, reg_bi,
):
    """W_bi slab update from the batch's all-gathered (item, coef, i_val)
    entries — the mesh form of ops/svdpp_bilinear._bi_step.  Non-owned
    entries carry ZERO values (the shared mesh convention: the clamped
    local target may be a real row, so masking rides the values, never a
    scratch row); touch counters key off |i_val| like the small step.
    up_g [G+1, nbf] is the replicated per-slot property matrix; every
    data replica applies the identical update."""
    dummy = nb_local - 1
    loc = lid_all - lo_bi
    own = (loc >= 0) & (loc < nb_local)
    locc = jnp.where(own, loc, dummy)
    coef = jnp.where(own, coef_all, 0.0)
    up_e = up_g[g_of_entry]  # [E, nbf]
    upd = coef[:, None] * up_e
    Wb = _seg_add(Wb, locc, upd, nb_local)

    touched = (jnp.abs(vals_all) > 0) & own
    lam = lr_bi * wd_bi
    if reg_bi in (0, 1, 4, 5):
        pair_touch = touched[:, None] * (jnp.abs(up_e) > 0)
        touch = _seg_add(
            jnp.zeros_like(Wb), locc, pair_touch.astype(jnp.float32), nb_local
        )
        if reg_bi == 0:
            Wb = Wb * jnp.power(1.0 - lam, touch)
        else:
            Wb = _soft_threshold(Wb, lam * touch)
    elif reg_bi in (2, 3):
        cnt = jnp.zeros((nb_local,), jnp.float32).at[locc].add(
            jnp.where(touched, 1.0, 0.0)
        )
        if reg_bi == 2:
            Wb = Wb * jnp.power(1.0 - lam, cnt)[:, None]
        else:
            Wb = _soft_threshold(Wb, (lam * cnt)[:, None])
    else:
        raise ValueError(f"unknown bi feedback decay method {reg_bi}")
    return Wb


def _seg_add(dst, idx, pay, n):
    """dst[idx] += pay via the one-hot matmul where the backend's
    capability row asks for it, else a scatter-add."""
    from ..ops.embed import _onehot, _use_onehot

    if _use_onehot(n):
        A = _onehot(idx, n)
        return dst + jnp.einsum("en,ec->nc", A, pay,
                                precision=HIGHEST)
    return dst.at[idx].add(pay)


def _make_bilinear_body(
    hp: HyperParams, n_pad: int, n_bi_pad: int, n_model: int, n_data: int,
    G: int, F: int, off_item: int, reg_bi: int, M: int = 1,
):
    """Per-shard bilinear step body (M rows per user).

    Wraps the sharded SVD++ math (svdpp_mesh._make_svdpp_body, same
    citations) with the plugin bias + the sharded W_bi step.  The batch's
    coef entries are all-gathered over ``data`` so every model shard sees
    all its rows' updates; the plug is psum'd over ``model``.  M>1 uses
    the implicitly-damped M-wide Jacobi feedback step of
    svdpp_mesh._make_svdpp_body; the W_bi hogwild sum needs no extra
    damping (see ops/svdpp_bilinear.train_epoch_bi).
    """
    n_local = n_pad // n_model
    nb_local = n_bi_pad // n_model
    assert G % n_data == 0 and F % n_data == 0
    g_local = G // n_data
    f_local = F // n_data

    def step(state, Wb, batch, cfb, up_c, lr, hyper, consts):
        lr_fb, d, db, lr_bi, wd_bi = hyper
        w, b = state.w, state.b
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_local
        lo_bi = mid * nb_local
        dummy = n_local - 1
        dummy_bi = nb_local - 1
        with_bias = not hp.no_user_bias
        nseg = G + 1
        # global user slot of each local row (M consecutive rows per user)
        slot = did * g_local + jnp.arange(g_local * M, dtype=jnp.int32) // M

        # ---- SP feedback aggregates (filtered pool values — solver
        # zeroes start_ufeedback-filtered entries at pack time)
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
                [w[locc] * v[:, None], (b[locc] * v)[:, None], (sv * sv)[:, None]],
                axis=1,
            ),
        )
        fb_sum = jax.lax.psum(jax.lax.psum(agg[:, :k], "model"), "data")
        norm = jax.lax.psum(agg[:, k + 1], "data")
        fb_bias = jax.lax.psum(jax.lax.psum(agg[:, k], "model"), "data")
        fb_sum, fb_bias, norm = fb_sum[:G], fb_bias[:G], norm[:G]

        # ---- lazy catch-up AFTER the aggregates (reference order)
        step0 = state.step
        cu, ci = _touch_counts_sharded(batch, lo, n_local)
        w, gbias, ref_ui, ref_g = _lazy_catchup_sharded(
            w, state.g, state.ref_ui, state.ref_g, batch, cu, ci, step0,
            lr, consts, hp,
        )

        # ---- plugin bias: masked local W_bi gather, psum over model
        up_g = up_c[slot]  # [g_local, nbf] this shard's rows' properties
        lid = batch["i_idx"] - off_item  # [g_local, S] global item ids
        bloc = lid - lo_bi
        bown = (bloc >= 0) & (bloc < nb_local) & (lid >= 0)
        blocc = jnp.where(bown, bloc, dummy_bi)
        rows_bi = jnp.where(bown[..., None], Wb[blocc], 0.0)  # [g,S,nbf]
        per = jnp.einsum("gsn,gn->gs", rows_bi, up_g, precision=HIGHEST)
        plug = jax.lax.psum(
            jnp.einsum("gs,gs->g", per, batch["i_val"], precision=HIGHEST), "model"
        )

        # ---- forward (plug outside the no_user_bias gate, like
        # ops/embed.forward_scores; get_bias_plugin apex_svd_base.h:436-438)
        p_u, p_i, bias = _sharded_forward(w, b, batch, hp, lo, n_local, dummy)
        p_u = p_u + fb_sum[slot]
        if with_bias:
            bias = bias + fb_bias[slot]
        score = hp.base_score + bias + plug + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
        score = score + jnp.einsum(
            "bs,bs->b", batch["g_val"], gbias[batch["g_idx"]], precision=HIGHEST)
        pred = losses.map_active(score, hp.active_type)
        err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

        # ---- row updates + global
        w, b = _apply_row_updates(
            w, b, batch, lr * err, p_u, p_i, hp, lo, n_local, dummy
        )
        gbias = _global_update_psum(gbias, batch, err, lr)

        # ---- W_bi step: all-gather this batch's (item, coef) entries
        # over data; identical application on every data replica
        S = lid.shape[1]
        coef = (lr_bi * err)[:, None] * batch["i_val"]  # [g_local*M, S]
        lid_all = jax.lax.all_gather(lid, "data").reshape(-1)  # [G*M*S]
        coef_all = jax.lax.all_gather(coef, "data").reshape(-1)
        vals_all = jax.lax.all_gather(batch["i_val"], "data").reshape(-1)
        # entry -> owning USER (M consecutive rows per user)
        g_of_entry = jnp.arange(G * M * S, dtype=jnp.int32) // (M * S)
        # pad/absent items: route to the global dummy with ZERO values
        valid = (lid_all >= 0) & (lid_all < n_bi_pad - 1)
        lid_all = jnp.where(valid, lid_all, n_bi_pad - 1)
        coef_all = jnp.where(valid, coef_all, 0.0)
        vals_all = jnp.where(valid, vals_all, 0.0)
        Wb = _bi_plug_and_update(
            Wb, up_c, lid_all, coef_all, vals_all, g_of_entry, lo_bi,
            nb_local, lr_bi, wd_bi, reg_bi,
        )

        # ---- feedback writeback (replicated delta, masked to owned rows)
        cols = [err[:, None] * p_i, batch["weight"][:, None], err[:, None]]
        if M > 1:
            # |p_i|^2 column only when the damping reads it
            cols.append(jnp.sum(p_i * p_i, axis=1, keepdims=True))
        red = jax.lax.psum(
            _seg_sum_stacked(nseg, slot, jnp.concatenate(cols, axis=1)),
            "data",
        )[:G]
        errpi, m_g, err_g = red[:, :k], red[:, k], red[:, k + 1]
        if M > 1:
            # implicitly-damped M-wide Jacobi feedback step — the exact
            # math of svdpp_mesh._make_svdpp_body / ops/svdpp._plus_step
            pip2 = red[:, k + 2]
            frac = jnp.where(m_g > 0, (m_g - 1.0) / jnp.maximum(m_g, 1.0), 0.0)
            errpi = errpi / (1.0 + lr_fb * norm * pip2 * frac)[:, None]
            err_g = err_g / (1.0 + lr_fb * norm * (m_g - 1.0) * (m_g > 0))
        inv_norm = jnp.where(norm > 0, 1.0 / jnp.maximum(norm, 1e-30), 0.0)
        dtmp = (
            fb_sum * (jnp.power(d, m_g) - 1.0)[:, None]
            + lr_fb * norm[:, None] * errpi
        )
        delta = jnp.concatenate(
            [dtmp * inv_norm[:, None], jnp.zeros((1, k))], axis=0
        )
        floc = cfb["fb_idx"] - lo
        fown = (floc >= 0) & (floc < n_local)
        flocc = jnp.where(fown, floc, dummy)
        fval = jnp.where(fown, cfb["fb_val"], 0.0)
        if with_bias:
            dtmp_b = fb_bias * (jnp.power(db, m_g) - 1.0) + lr_fb * norm * err_g
            delta_b = jnp.concatenate([dtmp_b * inv_norm, jnp.zeros((1,))])
        else:
            delta_b = None
        cfb_local = {"fb_idx": flocc, "fb_block": cfb["fb_block"], "fb_val": fval}
        w, b = _fb_writeback(w, b, cfb_local, delta, delta_b, with_bias)

        # ---- decay / clamp / scrub
        w, b, gbias = _decay_clamp_scrub(
            w, b, gbias, batch, cu, ci, lr, consts, hp, lo, n_local, n_pad
        )
        nstep = step0 + _count_present(batch)
        return (
            TrainState(w=w, b=b, g=gbias, step=nstep, ref_ui=ref_ui,
                       ref_g=ref_g),
            Wb,
        )

    return step


def _specs():
    state_spec = TrainState(
        w=P("model", None), b=P("model"), g=P(), step=P(),
        ref_ui=P("model"), ref_g=P(),
    )
    batch_keys = (
        "label", "weight", "g_idx", "g_val", "u_idx", "u_val", "i_idx",
        "i_val",
    )
    stacked_spec = {
        k: (P(None, "data") if k in ("label", "weight") else P(None, "data", None))
        for k in batch_keys
    }
    cfb_spec = {"fb_idx": P(), "fb_val": P(), "fb_block": P()}
    consts_spec = TrainConsts(
        wd_u_row=P("model"), wd_i_row=P("model"), wd_g_row=P(),
        wd_user_bias=P(), wd_item_bias=P(),
    )
    return state_spec, stacked_spec, cfb_spec, consts_spec


def sharded_bilinear_rounds(
    mesh: Mesh,
    hp: HyperParams,
    n_pad: int,
    n_bi_pad: int,
    G: int,
    F: int,
    off_item: int,
    reg_bi: int,
    scale_lr_ufeedback: float = 1.0,
    wd_ufeedback: float = 0.0,
    wd_ufeedback_bias: float = 0.0,
    slr_bi: float = 1.0,
    wd_bi: float = 0.0,
    M: int = 1,
):
    """Whole multi-round bilinear run in ONE dispatch on the mesh.

    Signature: (state, Wb, stacked, chunk_id, fb, up, lrs, consts) ->
    (state, Wb).  ``Wb``: [n_bi_pad, nbf] row-sharded W_bi (+ dummy);
    ``up``: [C, G+1, nbf] replicated user-property matrices; ``stacked``:
    [T, G*M, ...] batches (M consecutive slots per user).
    """
    from jax import shard_map

    step = _make_bilinear_body(
        hp, n_pad, n_bi_pad, mesh.shape["model"], mesh.shape["data"], G, F,
        off_item, reg_bi, M,
    )
    state_spec, stacked_spec, cfb_spec, consts_spec = _specs()

    def run(state, Wb, stacked, chunk_id, fb, up, lrs, consts):
        def round_body(carry, lr):
            st, Wb = carry
            lr_fb = lr * scale_lr_ufeedback
            hyper = (
                lr_fb,
                1.0 - lr_fb * wd_ufeedback,
                1.0 - lr_fb * wd_ufeedback_bias,
                lr * slr_bi,
                wd_bi,
            )

            def batch_body(c, xs):
                st, Wb = c
                batch, cid = xs
                cfb = jax.tree.map(lambda a: a[cid], fb)
                st, Wb = step(st, Wb, batch, cfb, up[cid], lr, hyper, consts)
                return (st, Wb), None

            (st, Wb), _ = jax.lax.scan(batch_body, (st, Wb), (stacked, chunk_id))
            return (st, Wb), None

        (state, Wb), _ = jax.lax.scan(round_body, (state, Wb), lrs)
        return state, Wb

    fb_spec = {k: P(None, None) for k in cfb_spec}
    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(
            state_spec, P("model", None), stacked_spec, P(), fb_spec,
            P(), P(), consts_spec,
        ),
        out_specs=(state_spec, P("model", None)),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0, 1))


def sharded_bilinear_predict(
    mesh: Mesh, hp: HyperParams, n_pad: int, n_bi_pad: int, G: int, F: int,
    off_item: int, M: int = 1,
):
    """Bilinear inference ON the mesh — both tables stay row-sharded."""
    from jax import shard_map

    n_model, n_data = mesh.shape["model"], mesh.shape["data"]
    n_local = n_pad // n_model
    nb_local = n_bi_pad // n_model
    assert G % n_data == 0 and F % n_data == 0
    g_local = G // n_data
    f_local = F // n_data
    state_spec, stacked_spec, cfb_spec, consts_spec = _specs()

    def run(state: TrainState, Wb, stacked, chunk_id, fb, up):
        w, b, gbias = state.w, state.b, state.g
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_local
        lo_bi = mid * nb_local
        dummy = n_local - 1
        dummy_bi = nb_local - 1
        with_bias = not hp.no_user_bias
        nseg = G + 1
        k = w.shape[1]
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
            agg = _seg_sum_stacked(
                nseg,
                sb,
                jnp.concatenate(
                    [w[locc] * v[:, None], (b[locc] * v)[:, None]], axis=1
                ),
            )
            agg = jax.lax.psum(jax.lax.psum(agg, "model"), "data")
            up_g = up[cid][slot]
            lid = batch["i_idx"] - off_item
            bloc = lid - lo_bi
            bown = (bloc >= 0) & (bloc < nb_local) & (lid >= 0)
            blocc = jnp.where(bown, bloc, dummy_bi)
            rows_bi = jnp.where(bown[..., None], Wb[blocc], 0.0)
            per = jnp.einsum("gsn,gn->gs", rows_bi, up_g, precision=HIGHEST)
            plug = jax.lax.psum(
                jnp.einsum("gs,gs->g", per, batch["i_val"], precision=HIGHEST), "model"
            )
            p_u, p_i, bias = _sharded_forward(w, b, batch, hp, lo, n_local, dummy)
            p_u = p_u + agg[:, :k][slot]
            if with_bias:
                bias = bias + agg[:, k][slot]
            score = hp.base_score + bias + plug + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
            score = score + jnp.einsum(
                "bs,bs->b", batch["g_val"], gbias[batch["g_idx"]], precision=HIGHEST)
            return None, losses.map_active(score, hp.active_type)

        _, preds = jax.lax.scan(body, None, (stacked, chunk_id))
        return preds

    fb_spec = {k: P(None, None) for k in cfb_spec}
    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(state_spec, P("model", None), stacked_spec, P(), fb_spec, P()),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    return jax.jit(fn)
