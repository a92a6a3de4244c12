"""Sharded bilinear on BIG augmented slabs: mesh x big tables for
extend_type=15.

parallel/bilinear_mesh.py applies its W_bi updates and unified-table
row updates on standard slabs (one-hot form up to
ONEHOT_THRESHOLD local rows).  This module composes the big-slab SVD++
body (parallel/svdpp_mesh_big.py — augmented slabs, sorted-dedup
unique-row writes) with the bilinear plugin:

  * unified table: verbatim svdpp_mesh_big (aggregates row-gathered
    from the local augmented slab, _fwd_big forward, all-gathered entry
    stream merged by apply_entries, dedup pool writeback);
  * plugin bias: masked local W_bi row gathers + psum over ``model``
    (get_bias_plugin, apex_svd_bilinear.h:141-168);
  * W_bi update: the batch's (item, coef, i_val) entries all-gathered
    over ``data``, localized to each shard's W_bi slab (non-owned ->
    scratch with ZERO coef/val), then the same touched-rows-only
    sorted-dedup merge + ONE unique-row write as the single-chip
    big-table W_bi step (ops/svdpp_bilinear._bi_step_big) — per-pair or
    per-row decay rides the payload.

W_bi slab layout mirrors mesh_big's: shard s owns logical item rows
[s*nb_real, (s+1)*nb_real) at physical rows [s*(nb_real+1), ...), with
one trailing scratch row per shard for non-owned redirects (the dedup
write REPLACES rows, so the redirect target must tolerate arbitrary
overwrites; scratch only ever receives zeros).

Parity with the single-device bilinear trajectory is pinned by
tests/test_mesh_big.py::test_bilinear_mesh_big_config_path.  Reference
contract: extend_type=15 trains like any other solver at any table size
(apex_svd_bilinear.h:28-212 imposes no size limit).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import losses
from ..ops.big_embed import apply_entries, gather_rows, sorted_dedup, write_rows_unique
from ..ops.embed import (
    HIGHEST,
    HyperParams,
    TrainConsts,
    TrainState,
    _soft_threshold,
)
from ..ops.svdpp_big import _fb_writeback_big
from .mesh import _count_present, _global_update_psum, _seg_sum, _seg_sum_stacked
from .mesh_big import _fwd_big
from .svdpp_mesh_big import _specs_big_plus


def bi_big_layout(num_item: int, n_model: int) -> Tuple[int, int]:
    """(nb_real, nb_phys): logical item rows owned per shard, physical
    slab rows (+1 scratch row per shard)."""
    nb_real = -(-num_item // n_model) if num_item else 1
    return nb_real, nb_real + 1


def shard_bi_big(W_bi, mesh: Mesh):
    """W_bi [num_item, nbf] -> scratch-interleaved row-sharded layout.

    Returns (sharded [n_model*(nb_real+1), nbf], nb_real)."""
    n_model = mesh.shape["model"]
    num_item, nbf = W_bi.shape
    nb_real, nb_phys = bi_big_layout(num_item, n_model)
    out = np.zeros((n_model, nb_phys, nbf), np.float32)
    Wb = np.asarray(W_bi)
    for s in range(n_model):
        lo = s * nb_real
        cnt = max(0, min(nb_real, num_item - lo))
        out[s, :cnt] = Wb[lo : lo + cnt]
    out = out.reshape(n_model * nb_phys, nbf)
    return (
        jax.device_put(jnp.asarray(out), NamedSharding(mesh, P("model", None))),
        nb_real,
    )


def unshard_bi_big(Wb, n_model: int, nb_real: int, num_item: int):
    """Inverse of shard_bi_big: strip scratch rows, slice to num_item."""
    nbf = Wb.shape[1]
    nb_phys = nb_real + 1
    out = jnp.asarray(Wb).reshape(n_model, nb_phys, nbf)[:, :nb_real]
    return out.reshape(n_model * nb_real, nbf)[:num_item]


def _bi_update_big(
    Wb, up_full, lid_all, coef_all, vals_all, g_of_entry, lo_bi, nb_real,
    lr_bi, wd_bi, reg_bi,
):
    """W_bi slab update from all-gathered (item, coef, i_val) entries —
    the mesh form of ops/svdpp_bilinear._bi_step_big.  Non-owned entries
    redirect to the scratch row with ZERO coef/val (touch count 0, so
    decay^0 == 1 and the zero-write lands on scratch only)."""
    scratch = nb_real
    nbf = Wb.shape[1]
    loc = lid_all - lo_bi
    own = (loc >= 0) & (loc < nb_real)
    locc = jnp.where(own, loc, scratch)
    coef = jnp.where(own, coef_all, 0.0)
    vals = jnp.where(own, vals_all, 0.0)
    up_e = up_full[g_of_entry]  # [E, nbf]
    upd = coef[:, None] * up_e
    lam = lr_bi * wd_bi
    if reg_bi in (0, 1, 4, 5):
        pair_touch = (jnp.abs(vals) > 0)[:, None] & (jnp.abs(up_e) > 0)
        pay = jnp.concatenate([upd, pair_touch.astype(jnp.float32)], axis=1)
    elif reg_bi in (2, 3):
        occ = (jnp.abs(vals) > 0).astype(jnp.float32)
        pay = jnp.concatenate([upd, occ[:, None]], axis=1)
    else:
        raise ValueError(f"unknown bi feedback decay method {reg_bi}")
    order, si, acc, first, last = sorted_dedup(locc, pay)
    old = gather_rows(Wb, si)
    new = old + acc[:, :nbf]
    if reg_bi == 0:
        new = new * jnp.power(1.0 - lam, acc[:, nbf:])
    elif reg_bi in (1, 4, 5):
        new = _soft_threshold(new, lam * acc[:, nbf:])
    elif reg_bi == 2:
        new = new * jnp.power(1.0 - lam, acc[:, nbf])[:, None]
    else:  # reg_bi == 3
        new = _soft_threshold(new, (lam * acc[:, nbf])[:, None])
    is_real = last & (si != scratch)
    tgt = jnp.where(is_real, si, scratch)
    new = jnp.where(is_real[:, None], new, 0.0)
    return write_rows_unique(Wb, tgt, new)


def _bi_plug_big(Wb, up_g, batch, off_item, num_item, lo_bi, nb_real):
    """Masked local plugin bias: per-shard partial, caller psums over
    ``model`` (get_bias_plugin, apex_svd_bilinear.h:141-168)."""
    scratch = nb_real
    lid = batch["i_idx"] - off_item  # [g, S] logical item ids
    bloc = lid - lo_bi
    bown = (bloc >= 0) & (bloc < nb_real) & (lid >= 0) & (lid < num_item)
    blocc = jnp.where(bown, bloc, scratch)
    rows_bi = gather_rows(Wb, blocc)  # [g, S, nbf]
    rows_bi = jnp.where(bown[..., None], rows_bi, 0.0)
    per = jnp.einsum("gsn,gn->gs", rows_bi, up_g, precision=HIGHEST)
    return jnp.einsum("gs,gs->g", per, batch["i_val"], precision=HIGHEST), lid


def _make_bilinear_body_big(
    hp: HyperParams, n_real: int, nb_real: int, n_model: int, n_data: int,
    G: int, F: int, off_item: int, num_item: int, reg_bi: int, M: int = 1,
):
    """Per-shard bilinear step on augmented slabs (M rows per user).

    svdpp_mesh_big._make_svdpp_body_big (same citations) plus the
    plugin bias and the sharded dedup W_bi step.  M>1 uses the
    implicitly-damped M-wide Jacobi feedback step (ops/svdpp._plus_step);
    the W_bi hogwild sum needs no extra damping
    (ops/svdpp_bilinear.train_epoch_bi)."""
    k = hp.num_factor
    assert k > 0, "mesh big path requires hp.num_factor"
    assert G % n_data == 0 and F % n_data == 0
    g_local = G // n_data
    f_local = F // n_data

    def step(state, Wb, batch, cfb, up_c, lr, hyper, consts):
        lr_fb, d, db, lr_bi, wd_bi = hyper
        w, g = state.w, state.g
        step0, ref_g = state.step, state.ref_g
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_real
        lo_bi = mid * nb_real
        scratch = n_real
        f32 = jnp.float32
        with_bias = not hp.no_user_bias
        nseg = G + 1
        slot = did * g_local + jnp.arange(g_local * M, dtype=jnp.int32) // M

        # ---- SP: feedback aggregates (filtered pool values — the solver
        # zeroes start_ufeedback-filtered entries at pack time)
        sl = jax.lax.dynamic_slice_in_dim(cfb["fb_idx"], did * f_local, f_local)
        sv = jax.lax.dynamic_slice_in_dim(cfb["fb_val"], did * f_local, f_local)
        sb = jax.lax.dynamic_slice_in_dim(cfb["fb_block"], did * f_local, f_local)
        loc = sl - lo
        own = (loc >= 0) & (loc < n_real)
        locc = jnp.where(own, loc, scratch)
        v = jnp.where(own, sv, 0.0)
        rows = gather_rows(w, locc)
        agg = _seg_sum_stacked(
            nseg,
            sb,
            jnp.concatenate(
                [
                    rows[:, :k] * v[:, None],
                    (rows[:, k] * v)[:, None],
                    (sv * sv)[:, None],
                ],
                axis=1,
            ),
        )
        fb_sum = jax.lax.psum(jax.lax.psum(agg[:, :k], "model"), "data")
        fb_bias = jax.lax.psum(jax.lax.psum(agg[:, k], "model"), "data")
        norm = jax.lax.psum(agg[:, k + 1], "data")

        # ---- lazy global catch-up (same order as svdpp_mesh_big)
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

        # ---- plugin bias: masked local W_bi gather, psum over model
        up_g = up_c[slot]  # [g_local, nbf]
        plug_local, lid = _bi_plug_big(
            Wb, up_g, batch, off_item, num_item, lo_bi, nb_real
        )
        plug = jax.lax.psum(plug_local, "model")

        # ---- forward with the feedback injection + the plug
        p_u, p_i, score, (lu, uv), (li, iv) = _fwd_big(
            w, g, batch, hp, lr, consts, step0, lo, n_real, k,
            p_u_extra=fb_sum[slot],
            bias_extra=fb_bias[slot] if with_bias else None,
        )
        score = score + plug
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
        # (verbatim svdpp_mesh_big._make_svdpp_body_big)
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

        # ---- W_bi step: all-gather this batch's (item, coef, val)
        # entries over data; every data replica of a model shard merges
        # the identical dedup update into its slab
        S = lid.shape[1]
        coef_bi = (lr_bi * err)[:, None] * batch["i_val"]  # [g_local, S]
        lid_all = jax.lax.all_gather(lid, "data").reshape(-1)  # [G*M*S]
        coefb_all = jax.lax.all_gather(coef_bi, "data").reshape(-1)
        vals_all = jax.lax.all_gather(batch["i_val"], "data").reshape(-1)
        # entry -> owning USER (M consecutive rows per user)
        g_of_entry = jnp.arange(G * M * S, dtype=jnp.int32) // (M * S)
        valid = (lid_all >= 0) & (lid_all < num_item)
        lid_all = jnp.where(valid, lid_all, -1)  # -1 -> non-owned everywhere
        coefb_all = jnp.where(valid, coefb_all, 0.0)
        vals_all = jnp.where(valid, vals_all, 0.0)
        Wb = _bi_update_big(
            Wb, up_c, lid_all, coefb_all, vals_all, g_of_entry, lo_bi,
            nb_real, lr_bi, wd_bi, reg_bi,
        )

        # ---- feedback writeback: replicated delta over the FULL pool,
        # masked to owned rows, merged by ONE dedup write
        cols = [err[:, None] * p_i, batch["weight"][:, None], err[:, None]]
        if M > 1:
            # |p_i|^2 column only when the damping reads it
            cols.append(jnp.sum(p_i * p_i, axis=1, keepdims=True))
        red = jax.lax.psum(
            _seg_sum_stacked(nseg, slot, jnp.concatenate(cols, axis=1)),
            "data",
        )
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
        delta = dtmp * inv_norm[:, None]
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
        return (
            TrainState(
                w=w, b=state.b, g=g, step=nstep, ref_ui=state.ref_ui,
                ref_g=ref_g,
            ),
            Wb,
        )

    return step


def sharded_bilinear_rounds_big(
    mesh: Mesh,
    hp: HyperParams,
    n_real: int,
    nb_real: int,
    G: int,
    F: int,
    off_item: int,
    num_item: int,
    reg_bi: int,
    scale_lr_ufeedback: float = 1.0,
    wd_ufeedback: float = 0.0,
    wd_ufeedback_bias: float = 0.0,
    slr_bi: float = 1.0,
    wd_bi: float = 0.0,
    M: int = 1,
):
    """Whole multi-round bilinear run in ONE dispatch on big slabs.

    Signature: (state, Wb, stacked, chunk_id, fb, up, lrs, consts) ->
    (state, Wb) — identical to bilinear_mesh.sharded_bilinear_rounds;
    state must be in mesh_big's augmented layout and Wb in
    shard_bi_big's scratch-interleaved layout."""
    from jax import shard_map

    step = _make_bilinear_body_big(
        hp, n_real, nb_real, mesh.shape["model"], mesh.shape["data"], G, F,
        off_item, num_item, reg_bi, M,
    )
    state_spec, stacked_spec, fb_spec, consts_spec = _specs_big_plus()

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


def sharded_bilinear_predict_big(
    mesh: Mesh, hp: HyperParams, n_real: int, nb_real: int, G: int, F: int,
    off_item: int, num_item: int, M: int = 1,
):
    """Bilinear inference ON the mesh with big augmented slabs — both
    tables stay row-sharded (counterpart of
    bilinear_mesh.sharded_bilinear_predict)."""
    from jax import shard_map

    n_model, n_data = mesh.shape["model"], mesh.shape["data"]
    assert G % n_data == 0 and F % n_data == 0
    g_local = G // n_data
    f_local = F // n_data
    k = hp.num_factor
    state_spec, stacked_spec, fb_spec, consts_spec = _specs_big_plus()

    def run(state: TrainState, Wb, stacked, chunk_id, fb, up, consts):
        w, g = state.w, state.g
        mid = jax.lax.axis_index("model")
        did = jax.lax.axis_index("data")
        lo = mid * n_real
        lo_bi = mid * nb_real
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
            agg = jax.lax.psum(jax.lax.psum(agg, "model"), "data")
            plug_local, _ = _bi_plug_big(
                Wb, up[cid][slot], batch, off_item, num_item, lo_bi, nb_real,
            )
            plug = jax.lax.psum(plug_local, "model")
            _, _, score, _, _ = _fwd_big(
                w, g, batch, hp, 0.0, consts, state.step, lo, n_real, k,
                p_u_extra=agg[:, :k][slot],
                bias_extra=agg[:, k][slot] if with_bias else None,
            )
            return None, losses.map_active(score + plug, hp.active_type)

        _, preds = jax.lax.scan(body, None, (stacked, chunk_id))
        return preds

    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(
            state_spec, P("model", None), stacked_spec, P(), fb_spec, P(),
            consts_spec,
        ),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    return jax.jit(fn)
