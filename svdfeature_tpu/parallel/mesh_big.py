"""Mesh big-slab path: sorted-dedup row updates on row-sharded tables.

parallel/mesh.py's base sharded step applies sparse updates to a
standard [rows, k] slab, in the one-hot form up to ONEHOT_THRESHOLD
local rows on backends that ask for it.  This module is the layout for
slabs above that size: the per-shard update becomes the same sort → cumsum-dedup →
unique-row write as the single-chip big-table step (ops/big_embed.py),
applied to each shard's LOCAL slab.  With it, "multi-chip" and "big
tables" hold at the same time — the regime the reference serves with
its single uniform O(nnz·k) update loop at any table size
(solvers/base-solver/apex_svd_base.h:456-462).

Layout.  Slabs use the augmented row format of ops/big_embed.py
(``[factors | bias | ref_bits | pad]``, big_embed.aug_width, one row
read or write per row) plus ONE trailing **scratch row per shard**: non-owned ids redirect
there, and because the dedup write REPLACES rows (it cannot rely on
zero-coefficient adds like the one-hot path) the redirect target must be
a row that tolerates arbitrary overwrites.  Physically the global table
is ``[n_model * (n_real + 1), W]`` with shard s owning logical rows
[s*n_real, (s+1)*n_real) at physical rows [s*(n_real+1), ...); batch ids
stay in the logical row space — only shard/unshard do the interleaving.

Per step (mirrors parallel/mesh.py's collective pattern):
  1. masked local row gathers (lazy catch-up on the gathered copies) →
     partial (p_u, p_i, bias) → psum over ``model``;
  2. replicated global-bias update with psum'd batch stats over ``data``;
  3. all_gather (ids, coefs, p-vectors, own-flags) over ``data`` — O(B·k)
     activations between devices, never table rows — then each shard
     merges the full entry stream into its slab via
     ops/big_embed.apply_entries (sorted dedup + one unique-row write).

Parity with the single-device step is pinned by
tests/test_mesh_big.py; the driver dryrun exercises an
above-threshold slab (__graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import losses
from ..ops.big_embed import apply_entries, aug_width, gather_rows
from ..ops.embed import HIGHEST, HyperParams, TrainConsts, TrainState
from .mesh import _count_present, _global_update_psum, _seg_sum


def big_layout(n: int, n_model: int) -> Tuple[int, int]:
    """(n_real, n_phys): real rows owned per shard, physical slab rows
    (+1 scratch row for non-owned-id redirects)."""
    n_real = -(-n // n_model)
    return n_real, n_real + 1


def shard_state_big(state: TrainState, mesh: Mesh, k: int):
    """Standard TrainState -> augmented, scratch-interleaved, row-sharded.

    Input state is the single-device layout (w [n,k], b [n], ref_ui [n],
    last row = global dummy).  Returns (sharded_state, n_real).
    """
    n_model = mesh.shape["model"]
    n = state.w.shape[0]
    n_real, n_phys = big_layout(n, n_model)
    W = aug_width(k)
    aug = np.zeros((n_model, n_phys, W), np.float32)
    w = np.asarray(state.w)
    b = np.asarray(state.b)
    ref = np.asarray(state.ref_ui).view(np.float32)
    for s in range(n_model):
        lo = s * n_real
        cnt = max(0, min(n_real, n - lo))
        aug[s, :cnt, :k] = w[lo : lo + cnt]
        aug[s, :cnt, k] = b[lo : lo + cnt]
        aug[s, :cnt, k + 1] = ref[lo : lo + cnt]
    aug = aug.reshape(n_model * n_phys, W)
    row_sh = NamedSharding(mesh, P("model", None))
    rep = NamedSharding(mesh, P())
    return (
        TrainState(
            w=jax.device_put(jnp.asarray(aug), row_sh),
            b=jax.device_put(jnp.zeros((0,), jnp.float32), rep),
            g=jax.device_put(state.g, rep),
            step=jax.device_put(state.step, rep),
            ref_ui=jax.device_put(jnp.zeros((0,), jnp.int32), rep),
            ref_g=jax.device_put(state.ref_g, rep),
        ),
        n_real,
    )


def unshard_state_big(
    state: TrainState, n_model: int, k: int, n: int
) -> TrainState:
    """Inverse of shard_state_big: strip scratch rows, de-augment, slice
    back to the unpadded n rows (incl. the global dummy)."""
    W = state.w.shape[1]
    n_real, n_phys = big_layout(n, n_model)
    aug = jnp.asarray(state.w).reshape(n_model, n_phys, W)[:, :n_real]
    aug = aug.reshape(n_model * n_real, W)[:n]
    return dataclasses.replace(
        state,
        w=aug[:, :k],
        b=aug[:, k],
        ref_ui=jax.lax.bitcast_convert_type(aug[:, k + 1], jnp.int32),
    )


def shard_consts_big(consts: TrainConsts, mesh: Mesh, n_real: int) -> TrainConsts:
    """Per-row wd tables in the scratch-interleaved layout (scratch wd=0)."""
    n_model = mesh.shape["model"]
    n = consts.wd_u_row.shape[0]
    n_phys = n_real + 1

    def lay(t):
        out = np.zeros((n_model, n_phys), np.float32)
        t = np.asarray(t)
        for s in range(n_model):
            lo = s * n_real
            cnt = max(0, min(n_real, n - lo))
            out[s, :cnt] = t[lo : lo + cnt]
        return jnp.asarray(out.reshape(-1))

    vec_sh = NamedSharding(mesh, P("model"))
    rep = NamedSharding(mesh, P())
    return TrainConsts(
        wd_u_row=jax.device_put(lay(consts.wd_u_row), vec_sh),
        wd_i_row=jax.device_put(lay(consts.wd_i_row), vec_sh),
        wd_g_row=jax.device_put(consts.wd_g_row, rep),
        wd_user_bias=jax.device_put(consts.wd_user_bias, rep),
        wd_item_bias=jax.device_put(consts.wd_item_bias, rep),
    )


def _soft_threshold(w, lam):
    return jnp.sign(w) * jnp.maximum(jnp.abs(w) - lam, 0.0)


def _local_entries(batch, lo, n_real):
    """Local ids (non-owned -> scratch), own masks, masked values."""
    scratch = n_real
    out = {}
    for seg in ("u", "i"):
        idx, val = batch[f"{seg}_idx"], batch[f"{seg}_val"]
        loc = idx - lo
        own = (loc >= 0) & (loc < n_real)
        out[seg] = (
            jnp.where(own, loc, scratch),
            jnp.where(own, val, 0.0),
            own,
        )
    return out["u"], out["i"]


def _fwd_big(w, g, batch, hp, lr, consts, step0, lo, n_real, k,
             p_u_extra=None, bias_extra=None):
    """Masked local augmented-row gathers (lazy catch-up on the copies,
    apex_svd_base.h:188-310 applied at gather time) -> psum'd
    (p_u, p_i, bias) + replicated-global score term.

    p_u_extra/bias_extra: replicated per-slot additions applied AFTER the
    psum, before the dot — the SVD++ feedback injection
    (prepare_svdpp, apex_svd_base.h:506-509)."""
    (lu, uv, _), (li, iv, _) = _local_entries(batch, lo, n_real)
    rows_u = gather_rows(w, lu)  # [B,S,W]
    rows_i = gather_rows(w, li)
    wu, bu = rows_u[..., :k], rows_u[..., k]
    wi, bi = rows_i[..., :k], rows_i[..., k]
    if hp.reg_method >= 4:
        f32 = jnp.float32
        ref_u = jax.lax.bitcast_convert_type(rows_u[..., k + 1], jnp.int32)
        ref_i = jax.lax.bitcast_convert_type(rows_i[..., k + 1], jnp.int32)
        el_u = (step0 - ref_u).astype(f32)
        el_i = (step0 - ref_i).astype(f32)
        lam_u = lr * consts.wd_u_row[lu]  # local wd slab; scratch wd=0
        lam_i = lr * consts.wd_i_row[li]
        if hp.reg_method == 4:
            wu = wu * jnp.power(1.0 - lam_u, el_u)[..., None]
            wi = wi * jnp.power(1.0 - lam_i, el_i)[..., None]
        else:
            wu = _soft_threshold(wu, (lam_u * el_u)[..., None])
            wi = _soft_threshold(wi, (lam_i * el_i)[..., None])
    p_u = jnp.einsum("bs,bsk->bk", uv, wu, precision=HIGHEST)
    p_i = jnp.einsum("bs,bsk->bk", iv, wi, precision=HIGHEST)
    bias = jnp.einsum("bs,bs->b", iv, bi, precision=HIGHEST)
    if not hp.no_user_bias:
        bias = bias + jnp.einsum("bs,bs->b", uv, bu, precision=HIGHEST)
    p_u, p_i, bias = jax.lax.psum((p_u, p_i, bias), "model")
    if p_u_extra is not None:
        p_u = p_u + p_u_extra
    if bias_extra is not None:
        bias = bias + bias_extra
    score = hp.base_score + bias + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
    score = score + jnp.einsum("bs,bs->b", batch["g_val"], g[batch["g_idx"]], precision=HIGHEST)
    return p_u, p_i, score, (lu, uv), (li, iv)


def _make_step_body_big(hp: HyperParams, n_real: int, n_model: int):
    """Raw per-shard step body on augmented slabs [n_real+1, W]."""
    k = hp.num_factor
    assert k > 0, "mesh big path requires hp.num_factor"

    def step(state: TrainState, batch, lr, consts: TrainConsts):
        w, g = state.w, state.g  # w local [n_phys, W]
        step0, ref_g = state.step, state.ref_g
        lo = jax.lax.axis_index("model") * n_real
        f32 = jnp.float32

        # ---- lazy global catch-up (regularize(pre) order, same as the
        # small mesh body / ops/big_embed._forward_entries)
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

        # ---- forward + error
        p_u, p_i, score, (lu, uv), (li, iv) = _fwd_big(
            w, g, batch, hp, lr, consts, step0, lo, n_real, k
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

        # ---- all-gathered entry stream over data (activations, not rows)
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
        # touch counts = owned occurrences (parity with
        # mesh._touch_counts_sharded / ops/embed._touch_counts)
        cnt_u = jnp.concatenate([g_ou.reshape(-1), jnp.zeros((Ei,), f32)])
        cnt_i = jnp.concatenate([jnp.zeros((Eu,), f32), g_oi.reshape(-1)])
        payload = jnp.concatenate(
            [dw, pay_b[:, None], cnt_u[:, None], cnt_i[:, None]], axis=1
        )

        # ---- slab-local sorted-dedup merge + ONE unique-row write.
        # apply_entries needs the pre-update rows for every entry; our
        # forward only gathered this data shard's slice, so re-gather the
        # full all-gathered stream from the LOCAL slab (no table comm).
        raw_u = gather_rows(w, g_lu.reshape(-1))
        raw_i = gather_rows(w, g_li.reshape(-1))
        # eager modes add the gradient to the un-decayed row (fwd == raw);
        # lazy modes recompute the catch-up from raw + ref bits inside
        # apply_entries, so raw[:, :k] serves as fwd in both cases
        w = apply_entries(
            w, step0, ent_idx, payload, raw_u, raw_i,
            raw_u[:, :k], raw_i[:, :k], lr, consts, hp,
        )

        nstep = step0 + _count_present(batch)
        return TrainState(
            w=w, b=state.b, g=g, step=nstep, ref_ui=state.ref_ui, ref_g=ref_g
        )

    return step


def _specs_big():
    state_spec = TrainState(
        w=P("model", None),
        b=P(),
        g=P(),
        step=P(),
        ref_ui=P(),
        ref_g=P(),
    )
    batch_spec = {
        k: P("data") for k in ("label", "weight")
    } | {
        k: P("data", None)
        for k in ("g_idx", "g_val", "u_idx", "u_val", "i_idx", "i_val")
    }
    consts_spec = TrainConsts(
        wd_u_row=P("model"),
        wd_i_row=P("model"),
        wd_g_row=P(),
        wd_user_bias=P(),
        wd_item_bias=P(),
    )
    stacked_spec = {
        k: (P(None, "data") if k in ("label", "weight") else P(None, "data", None))
        for k in (
            "label", "weight", "g_idx", "g_val", "u_idx", "u_val", "i_idx", "i_val"
        )
    }
    return state_spec, batch_spec, consts_spec, stacked_spec


def sharded_train_step_big(mesh: Mesh, hp: HyperParams, n_real: int):
    """(state, batch, lr, consts) -> state on big augmented slabs."""
    from jax import shard_map

    step = _make_step_body_big(hp, n_real, mesh.shape["model"])
    state_spec, batch_spec, consts_spec, _ = _specs_big()
    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(state_spec, batch_spec, P(), consts_spec),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def sharded_train_rounds_big(mesh: Mesh, hp: HyperParams, n_real: int):
    """Whole multi-round run in ONE dispatch (mesh.sharded_train_rounds
    analogue on big slabs)."""
    from jax import shard_map

    step = _make_step_body_big(hp, n_real, mesh.shape["model"])
    state_spec, _, consts_spec, stacked_spec = _specs_big()

    def run(state: TrainState, stacked, lrs, consts: TrainConsts):
        def round_body(st, lr):
            def batch_body(s, batch):
                return step(s, batch, lr, consts), None

            st, _ = jax.lax.scan(batch_body, st, stacked)
            return st, None

        state, _ = jax.lax.scan(round_body, state, lrs)
        return state

    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(state_spec, stacked_spec, P(), consts_spec),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def sharded_predict_big(mesh: Mesh, hp: HyperParams, n_real: int):
    """Batched inference on big augmented slabs (mesh.sharded_predict
    analogue): (state, stacked) -> pred [T, B], tables stay sharded.

    Like the single-device infer path, pending lazy decay is NOT applied
    (reference task_eval predicts with the stored parameters,
    svd_feature_infer.cpp:243-277)."""
    from jax import shard_map

    k = hp.num_factor
    state_spec, _, _, stacked_spec = _specs_big()

    def run(state: TrainState, stacked):
        w, g = state.w, state.g
        lo = jax.lax.axis_index("model") * n_real

        def body(_, batch):
            (lu, uv, _), (li, iv, _) = _local_entries(batch, lo, n_real)
            rows_u = gather_rows(w, lu)
            rows_i = gather_rows(w, li)
            p_u = jnp.einsum("bs,bsk->bk", uv, rows_u[..., :k], precision=HIGHEST)
            p_i = jnp.einsum("bs,bsk->bk", iv, rows_i[..., :k], precision=HIGHEST)
            bias = jnp.einsum("bs,bs->b", iv, rows_i[..., k], precision=HIGHEST)
            if not hp.no_user_bias:
                bias = bias + jnp.einsum("bs,bs->b", uv, rows_u[..., k], precision=HIGHEST)
            p_u, p_i, bias = jax.lax.psum((p_u, p_i, bias), "model")
            score = hp.base_score + bias + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
            score = score + jnp.einsum(
                "bs,bs->b", batch["g_val"], g[batch["g_idx"]], precision=HIGHEST)
            return None, losses.map_active(score, hp.active_type)

        _, preds = jax.lax.scan(body, None, stacked)
        return preds

    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(state_spec, stacked_spec),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    return jax.jit(fn)
