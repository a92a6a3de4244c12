"""Multi-chip sharding: (data, model) mesh, row-sharded tables, shard_map step.

The reference is strictly single-process (SURVEY.md §2.7) — this module is
the net-new distributed layer.  Design (scaling-book recipe):

* 2-D ``Mesh(('data', 'model'))``: batch is sharded over ``data``, the
  unified embedding table ``w``/``b`` is **row-sharded** over ``model``
  (the TP analogue for a factorization model — each shard owns a
  contiguous row range of the user/item/feedback table).
* Embedding lookup on a row-sharded table = *masked local gather + psum*:
  each shard gathers only the ids it owns (others hit its local dummy row)
  and the partial weighted sums are psum-reduced over ``model``.  The
  communication is O(B·k) activations between devices — never the table.
* Scatter-add update: each shard applies only the updates whose target row
  it owns (ids outside the local range are redirected to the local dummy
  row); no gradient communication for the table at all.
* Dense/global arrays (g_bias) are replicated; their gradients are summed
  with a psum over both axes.  Per-example err is computed redundantly per
  model-shard (cheap scalars) to avoid a broadcast round-trip.

PP is N/A for a one-layer factorization model (SURVEY.md §2.7); the
SVD++ feedback segment-sum is the SP/CP analogue and shards the same way
(ids routed by ownership).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import losses
from ..ops.embed import HIGHEST, HyperParams, TrainConsts, TrainState


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Multi-host bring-up: jax.distributed.initialize with env-driven
    defaults (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    or the cluster autodetection jax ships).  Idempotent; returns True
    when a multi-process runtime is active.

    The reference has no multi-host capability at all (SURVEY.md §2.7);
    this is the net-new entry point the CLI exposes via the
    ``distributed=1`` config key (train/loop.py).
    """
    import os

    if jax.process_count() > 1:
        return True
    kw = {}
    ca = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if ca:
        kw["coordinator_address"] = ca
    np_ = num_processes if num_processes is not None else os.environ.get(
        "JAX_NUM_PROCESSES"
    )
    if np_ is not None:
        kw["num_processes"] = int(np_)
    pid = process_id if process_id is not None else os.environ.get("JAX_PROCESS_ID")
    if pid is not None:
        kw["process_id"] = int(pid)
    jax.distributed.initialize(**kw)
    return jax.process_count() > 1


def make_mesh(
    n_data: int, n_model: int, devices: Optional[Sequence] = None
) -> Mesh:
    """(data x model) mesh, a plain reshape of the devices: the cards of
    one host reach each other all to all over NVLink, so the placement
    follows the algorithm alone.  Multi-host: the model axis is kept
    within a host and data spans hosts, so the per-batch psum over
    ``model`` (the latency-critical collective of the masked-gather
    forward) stays inside the host while only the data-axis reductions
    cross hosts."""
    if devices is None and jax.process_count() > 1:
        from jax.experimental import mesh_utils

        per_host = len(jax.local_devices())
        if n_model <= per_host and (n_data * n_model) % per_host == 0:
            arr = mesh_utils.create_hybrid_device_mesh(
                (n_data, n_model),
                ((n_data * n_model) // per_host, 1),
                devices=jax.devices(),
            )
            return Mesh(arr, ("data", "model"))
        devices = jax.devices()
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_data * n_model, "not enough devices"
    arr = np.array(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(arr, ("data", "model"))


def put_process_sharded(arrays: dict, mesh: Mesh) -> dict:
    """Process-sharded batch staging: each host materializes only ITS
    data-axis slice of the stacked epoch arrays ([T, B, ...], B sharded
    over ``data``), assembled into global arrays without ever gathering
    the full batch on one host (jax.make_array_from_process_local_data).

    Single-process meshes fall back to a plain sharded device_put.
    """
    out = {}
    for k, v in arrays.items():
        spec = P(None, "data") if v.ndim == 2 else P(None, "data", None)
        sh = NamedSharding(mesh, spec)
        if jax.process_count() > 1:
            n_shards = mesh.shape["data"]
            per = v.shape[1] // n_shards
            # data-axis rows of the mesh owned (in part) by this process
            pidx = jax.process_index()
            my = [
                i
                for i in range(n_shards)
                if any(d.process_index == pidx for d in mesh.devices[i])
            ]
            sl = np.concatenate(
                [v[:, i * per : (i + 1) * per] for i in my], axis=1
            )
            out[k] = jax.make_array_from_process_local_data(sh, sl)
        else:
            out[k] = jax.device_put(v, sh)
    return out


def _pad_rows(n: int, shards: int) -> int:
    """Padded row count so each shard owns an equal slab (incl. dummy)."""
    per = -(-n // shards)
    return per * shards


def shard_state(
    state: TrainState, mesh: Mesh
) -> Tuple[TrainState, int]:
    """Pad the table to a multiple of the model axis and shard rows.

    Each shard's local slab gets its own trailing dummy row semantics: ids
    not owned by a shard are remapped to the global padded-dummy region.
    Returns (sharded_state, padded_num_rows).
    """
    n_model = mesh.shape["model"]
    n = state.w.shape[0]  # includes the global dummy row
    n_pad = _pad_rows(n, n_model)
    pad = n_pad - n
    w = jnp.concatenate([state.w, jnp.zeros((pad, state.w.shape[1]), state.w.dtype)])
    b = jnp.concatenate([state.b, jnp.zeros((pad,), state.b.dtype)])
    ref_ui = jnp.concatenate([state.ref_ui, jnp.zeros((pad,), jnp.int32)])
    row_sh = NamedSharding(mesh, P("model", None))
    vec_sh = NamedSharding(mesh, P("model"))
    rep = NamedSharding(mesh, P())
    return (
        TrainState(
            w=jax.device_put(w, row_sh),
            b=jax.device_put(b, vec_sh),
            g=jax.device_put(state.g, rep),
            step=jax.device_put(state.step, rep),
            ref_ui=jax.device_put(ref_ui, vec_sh),
            ref_g=jax.device_put(state.ref_g, rep),
        ),
        n_pad,
    )


def shard_consts(consts: TrainConsts, mesh: Mesh, n_pad: int) -> TrainConsts:
    n = consts.wd_u_row.shape[0]
    pad = n_pad - n
    z = jnp.zeros((pad,), jnp.float32)
    vec_sh = NamedSharding(mesh, P("model"))
    rep = NamedSharding(mesh, P())
    return TrainConsts(
        wd_u_row=jax.device_put(jnp.concatenate([consts.wd_u_row, z]), vec_sh),
        wd_i_row=jax.device_put(jnp.concatenate([consts.wd_i_row, z]), vec_sh),
        wd_g_row=jax.device_put(consts.wd_g_row, rep),
        wd_user_bias=jax.device_put(consts.wd_user_bias, rep),
        wd_item_bias=jax.device_put(consts.wd_item_bias, rep),
    )


def _local_gather_sum(tab, idx, val, lo, n_local, dummy_local):
    """Masked local gather: ids in [lo, lo+n_local) -> local rows, others ->
    local dummy row (contributes 0)."""
    loc = idx - lo
    own = (loc >= 0) & (loc < n_local)
    loc = jnp.where(own, loc, dummy_local)
    v = jnp.where(own, val, 0.0)
    rows = tab[loc]
    if tab.ndim == 2:
        return jnp.einsum("bs,bsk->bk", v, rows, precision=HIGHEST)
    return jnp.einsum("bs,bs->b", v, rows, precision=HIGHEST)


def _local_ids(idx, val, lo, n_local, dummy_local):
    loc = idx - lo
    own = (loc >= 0) & (loc < n_local)
    return jnp.where(own, loc, dummy_local), jnp.where(own, val, 0.0)


# ---- shared per-shard building blocks (used by the base sharded step and
# the SVD++ sharded step, parallel/svdpp_mesh.py) ----------------------------


def _sharded_forward(w, b, batch, hp, lo, n_local, dummy):
    """Masked local gathers psum'd over model: (p_u, p_i, bias)."""
    u_idx, u_val = batch["u_idx"], batch["u_val"]
    i_idx, i_val = batch["i_idx"], batch["i_val"]
    p_u = _local_gather_sum(w, u_idx, u_val, lo, n_local, dummy)
    p_i = _local_gather_sum(w, i_idx, i_val, lo, n_local, dummy)
    bias = _local_gather_sum(b, i_idx, i_val, lo, n_local, dummy)
    if not hp.no_user_bias:
        bias = bias + _local_gather_sum(b, u_idx, u_val, lo, n_local, dummy)
    return jax.lax.psum((p_u, p_i, bias), "model")


def _seg_sum(n, idx, val):
    """sum of val into bins idx — the one-hot form where the backend's
    capability row asks for it (ops/embed._use_onehot), .at[].add
    otherwise."""
    from ..ops.embed import _onehot, _use_onehot

    fidx = idx.reshape(-1)
    fval = val.reshape(-1)
    if _use_onehot(n):
        E = _onehot(fidx, n)
        return jnp.einsum("en,e->n", E, fval, precision=HIGHEST)
    return jnp.zeros((n,), jnp.float32).at[fidx].add(fval)


def _seg_sum_stacked(nseg, idx, pay):
    """Row-payload segment sum: pay [E, C] into [nseg, C] bins — ONE
    one-hot matmul in the one-hot form (stacking columns shares the
    one-hot read, the ops/embed._train_step_fused trick), segment_sum
    otherwise."""
    from ..ops.embed import _onehot, _use_onehot

    if _use_onehot(nseg):
        A = _onehot(idx, nseg)  # [E, nseg]
        return jnp.einsum("en,ec->nc", A, pay, precision=HIGHEST)
    return jax.ops.segment_sum(pay, idx, num_segments=nseg)


def _global_update_psum(g, batch, err, lr):
    """Replicated global-bias update: implicit damping with psum'd batch
    stats (matches ops/embed._update_global when the batch spans all data
    shards)."""
    n_g = g.shape[0]
    gS = _seg_sum(n_g, batch["g_idx"], err[:, None] * batch["g_val"])
    gC2 = _seg_sum(n_g, batch["g_idx"], batch["g_val"] * batch["g_val"])
    gS, gC2 = jax.lax.psum((gS, gC2), "data")
    return g + lr * gS / (1.0 + lr * gC2)


def _apply_row_updates(w, b, batch, lr_err, p_u, p_i, hp, lo, n_local, dummy):
    """All-gathered sparse updates, applied identically by every data
    replica of a model shard — comm is O(D*B*k) activations between
    devices, never O(N*k) table gradients.  Returns the updated local slabs."""
    u_idx, u_val = batch["u_idx"], batch["u_val"]
    i_idx, i_val = batch["i_idx"], batch["i_val"]
    lu_idx, lu_val = _local_ids(u_idx, u_val, lo, n_local, dummy)
    li_idx, li_val = _local_ids(i_idx, i_val, lo, n_local, dummy)
    coef_u = lr_err[:, None] * lu_val
    coef_i = lr_err[:, None] * li_val
    ag = lambda x: jax.lax.all_gather(x, "data")
    g_lu, g_li = ag(lu_idx), ag(li_idx)
    g_cu, g_ci = ag(coef_u), ag(coef_i)
    g_pu, g_pi = ag(p_u), ag(p_i)
    k = w.shape[1]
    D, B, Su = g_lu.shape
    Si = g_li.shape[2]
    # ops/embed._scatter_rows picks the form, same as the single-device
    # step (one-hot for slabs under the threshold where the backend's
    # capability row asks for it, .at[].add otherwise)
    from ..ops.embed import _scatter_rows, _scatter_vals

    w = _scatter_rows(w, g_lu.reshape(D * B, Su), g_cu.reshape(D * B, Su),
                      g_pi.reshape(D * B, k))
    w = _scatter_rows(w, g_li.reshape(D * B, Si), g_ci.reshape(D * B, Si),
                      g_pu.reshape(D * B, k))
    b = _scatter_vals(b, g_li.reshape(D * B, Si), g_ci.reshape(D * B, Si))
    if not hp.no_user_bias:
        b = _scatter_vals(b, g_lu.reshape(D * B, Su), g_cu.reshape(D * B, Su))
    return w, b


def _touch_counts_sharded(batch, lo, n_local):
    """(cu, ci) per-local-row touch counts, psum'd over data.  A touch is
    every occurrence of an owned index, value may be 0 (reference
    regularize() runs per index; ops/embed._touch_counts parity)."""
    out = []
    for seg in ("u", "i"):
        idx = batch[f"{seg}_idx"]
        loc = idx - lo
        own = (loc >= 0) & (loc < n_local)
        locc = jnp.where(own, loc, n_local - 1)
        # weight `own` keeps redirected (non-owned) ids from counting
        # against the last local row, which is a REAL row off-tail
        out.append(_seg_sum(n_local, locc, own.astype(jnp.float32)))
    return jax.lax.psum((out[0], out[1]), "data")


def _decay_clamp_scrub(w, b, g, batch, cu, ci, lr, consts, hp, lo, n_local, n_pad):
    """Eager per-row regularization (modes 0-3, via the single-device
    helper — rows are fully local under row sharding), global decay,
    bias decay, nonneg clamp, dummy-slot scrubs.

    The redirect slot (last local row) received only zero-coef adds but
    decay factors may have scaled it; it is scrubbed to exact zeros on the
    tail shard (the global dummy region), as is the replicated g dummy."""
    from ..ops.embed import _apply_factor_reg, _soft_threshold

    dummy = n_local - 1
    cg = _seg_sum(
        g.shape[0], batch["g_idx"], jnp.ones(batch["g_idx"].shape, jnp.float32)
    )
    cg = jax.lax.psum(cg, "data")
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
    if not hp.no_user_bias:
        fac_b = fac_b * jnp.power(1.0 - lr * consts.wd_user_bias, cu)
    b = b * fac_b
    if hp.user_nonnegative:
        w = jnp.where((cu > 0)[:, None], jnp.maximum(w, 0.0), w)
    if hp.item_nonnegative:
        w = jnp.where((ci > 0)[:, None], jnp.maximum(w, 0.0), w)
    is_tail = lo + dummy >= n_pad - 1
    w = w.at[dummy].set(jnp.where(is_tail, 0.0, w[dummy]))
    b = b.at[dummy].set(jnp.where(is_tail, 0.0, b[dummy]))
    g = g.at[-1].set(0.0)
    return w, b, g


def _count_present(batch):
    return jax.lax.psum(
        jnp.sum(batch["weight"] > 0).astype(jnp.int32), "data"
    )


def _lazy_catchup_sharded(w, g, ref_ui, ref_g, batch, cu, ci, step0, lr, consts, hp):
    """Lazy-decay catch-up (reg modes >= 4) on the local slab + replicated
    globals — rows are fully local under row sharding, so this is the
    sharded form of ops/embed._lazy_catchup (apex_svd_base.h:188-310
    catch-up factors applied per touched index).  Shared by the base and
    SVD++ sharded step bodies."""
    from ..ops.embed import _soft_threshold

    if hp.reg_method >= 4:
        elapsed = (step0 - ref_ui).astype(jnp.float32)
        touched = (cu + ci) > 0
        k_ui = jnp.where(touched, elapsed, 0.0)
        lam = lr * jnp.where(cu > 0, consts.wd_u_row, consts.wd_i_row)
        if hp.reg_method == 4:
            w = w * jnp.power(1.0 - lam, k_ui)[:, None]
        else:
            w = _soft_threshold(w, (lam * k_ui)[:, None])
        ref_ui = jnp.where(touched, step0, ref_ui)
    if hp.reg_global >= 4:
        cg = _seg_sum(
            g.shape[0], batch["g_idx"],
            jnp.ones(batch["g_idx"].shape, jnp.float32),
        )
        cg = jax.lax.psum(cg, "data")
        elapsed_g = (step0 - ref_g).astype(jnp.float32)
        kg = jnp.where(cg > 0, elapsed_g, 0.0)
        lam_g = lr * consts.wd_g_row
        if hp.reg_global == 4:
            g = g * jnp.power(1.0 - lam_g, kg)
        else:
            g = _soft_threshold(g, lam_g * kg)
        ref_g = jnp.where(cg > 0, step0, ref_g)
    return w, g, ref_ui, ref_g


def _make_step_body(hp: HyperParams, n_pad: int, n_model: int):
    """The raw per-shard step body (state, batch, lr, consts) -> state.

    The local dummy row of each shard is its last local row only for the
    final shard; we instead keep ONE global dummy region (the padded tail
    rows of the last shard) and redirect non-owned ids to a per-shard
    scratch row — implemented by appending one extra scratch row to each
    local slab via index clamping into the local dummy slot (n_local-1 of
    the padded tail).

    Simplification used here: the *global* dummy/padding rows live in the
    padded tail; each shard redirects non-owned ids to its local copy of
    row (n_local-1) **only for gathers where the value is simultaneously
    zeroed**, so the redirect target's contents are irrelevant; for
    scatters the zero coefficient makes the add a no-op.
    """
    n_local = n_pad // n_model

    def step(state: TrainState, batch, lr, consts: TrainConsts):
        # local shards
        w, b, g = state.w, state.b, state.g  # w:[n_local,k] b:[n_local]
        lo = jax.lax.axis_index("model") * n_local
        dummy = n_local - 1  # local redirect slot (values zeroed on use)
        step0 = state.step
        ref_ui, ref_g = state.ref_ui, state.ref_g  # ref_ui local [n_local]
        cu, ci = _touch_counts_sharded(batch, lo, n_local)

        # ---- lazy-decay catch-up (reg >= 4) BEFORE the gradient, on the
        # local slab (rows are fully local; mirrors ops/embed.train_step)
        w, g, ref_ui, ref_g = _lazy_catchup_sharded(
            w, g, ref_ui, ref_g, batch, cu, ci, step0, lr, consts, hp
        )

        # ---- forward: masked local gathers, psum over model
        p_u, p_i, bias = _sharded_forward(w, b, batch, hp, lo, n_local, dummy)
        score = hp.base_score + bias + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
        score = score + jnp.einsum(
            "bs,bs->b", batch["g_val"], g[batch["g_idx"]], precision=HIGHEST)  # g replicated
        pred = losses.map_active(score, hp.active_type)
        err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

        # ---- all-gathered sparse updates + damped global update
        w, b = _apply_row_updates(
            w, b, batch, lr * err, p_u, p_i, hp, lo, n_local, dummy
        )
        g = _global_update_psum(g, batch, err, lr)

        # ---- decay / clamp / scrub
        w, b, g = _decay_clamp_scrub(
            w, b, g, batch, cu, ci, lr, consts, hp, lo, n_local, n_pad
        )

        nstep = step0 + _count_present(batch)
        return TrainState(
            w=w, b=b, g=g, step=nstep, ref_ui=ref_ui, ref_g=ref_g
        )

    return step


def _specs():
    state_spec = TrainState(
        w=P("model", None),
        b=P("model"),
        g=P(),
        step=P(),
        ref_ui=P("model"),
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
    return state_spec, batch_spec, consts_spec


def sharded_train_step(mesh: Mesh, hp: HyperParams, n_pad: int):
    """Build the shard_map'd batched train step.

    Signature: (state, batch, lr, consts) -> state, with state tables
    row-sharded over ``model`` and the batch sharded over ``data``.
    """
    from jax import shard_map

    step = _make_step_body(hp, n_pad, mesh.shape["model"])
    state_spec, batch_spec, consts_spec = _specs()
    # check_vma=False: the static replication checker cannot infer that the
    # all-gathered sparse updates leave w/b identical across the data axis
    # (they do — the gathered tuples are the same on every data shard).
    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(state_spec, batch_spec, P(), consts_spec),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def sharded_train_rounds(mesh: Mesh, hp: HyperParams, n_pad: int):
    """Whole multi-round run in ONE dispatch on the mesh.

    Signature: (state, stacked, lrs, consts) -> state where ``stacked`` is
    the epoch batch pytree with leading [T, B, ...] dims (B sharded over
    ``data``) and ``lrs`` is the per-round learning-rate array [R].  The
    round/batch double scan runs *inside* shard_map so the collectives are
    compiled once and no host round-trips occur between batches — the
    multi-chip analogue of ops/embed.train_rounds.
    """
    from jax import shard_map

    step = _make_step_body(hp, n_pad, mesh.shape["model"])
    state_spec, batch_spec, consts_spec = _specs()

    def run(state: TrainState, stacked, lrs, consts: TrainConsts):
        def round_body(st, lr):
            def batch_body(s, batch):
                return step(s, batch, lr, consts), None

            st, _ = jax.lax.scan(batch_body, st, stacked)
            return st, None

        state, _ = jax.lax.scan(round_body, state, lrs)
        return state

    stacked_spec = {
        k: (P(None, "data") if k in ("label", "weight") else P(None, "data", None))
        for k in (
            "label", "weight", "g_idx", "g_val", "u_idx", "u_val", "i_idx", "i_val"
        )
    }
    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(state_spec, stacked_spec, P(), consts_spec),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def sharded_predict(mesh: Mesh, hp: HyperParams, n_pad: int):
    """Batched inference ON the mesh: tables stay row-sharded.

    Each data shard scores its slice of every [T, B] batch with masked
    local gathers psum'd over ``model`` (reference predict semantics,
    apex_svd_base.h:445-454 via ops/embed.forward_scores); predictions
    come back sharded over ``data``.  Replaces the copy-the-table-to-one-
    device eval path, which contradicted row sharding at the scale that
    motivates it.

    Signature: (state, stacked) -> pred [T, B].
    """
    from jax import shard_map

    n_local = n_pad // mesh.shape["model"]
    state_spec, _, _ = _specs()

    def run(state: TrainState, stacked):
        w, b, g = state.w, state.b, state.g
        lo = jax.lax.axis_index("model") * n_local
        dummy = n_local - 1

        def body(_, batch):
            p_u, p_i, bias = _sharded_forward(w, b, batch, hp, lo, n_local, dummy)
            # g is replicated: full local gather, no psum
            g_term = jnp.einsum(
                "bs,bs->b", batch["g_val"], g[batch["g_idx"]], precision=HIGHEST)
            score = hp.base_score + g_term + bias
            score = score + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
            return None, losses.map_active(score, hp.active_type)

        _, preds = jax.lax.scan(body, None, stacked)
        return preds

    stacked_spec = {
        k: (P(None, "data") if k in ("label", "weight") else P(None, "data", None))
        for k in (
            "label", "weight", "g_idx", "g_val", "u_idx", "u_val", "i_idx", "i_val"
        )
    }
    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(state_spec, stacked_spec),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    return jax.jit(fn)
