"""Fused batched train step: gather -> weighted-sum -> dot -> scatter-add.

This is the batched JAX re-expression of the reference's per-example SGD
inner loop (SVDFeature::update_inner, solvers/base-solver/
apex_svd_base.h:456-462, with pred :445-454, calc_bias :313-353,
prepare_tmp :354-381, update_no_decay :383-427 and the regularization
modes :188-310).  One call processes a whole batch:

  1. p_u[b] = sum_s u_val[b,s] * W[u_idx[b,s]]      (prepare_tmp)
     p_i[b] = sum_s i_val[b,s] * W[i_idx[b,s]]
  2. score = base + <g_val, g[g_idx]> + <u_val, b[u_idx]> + <i_val, b[i_idx]>
             + dot(p_u, p_i)                         (pred)
  3. err = cal_grad(label, act(score)) * weight      (cal_grad)
  4. scatter-add:  W[u_idx] += lr*err*u_val * p_i    (update_no_decay)
                   W[i_idx] += lr*err*i_val * p_u
                   b[u_idx] += lr*err*u_val ; b[i_idx] += lr*err*i_val
                   g[g_idx] += lr*err*g_val
  5. weight decay on touched rows with multiplicity:
     a row touched c times in the batch decays by (1-lr*wd)^c, the batched
     equivalent of the reference's decay-per-touch.

Batched-SGD semantics note: within a batch every example reads the same
pre-update parameters and duplicate-row gradients sum (hogwild-equivalent);
with batch_size=1 the math reduces exactly to the reference's sequential
update.  Metric parity on the reference demos is the contract (SURVEY.md §7).

All regularization modes of the reference are implemented:
  0 L2, 1 L1 (soft-threshold), 2 L2-ball projection, 3 L1-pre,
  4 lazy L2, 5 lazy L1 (catch-up by elapsed sample counter,
  apex_svd_base.h:188-310).  Lazy modes carry per-row last-touch step
  counters in TrainState.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .. import backend, losses

# Every f32 matrix product of the training path runs at full f32
# precision: on the GPU the default precision of an f32 dot is TF32
# (about three decimal digits), which would move the trained factors
# off the reference trajectory.  The products here are small (k=64
# contractions or one-hot selectors), so the tensor cores buy nothing.
HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


@dataclasses.dataclass(unsafe_hash=True)
class HyperParams:
    """Static (trace-time) switches of the train step."""

    active_type: int = 0
    no_user_bias: int = 0
    reg_method: int = 0
    reg_global: int = 0
    user_nonnegative: int = 0
    item_nonnegative: int = 0
    base_score: float = 0.0
    # svd++ block fields filled by the svdpp solver
    svdpp: bool = False
    # plain (undamped) global-bias update — exact reference semantics
    # (apex_svd_base.h:384-387); selected at batch_size=1 where the
    # batched divergence risk the damping guards against cannot occur
    exact_global: bool = False
    # route to the sorted-dedup large-table step (ops/big_embed.py);
    # set by the solver when the table exceeds ONEHOT_THRESHOLD.
    # num_factor carries k (the augmented rows are wider than k)
    big_table: bool = False
    num_factor: int = 0


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainConsts:
    """Per-row decay-rate tables (traced constants, built once).

    Row tables cover the unified space [N+1] (dummy row decays by 0).
    wd_u_row applies to rows touched via the user segment, wd_i_row via the
    item segment — distinct rows in practice, aliased under
    common_latent_space where both factors apply, as in the reference.
    """

    wd_u_row: jax.Array  # [N+1]
    wd_i_row: jax.Array  # [N+1]
    wd_g_row: jax.Array  # [G+1] (0 for regfree-global and dummy)
    wd_user_bias: jax.Array  # scalar
    wd_item_bias: jax.Array  # scalar


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
    w: jax.Array  # [N+1, k] (last row = dummy, stays 0)
    b: jax.Array  # [N+1]
    g: jax.Array  # [G+1]
    step: jax.Array  # scalar i32: examples processed (sample_counter)
    # lazy-decay last-touch counters (reg_method/reg_global >= 4), else size-0
    ref_ui: jax.Array  # [N+1] i32
    ref_g: jax.Array  # [G+1] i32


def _use_onehot(n: int) -> bool:
    """One-hot matmul form for a table of n rows: a row of the backend
    capability table (svdfeature_tpu/backend.py), only ever for tables
    up to ONEHOT_THRESHOLD rows."""
    return n <= ONEHOT_THRESHOLD and backend.capabilities().onehot_scatter


def _gather_sum(tab: jax.Array, idx: jax.Array, val: jax.Array) -> jax.Array:
    """sum_s val[b,s] * tab[idx[b,s]] -> [B, k]  (tab 2D) or [B] (tab 1D).

    In the one-hot form XLA CSE shares the one-hot operand with the
    scatter side of the step."""
    n = tab.shape[0]
    if _use_onehot(n):
        if idx.shape[1] == 1:
            E = _onehot(idx[:, 0], n)
            if tab.ndim == 2:
                return val[:, 0, None] * jnp.einsum(
                    "bn,nk->bk", E, tab, precision=HIGHEST
                )
            return val[:, 0] * jnp.einsum("bn,n->b", E, tab, precision=HIGHEST)
        M = _onehot_weighted(idx, val, n)  # [B, n]
        if tab.ndim == 2:
            return jnp.einsum("bn,nk->bk", M, tab, precision=HIGHEST)
        return jnp.einsum("bn,n->b", M, tab, precision=HIGHEST)
    rows = tab[idx]  # [B, S, k] or [B, S]
    if tab.ndim == 2:
        return jnp.einsum("bs,bsk->bk", val, rows, precision=HIGHEST)
    return jnp.einsum("bs,bs->b", val, rows, precision=HIGHEST)


def forward_scores(
    state: TrainState,
    batch,
    hp: HyperParams,
    p_u_extra: Optional[jax.Array] = None,
    bias_extra: Optional[jax.Array] = None,
    bias_plugin: Optional[jax.Array] = None,
):
    """Raw + activated predictions for a batch.

    p_u_extra/bias_extra inject the SVD++ feedback term (prepare_svdpp /
    get_bias_svdpp, apex_svd_base.h:429-437); bias_plugin injects solver
    plugin bias (get_bias_plugin :436-438, outside the no_user_bias gate).
    Returns (pred, p_u, p_i).
    """
    p_u = _gather_sum(state.w, batch["u_idx"], batch["u_val"])
    p_i = _gather_sum(state.w, batch["i_idx"], batch["i_val"])
    if p_u_extra is not None:
        p_u = p_u + p_u_extra
    score = hp.base_score + _gather_sum(state.g, batch["g_idx"], batch["g_val"])
    if bias_plugin is not None:
        score = score + bias_plugin
    score = score + _gather_sum(state.b, batch["i_idx"], batch["i_val"])
    if not hp.no_user_bias:
        score = score + _gather_sum(state.b, batch["u_idx"], batch["u_val"])
        if bias_extra is not None:
            score = score + bias_extra
    score = score + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
    pred = losses.map_active(score, hp.active_type)
    return pred, p_u, p_i


def _scatter_rows(tab, idx, coef, vecs):
    """tab[idx[b,s]] += coef[b,s] * vecs[b]  (2D tab)."""
    n = tab.shape[0]
    if _use_onehot(n):
        if idx.shape[1] == 1:
            E = _onehot(idx[:, 0], n)
            return tab + jnp.einsum(
                "bn,bk->nk", E, coef[:, 0, None] * vecs,
                precision=HIGHEST,
            )
        M = _onehot_weighted(idx, coef, n)  # [B, n]
        return tab + jnp.einsum(
            "bn,bk->nk", M, vecs, precision=HIGHEST
        )
    B, S = idx.shape
    upd = coef[..., None] * vecs[:, None, :]  # [B, S, k]
    return tab.at[idx.reshape(-1)].add(upd.reshape(B * S, -1))


def _scatter_vals(tab, idx, coef):
    n = tab.shape[0]
    if _use_onehot(n):
        if idx.shape[1] == 1:
            E = _onehot(idx[:, 0], n)
            return tab + jnp.einsum(
                "bn,b->n", E, coef[:, 0], precision=HIGHEST
            )
        M = _onehot_weighted(idx, coef, n)  # [B, n]
        return tab + M.sum(axis=0)
    return tab.at[idx.reshape(-1)].add(coef.reshape(-1))


def _update_global(g, g_idx, g_val, err, lr, exact: bool = False):
    """Global-bias update.

    ``exact`` (batch_size=1): the reference's plain step
    ``g += lr*err*v`` (update_no_decay, apex_svd_base.h:384-387).

    Batched: implicit (proximal) damping.  Global features can be nearly
    dense (e.g. the neighborhood demo's popularity buckets appear in ~60%
    of examples), so a batch sums hundreds of same-direction gradients
    that the reference's sequential loop would have damped one by one —
    the plain scatter-add diverges.  The implicit-SGD step
    dg = lr * S / (1 + lr * sum v^2) approaches the within-batch
    least-squares fixed point sequential SGD converges to.  This is a
    documented deviation of the batched path (COMPONENTS.md row 6).
    """
    n_g = g.shape[0]
    S = jnp.zeros((n_g,), jnp.float32).at[g_idx.reshape(-1)].add(
        (err[:, None] * g_val).reshape(-1)
    )
    if exact:
        return g + lr * S
    C2 = jnp.zeros((n_g,), jnp.float32).at[g_idx.reshape(-1)].add(
        (g_val * g_val).reshape(-1)
    )
    return g + lr * S / (1.0 + lr * C2)


def _touch_counts(n, idx):
    if _use_onehot(n):
        if idx.shape[1] == 1:
            return _onehot(idx[:, 0], n).astype(jnp.float32).sum(axis=0)
        ones = jnp.ones(idx.shape, jnp.float32)
        return _onehot_weighted(idx, ones, n).sum(axis=0)
    return jnp.zeros((n,), jnp.float32).at[idx.reshape(-1)].add(1.0)


# Above this row count the per-step decay switches from a dense O(N*k)
# multiply to the sparse touched-rows-only path (identical math).
SPARSE_DECAY_THRESHOLD = 1 << 18

# Up to this table size a backend whose capability row asks for it
# (backend.Capabilities.onehot_scatter) runs gathers and scatter-adds as
# [B, N] one-hot matmuls instead of XLA gathers and scatters; above it
# the solvers take the sorted-dedup big-table path (ops/big_embed.py).
ONEHOT_THRESHOLD = 1 << 13


def _onehot(idx2d, n):
    """Unweighted one-hot [B, n] of a [B] index column; identical
    subexpressions are CSE-shared across the gather/scatter/count uses of
    a step.  bf16 is exact for 0/1 and halves the HBM traffic."""
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
    return (idx2d[:, None] == iota).astype(jnp.bfloat16)


def _onehot_weighted(idx, val, n):
    """[B, n] matrix M with M[b, r] = sum_s val[b,s] * [idx[b,s] == r]."""
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, n), 2)
    eq = (idx[:, :, None] == iota).astype(jnp.float32)  # [B, S, n]
    return jnp.einsum("bsn,bs->bn", eq, val, precision=HIGHEST)


def _onehot_counts(idx, n):
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, n), 2)
    eq = (idx[:, :, None] == iota).astype(jnp.float32)
    return eq.sum(axis=(0, 1)), eq.sum(axis=1)  # [n] counts, [B, n] indicator


def _sparse_decay_rows(w, idx, counts, wd_row, lr, l1: bool):
    """Apply (1-lr*wd)^c decay (or L1 soft-threshold with lr*wd*c) to
    exactly the rows touched by ``idx``, via gather -> delta/c -> scatter.

    Each of a row's c occurrences contributes delta/c, so duplicates sum to
    the exact closed form; rows with wd=0 (incl. the dummy) get delta 0.
    """
    flat = idx.reshape(-1)
    c = counts[flat]  # >= 1 for every appearing entry
    rows = w[flat]  # post-update values
    lam = (lr * wd_row[flat])[:, None] if w.ndim == 2 else lr * wd_row[flat]
    if w.ndim == 2:
        cb = c[:, None]
        if l1:
            new = jnp.sign(rows) * jnp.maximum(jnp.abs(rows) - lam * cb, 0.0)
        else:
            new = rows * jnp.power(1.0 - lam, cb)
        return w.at[flat].add((new - rows) / cb)
    if l1:
        new = jnp.sign(rows) * jnp.maximum(jnp.abs(rows) - lam * c, 0.0)
    else:
        new = rows * jnp.power(1.0 - lam, c)
    return w.at[flat].add((new - rows) / c)


def _sparse_decay_scalar(b, idx, counts, wd_scalar, lr):
    """Scalar-rate L2 decay on touched entries of a 1-D table."""
    flat = idx.reshape(-1)
    c = counts[flat]
    rows = b[flat]
    new = rows * jnp.power(1.0 - lr * wd_scalar, c)
    return b.at[flat].add((new - rows) / c)


def _sparse_clamp_nonneg(w, idx, counts):
    """max(w, 0) on touched rows via delta/c scatter."""
    flat = idx.reshape(-1)
    c = counts[flat][:, None]
    rows = w[flat]
    return w.at[flat].add((jnp.maximum(rows, 0.0) - rows) / c)


def _soft_threshold(w, lam):
    """regularize_L1 (apex-tensor func_decl_common.h): shrink toward 0."""
    return jnp.sign(w) * jnp.maximum(jnp.abs(w) - lam, 0.0)


def _apply_factor_reg(
    w, cu, ci, lr, consts: TrainConsts, hp: HyperParams, uidx=None, iidx=None
):
    """Eager latent-factor regularization (reg_method 0-3) on touched rows.

    When the table is large and the touching index arrays are provided,
    modes 0/1 use the sparse touched-rows path (u-decay then i-decay
    sequentially — exact for rows in both segments too, since the second
    gather sees the first application).
    """
    m = hp.reg_method
    sparse = (
        w.shape[0] > SPARSE_DECAY_THRESHOLD
        and uidx is not None
        and m in (0, 1)
    )
    if sparse:
        w = _sparse_decay_rows(w, uidx, cu, consts.wd_u_row, lr, l1=(m == 1))
        w = _sparse_decay_rows(w, iidx, ci, consts.wd_i_row, lr, l1=(m == 1))
        return w
    lam_u = lr * consts.wd_u_row
    lam_i = lr * consts.wd_i_row
    if m == 0:
        fac = jnp.power(1.0 - lam_u, cu) * jnp.power(1.0 - lam_i, ci)
        return w * fac[:, None]
    if m == 1:
        # L1 soft-threshold; threshold compounds with touch count
        lam = lam_u * cu + lam_i * ci
        return _soft_threshold(w, lam[:, None])
    if m == 2:
        # project rows onto the L2 ball of radius sqrt(wd) (apex_svd_base.h:181-186)
        # applied once per touch; projection is idempotent so multiplicity
        # does not matter
        touched = (cu + ci) > 0
        wd_row = jnp.where(cu > 0, consts.wd_u_row, consts.wd_i_row)
        sq = jnp.sum(w * w, axis=1)
        scale = jnp.where(
            touched & (sq > wd_row), jnp.sqrt(wd_row / jnp.maximum(sq, 1e-30)), 1.0
        )
        return w * scale[:, None]
    if m == 3:
        # reference mode 3: L1 for user rows (falls through case 1 in
        # reg_user), L2 for item rows (falls through case 0 in reg_item)
        w = _soft_threshold(w, (lam_u * cu)[:, None])
        fac = jnp.power(1.0 - lam_i, ci)
        return w * fac[:, None]
    raise ValueError(f"unknown reg_method {m}")


def _train_step_fused(
    state, batch, lr, consts, hp: HyperParams,
    p_u_extra=None, bias_extra=None, return_err_pi=False,
):
    """Hot-path step: small table, single-feature u/i segments, eager L2.

    Semantics = train_step (pred apex_svd_base.h:445-454, update_no_decay
    :383-427, eager regularize :188-283, nonneg clamp :242-245), in the
    HBM-traffic-minimal one-hot form: the [B, N] one-hot of each segment
    is read EXACTLY ONCE — the w-update, b-update and touch count are
    stacked into one [B, k+2] payload applied by a single E^T matmul per
    segment (f32 accumulation).  Forward reads use native row gathers.

    p_u_extra/bias_extra inject the SVD++ feedback term (same contract as
    forward_scores); return_err_pi additionally returns (err, p_i) for the
    SVD++ feedback recurrence (ops/svdpp._row_update).
    """
    w, b, g = state.w, state.b, state.g
    n_ui, k = w.shape
    u_idx, i_idx, g_idx = batch["u_idx"][:, 0], batch["i_idx"][:, 0], batch["g_idx"]
    u_val, i_val = batch["u_val"][:, 0], batch["i_val"][:, 0]
    B = u_idx.shape[0]

    # ---- forward: native row gathers
    p_u = u_val[:, None] * w[u_idx]
    if p_u_extra is not None:
        p_u = p_u + p_u_extra
    p_i = i_val[:, None] * w[i_idx]
    score = hp.base_score + _gather_sum(g, g_idx, batch["g_val"])
    score = score + i_val * b[i_idx]
    if not hp.no_user_bias:
        score = score + u_val * b[u_idx]
        if bias_extra is not None:
            score = score + bias_extra
    score = score + jnp.einsum("bk,bk->b", p_u, p_i, precision=HIGHEST)
    pred = losses.map_active(score, hp.active_type)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    lr_err = lr * err

    g = _update_global(g, g_idx, batch["g_val"], err, lr, hp.exact_global)
    cg = _touch_counts(g.shape[0], g_idx)

    # ---- fused scatter: [dw | db | count] per segment in one matmul
    coef_u = lr_err * u_val
    coef_i = lr_err * i_val
    Eu = _onehot(u_idx, n_ui)
    Ei = _onehot(i_idx, n_ui)
    ones = jnp.ones((B, 1), jnp.float32)
    pay_u = jnp.concatenate([coef_u[:, None] * p_i, coef_u[:, None], ones], axis=1)
    pay_i = jnp.concatenate([coef_i[:, None] * p_u, coef_i[:, None], ones], axis=1)
    out_u = jnp.einsum("bn,bc->nc", Eu, pay_u, precision=HIGHEST)
    out_i = jnp.einsum("bn,bc->nc", Ei, pay_i, precision=HIGHEST)
    cu = out_u[:, k + 1]
    ci = out_i[:, k + 1]
    w = w + out_u[:, :k] + out_i[:, :k]
    b = b + out_i[:, k]
    if not hp.no_user_bias:
        b = b + out_u[:, k]

    # ---- eager L2 decay (reg_method 0 / reg_global 0)
    fac = jnp.power(1.0 - lr * consts.wd_u_row, cu) * jnp.power(
        1.0 - lr * consts.wd_i_row, ci
    )
    w = w * fac[:, None]
    g = g * jnp.power(1.0 - lr * consts.wd_g_row, cg)
    fac_b = jnp.power(1.0 - lr * consts.wd_item_bias, ci)
    if not hp.no_user_bias:
        fac_b = fac_b * jnp.power(1.0 - lr * consts.wd_user_bias, cu)
    b = b * fac_b

    if hp.user_nonnegative:
        w = jnp.where((cu > 0)[:, None], jnp.maximum(w, 0.0), w)
    if hp.item_nonnegative:
        w = jnp.where((ci > 0)[:, None], jnp.maximum(w, 0.0), w)

    w = w.at[-1].set(0.0)
    b = b.at[-1].set(0.0)
    g = g.at[-1].set(0.0)
    nstep = state.step + jnp.sum(batch["weight"] > 0).astype(jnp.int32)
    new_state = TrainState(
        w=w, b=b, g=g, step=nstep, ref_ui=state.ref_ui, ref_g=state.ref_g
    )
    if return_err_pi:
        return new_state, err, p_i
    return new_state


def _can_fuse(hp: HyperParams, batch, n_ui: int) -> bool:
    return (
        _use_onehot(n_ui)
        and hp.reg_method == 0
        and hp.reg_global == 0
        and batch["u_idx"].shape[1] == 1
        and batch["i_idx"].shape[1] == 1
    )


def _lazy_catchup(state, cu, ci, cg, lr, consts, hp) -> TrainState:
    """Lazy-decay catch-up (reg modes 4/5) on touched rows BEFORE the
    gradient — regularize(pre), apex_svd_base.h:457,188-310.

    Note: the reference computes k = ref - sample_counter on unsigned ints
    (apex_svd_base.h:195,226,266), which wraps to ~2^32 and zeroes the row
    at first catch-up whenever wd>0 — an evident sign bug.  We implement
    the intended semantics, k = sample_counter - ref >= 0.

    Shared by the base step and the SVD++ row updates (feedback pool rows
    are never caught up: the reference regularizes only the example's
    u/i/g feature ids in update_inner :456-462, and prepare_ufeedback
    :523-538 reads the W rows raw).  Returns the state with w/g decayed
    and refs stamped; the dummy ref is pinned to 0 (parity with the
    big-table path, which lands duplicate writes there)."""
    if hp.reg_method < 4 and hp.reg_global < 4:
        return state
    w, g = state.w, state.g
    step0 = state.step
    ref_ui, ref_g = state.ref_ui, state.ref_g
    if hp.reg_method >= 4:
        elapsed = (step0 - ref_ui).astype(jnp.float32)
        touched = (cu + ci) > 0
        k_ui = jnp.where(touched, elapsed, 0.0)
        lam = lr * jnp.where(cu > 0, consts.wd_u_row, consts.wd_i_row)
        if hp.reg_method == 4:
            w = w * jnp.power(1.0 - lam, k_ui)[:, None]
        else:
            w = _soft_threshold(w, (lam * k_ui)[:, None])
        ref_ui = jnp.where(touched, step0, ref_ui).at[-1].set(0)
    if hp.reg_global >= 4:
        elapsed_g = (step0 - ref_g).astype(jnp.float32)
        kg = jnp.where(cg > 0, elapsed_g, 0.0)
        lam_g = lr * consts.wd_g_row
        if hp.reg_global == 4:
            g = g * jnp.power(1.0 - lam_g, kg)
        else:
            g = _soft_threshold(g, lam_g * kg)
        ref_g = jnp.where(cg > 0, step0, ref_g)
    return dataclasses.replace(state, w=w, g=g, ref_ui=ref_ui, ref_g=ref_g)


@partial(jax.jit, static_argnames=("hp",), donate_argnames=("state",))
def train_step(
    state: TrainState,
    batch,
    lr: jax.Array,
    consts: TrainConsts,
    hp: HyperParams,
) -> TrainState:
    """One batched SGD step (random-order format)."""
    w, b, g = state.w, state.b, state.g
    n_ui = w.shape[0]
    if hp.big_table:
        from .big_embed import train_step_big

        return train_step_big.__wrapped__(state, batch, lr, consts, hp)
    if _can_fuse(hp, batch, n_ui):
        return _train_step_fused(state, batch, lr, consts, hp)
    n_g = g.shape[0]
    u_idx, i_idx, g_idx = batch["u_idx"], batch["i_idx"], batch["g_idx"]

    cu = _touch_counts(n_ui, u_idx)
    ci = _touch_counts(n_ui, i_idx)
    cg = _touch_counts(n_g, g_idx)

    state = _lazy_catchup(state, cu, ci, cg, lr, consts, hp)
    w, g = state.w, state.g
    step0 = state.step
    ref_ui, ref_g = state.ref_ui, state.ref_g

    # --- forward on pre-update parameters
    pred, p_u, p_i = forward_scores(state, batch, hp)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    lr_err = lr * err  # [B]

    # --- scatter-add gradient (update_no_decay, apex_svd_base.h:383-427)
    g = _update_global(g, g_idx, batch["g_val"], err, lr, hp.exact_global)
    coef_u = lr_err[:, None] * batch["u_val"]  # [B, Su]
    coef_i = lr_err[:, None] * batch["i_val"]
    w = _scatter_rows(w, u_idx, coef_u, p_i)
    w = _scatter_rows(w, i_idx, coef_i, p_u)
    b = _scatter_vals(b, i_idx, coef_i)
    if not hp.no_user_bias:
        b = _scatter_vals(b, u_idx, coef_u)

    # --- eager regularization (regularize(post)); multiplicity-compounded
    big = n_ui > SPARSE_DECAY_THRESHOLD
    if hp.reg_method < 4:
        w = _apply_factor_reg(w, cu, ci, lr, consts, hp, u_idx, i_idx)
    if hp.reg_global < 4:
        if hp.reg_global == 0:
            g = g * jnp.power(1.0 - lr * consts.wd_g_row, cg)
        elif hp.reg_global == 1:
            g = _soft_threshold(g, lr * consts.wd_g_row * cg)
        else:
            raise ValueError(f"unknown global decay method {hp.reg_global}")

    # bias decay: always plain L2 per touch (apex_svd_base.h:246-249, 281-283)
    if big:
        b = _sparse_decay_scalar(b, i_idx, ci, consts.wd_item_bias, lr)
        if not hp.no_user_bias:
            b = _sparse_decay_scalar(b, u_idx, cu, consts.wd_user_bias, lr)
    else:
        fac_b = jnp.power(1.0 - lr * consts.wd_item_bias, ci)
        if not hp.no_user_bias:
            fac_b = fac_b * jnp.power(1.0 - lr * consts.wd_user_bias, cu)
        b = b * fac_b

    # nonnegativity clamp on touched rows (apex_svd_base.h:242-245)
    if hp.user_nonnegative:
        w = _sparse_clamp_nonneg(w, u_idx, cu) if big else jnp.where(
            (cu > 0)[:, None], jnp.maximum(w, 0.0), w
        )
    if hp.item_nonnegative:
        w = _sparse_clamp_nonneg(w, i_idx, ci) if big else jnp.where(
            (ci > 0)[:, None], jnp.maximum(w, 0.0), w
        )

    # keep dummy rows clean (padding targets)
    w = w.at[-1].set(0.0)
    b = b.at[-1].set(0.0)
    g = g.at[-1].set(0.0)

    nstep = step0 + jnp.sum(batch["weight"] > 0).astype(jnp.int32)
    return TrainState(w=w, b=b, g=g, step=nstep, ref_ui=ref_ui, ref_g=ref_g)


@partial(jax.jit, static_argnames=("hp",), donate_argnames=("state",))
def train_epoch(
    state: TrainState,
    stacked,
    lr: jax.Array,
    consts: TrainConsts,
    hp: HyperParams,
) -> TrainState:
    """Scan the fused step over all batches of an epoch on-device.

    One dispatch per epoch: the whole round runs without host round-trips
    (the reference's producer-thread double-buffering, apex_buffer_loader.h,
    becomes 'stage the epoch once, scan').
    """

    def body(st, batch):
        return train_step.__wrapped__(st, batch, lr, consts, hp), None

    state, _ = jax.lax.scan(body, state, stacked)
    return state


@partial(jax.jit, static_argnames=("hp",), donate_argnames=("state",))
def train_rounds(
    state: TrainState,
    stacked,
    lrs: jax.Array,  # [R] per-round learning rates
    consts: TrainConsts,
    hp: HyperParams,
) -> TrainState:
    """Run multiple full rounds in ONE device dispatch: an outer scan over
    the per-round learning-rate schedule, an inner scan over the epoch's
    batches.  Removes all host round-trips from multi-round training."""

    def round_body(st, lr):
        def body(s, batch):
            return train_step.__wrapped__(s, batch, lr, consts, hp), None

        st, _ = jax.lax.scan(body, st, stacked)
        return st, None

    state, _ = jax.lax.scan(round_body, state, lrs)
    return state


@partial(jax.jit, static_argnames=("hp",))
def predict_batches(state: TrainState, stacked, hp: HyperParams):
    """Forward-only predictions for stacked batches -> [T, B]."""

    def body(_, batch):
        pred, _, _ = forward_scores(state, batch, hp)
        return None, pred

    _, preds = jax.lax.scan(body, None, stacked)
    return preds
