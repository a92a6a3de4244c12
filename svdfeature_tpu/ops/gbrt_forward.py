"""Device-side GBRT forward: the whole boosted model in one XLA dispatch.

Reference semantics: the per-row scalar walk ``RTreeTrainer::predict`` /
``get_leaf_id`` (apex_reg_tree.cpp:771-792) inside the per-tree sum of
``GBRTTrainer::forward`` (apex_gbrt.h:601-657).  The reference walks one
node at a time per example on the CPU; the device re-design is
level-synchronous and fully batched:

* all trees are padded to a common node count and stacked into [T, M]
  node arrays (leaf iff left == -1, leaf value in ``split_value``);
* a ``lax.while_loop`` advances every (tree, row) walker one level per
  iteration until all walkers sit on leaves — data-dependent depth with
  a single compiled program, no per-depth recompilation;
* the sparse feature lookup (``FMatrixS`` row ∪ fcommon view in the
  reference) is a vectorized ``searchsorted`` over the dataset's
  row-sorted ``row*(nfeat+1)+findex`` key array — missing features
  follow the node's packed default direction, exactly like the
  NaN-trick unknowns in apex_reg_tree.h:68-74;
* the boosted sum ``base + Σ_t w_t · leaf_t`` is one weighted
  reduction over the [T, R] leaf-value matrix.

Padding buckets (T to a multiple of 8, M to a power of two) keep the
number of distinct compiled shapes logarithmic when an eval sweep walks
a sequence of model snapshots of growing size.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

_INT32_MAX = np.int64(2**31 - 1)


def stack_trees(trees: Sequence) -> dict:
    """Stack RTree node lists into padded [T, M] arrays.

    Padding nodes are leaves with value 0 (left == -1), so padded trees
    contribute exactly 0 and padded node slots are never walked into.
    """
    T = len(trees)
    Tp = max(8, -(-T // 8) * 8)
    M = max(max(t.num_nodes for t in trees), 2)
    Mp = 1 << (M - 1).bit_length()

    left = np.full((Tp, Mp), -1, np.int32)
    right = np.full((Tp, Mp), -1, np.int32)
    sindex = np.zeros((Tp, Mp), np.int64)
    sval = np.zeros((Tp, Mp), np.float32)
    for ti, t in enumerate(trees):
        n = t.num_nodes
        left[ti, :n] = t.left
        right[ti, :n] = t.right
        sindex[ti, :n] = np.asarray(t.sindex, np.uint32).astype(np.int64)
        sval[ti, :n] = t.split_value
    split_index = (sindex & 0x7FFFFFFF).astype(np.int32)
    default_left = (sindex >> 31) != 0
    return dict(
        left=left,
        right=right,
        split_index=split_index,
        default_left=default_left,
        split_value=sval,
        num_trees=T,
        num_pad_trees=Tp,
    )


def device_forward_ok(smat) -> bool:
    """The combined (row, findex) key must fit int32 on device."""
    return smat.num_row * (smat.nfeat + 1) + smat.nfeat < _INT32_MAX


@jax.jit
def _forward(
    left,  # [T, M] int32
    right,  # [T, M] int32
    split_index,  # [T, M] int32
    default_left,  # [T, M] bool
    split_value,  # [T, M] f32
    gids,  # [T, R] int32 per-tree root ids
    weights,  # [T, R] f32 per-tree row weights
    keys,  # [E] int32 sorted row*(nfeat+1)+findex
    fvalue,  # [E] f32
    row_key,  # [R] int32 row*(nfeat+1)
    base_pred,  # [R] f32
):
    T, M = left.shape
    R = gids.shape[1]
    E = keys.shape[0]

    def gat(a, pid):
        return jnp.take_along_axis(a, pid, axis=1)

    def cond(pid):
        return jnp.any(gat(left, pid) != -1)

    def body(pid):
        l = gat(left, pid)
        r = gat(right, pid)
        active = l != -1
        q = row_key[None, :] + gat(split_index, pid)  # [T, R]
        pos = jnp.searchsorted(keys, q.reshape(-1)).reshape(T, R)
        pos_c = jnp.minimum(pos, max(E - 1, 0))
        found = (keys[pos_c] == q) if E > 0 else jnp.zeros_like(q, bool)
        val = jnp.where(found, fvalue[pos_c] if E > 0 else 0.0, 0.0)
        go_left = jnp.where(
            ~found, gat(default_left, pid), val < gat(split_value, pid)
        )
        nxt = jnp.where(go_left, l, r)
        return jnp.where(active, nxt, pid)

    pid0 = gids.astype(jnp.int32)
    pid = jax.lax.while_loop(cond, body, pid0)
    leaf = gat(split_value, pid)  # [T, R]
    return base_pred + jnp.sum(leaf * weights, axis=0)


def forward_trees(
    trees: Sequence,
    smat,
    gids_per_tree: List[np.ndarray],
    weights_per_tree: List[np.ndarray],
    base_pred: np.ndarray,
) -> np.ndarray:
    """base_pred + Σ_t w_t · tree_t(rows) evaluated on the default device."""
    st = stack_trees(trees)
    T, Tp = st["num_trees"], st["num_pad_trees"]
    R = smat.num_row
    gids = np.zeros((Tp, R), np.int32)
    weights = np.zeros((Tp, R), np.float32)
    for ti in range(T):
        gids[ti] = gids_per_tree[ti]
        weights[ti] = weights_per_tree[ti]
    out = _forward(
        jnp.asarray(st["left"]),
        jnp.asarray(st["right"]),
        jnp.asarray(st["split_index"]),
        jnp.asarray(st["default_left"]),
        jnp.asarray(st["split_value"]),
        jnp.asarray(gids),
        jnp.asarray(weights),
        jnp.asarray(smat._keys.astype(np.int32)),
        jnp.asarray(smat.fvalue),
        jnp.asarray(
            (np.arange(R, dtype=np.int64) * (smat.nfeat + 1)).astype(np.int32)
        ),
        jnp.asarray(base_pred, np.float32),
    )
    return np.asarray(out, np.float64)
