"""On-device pairwise-rank resampling.

The reference regenerates training pairs inline per user block each pass
(PairwiseRankGenerator, apex_svd_data.cpp:812-1025): permute the block's
negative rows, permute its positives, pair them cyclically
(pos[i % n_pos], neg[i % n_neg]) for snum = min(n_neg, rank_sample_max)
pairs.  Host-side that sampling is the only per-round work left once the
packed layout is static (solvers/svdpp._build_pair_skeleton), and it
keeps the whole run from fusing into one dispatch.

This module moves the sampling into the training dispatch with the same
law: per (round, user), an independent uniform permutation of the user's
candidate lists, paired cyclically.  The stream differs from the host
path's glibc-seeded numpy stream (a different permutation of the same
candidate sets each round); the P@20 contract is metric-level, pinned
by the law test (tests/test_rank.py::test_device_sampler_law).

The host skeleton path overlaps its sampling with device work on a
producer thread, so it stays the default (rank_device_sample=0).  Turn
this on when the host is the bottleneck: the whole run costs the host
one key upload.

Everything but the random keys is static:

* pos_cand/neg_cand [U+1, maxC]: per-user candidate rows (whole-dataset
  row ids), padded with the dummy row; the extra user U is the padding
  user for empty slots.
* su/sp_pos/sp_neg [T*GS]: the packed grid is epoch-invariant (pair
  counts are deterministic), so every slot knows its user and its cyclic
  index into the permuted candidate list at build time.

Per round, a [U+1, maxC] uniform-key argsort (pads pushed to the end
with key=2) yields the permutations; two static gathers produce the
(pos_row, neg_row) planes consumed by the skeleton assemble.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# statics dict fields (all device arrays; a plain dict so it rides jit
# argument pytrees):
#   pos_cand/neg_cand [U+1, maxC] i32: per-user candidate rows (pad: Rr;
#     user U is the padding user for empty slots)
#   npos/nneg [U+1] i32 (>=1; padding user has 1 dummy candidate)
#   su [TGS] i32: slot -> user;  sp_pos/sp_neg [TGS] i32: slot -> cyclic
#     index into the permuted candidate list


def build_pair_sampler_statics(ds, slot: np.ndarray, TGS: int) -> dict:
    """ds: PairSource (rank_sample_method == 0); slot: pair j (epoch
    order) -> packed flat slot (the skeleton's perm array)."""
    cfg = ds.cfg
    assert cfg.rank_sample_method == 0
    rows = ds._rows_cat
    Rr = rows.num_row
    U = len(ds.blocks)
    pos_l, neg_l, snums = [], [], []
    for b, blk in enumerate(ds.blocks):
        r0 = int(ds._row_starts[b])
        n = blk.data.num_row
        labels = rows.labels[r0 : r0 + n]
        pos = np.nonzero(labels - cfg.pos_sample_lowerb > -1e-6)[0]
        neg = np.nonzero(labels - cfg.neg_sample_upperb < 1e-6)[0]
        if len(pos) == 0 or len(neg) == 0:
            pos = np.zeros(0, np.int64)
            neg = np.zeros(0, np.int64)
            snum = 0
        else:
            snum = len(neg) if cfg.rank_sample_num < 0 else cfg.rank_sample_num
            snum = min(snum, cfg.rank_sample_max)
        pos_l.append(pos + r0)
        neg_l.append(neg + r0)
        snums.append(snum)
    snums = np.asarray(snums, np.int64)
    maxP = max(1, max((len(p) for p in pos_l), default=1))
    maxN = max(1, max((len(n) for n in neg_l), default=1))
    pos_cand = np.full((U + 1, maxP), Rr, np.int32)
    neg_cand = np.full((U + 1, maxN), Rr, np.int32)
    npos = np.ones(U + 1, np.int32)
    nneg = np.ones(U + 1, np.int32)
    for u in range(U):
        if len(pos_l[u]):
            pos_cand[u, : len(pos_l[u])] = pos_l[u]
            npos[u] = len(pos_l[u])
        if len(neg_l[u]):
            neg_cand[u, : len(neg_l[u])] = neg_l[u]
            nneg[u] = len(neg_l[u])

    su = np.full(TGS, U, np.int32)
    j_user = np.repeat(np.arange(U, dtype=np.int32), snums)
    j_ord = np.concatenate(
        [np.arange(c, dtype=np.int32) for c in snums]
    ) if snums.sum() else np.zeros(0, np.int32)
    su[slot] = j_user
    sp = np.zeros(TGS, np.int32)
    sp[slot] = j_ord
    sp_pos = sp % npos[su]
    sp_neg = sp % nneg[su]
    return dict(
        pos_cand=jnp.asarray(pos_cand),
        neg_cand=jnp.asarray(neg_cand),
        npos=jnp.asarray(npos),
        nneg=jnp.asarray(nneg),
        su=jnp.asarray(su),
        sp_pos=jnp.asarray(sp_pos),
        sp_neg=jnp.asarray(sp_neg),
    )


def _perm_gather(key, cand, ncand, su, sp):
    """One round's flat plane: permute each user's candidate list with
    uniform-key argsort (pads get key 2 > U(0,1) and sink to the end),
    then read each slot's cyclic position."""
    U1, C = cand.shape
    keys = jax.random.uniform(key, (U1, C))
    col = jax.lax.broadcasted_iota(jnp.int32, (U1, C), 1)
    keys = jnp.where(col < ncand[:, None], keys, 2.0)
    order = jnp.argsort(keys, axis=1)
    perm = jnp.take_along_axis(cand, order, axis=1)  # [U1, C]
    return perm[su, sp]  # [TGS]


def sample_pair_flats(key, st: dict, R: int, TGS: int):
    """R rounds of (pos_row, neg_row) planes, [R, TGS] each; rounds are
    independent (lax.scan keeps peak memory at one round's keys)."""

    def body(carry, r):
        kp = jax.random.fold_in(key, 2 * r)
        kn = jax.random.fold_in(key, 2 * r + 1)
        fp = _perm_gather(kp, st["pos_cand"], st["npos"], st["su"], st["sp_pos"])
        fn = _perm_gather(kn, st["neg_cand"], st["nneg"], st["su"], st["sp_neg"])
        return carry, (fp, fn)

    _, (fps, fns) = jax.lax.scan(body, None, jnp.arange(R))
    return fps, fns
