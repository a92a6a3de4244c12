"""Where does a round of the KDD-geometry bigSvdpp epoch go?
Times the component primitives at the bench geometry (G=2048, M=4,
table 2.25M rows of big_embed.aug_width(64) floats) so the optimization target is measured, not
guessed: per-batch row gathers (u dup vs unique), dedup writes, the
argsort, the overlap matmul, and the chunk-boundary pool ops.

Run from the repository root on a machine with a GPU:
  python scripts/prof_svdpp_big.py
"""

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))

from svdfeature_tpu.ops.big_embed import aug_width  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


emit(device=jax.devices()[0].device_kind, platform=jax.devices()[0].platform)

N_TBL, K = 2_248_001, 64
W = aug_width(K)
G, M = 2048, 4
GS = G * M
E = 2 * GS
T = 250  # ~batches per round at this geometry
C = 49   # chunks per round
F = 12288  # pool entries per chunk

rng = np.random.default_rng(0)
w = jnp.zeros((N_TBL, W), jnp.float32)
u_idx = jnp.asarray(rng.integers(0, 1_000_000, (T, GS)).astype(np.int32))
i_idx = jnp.asarray(rng.integers(1_000_000, 1_624_000, (T, GS)).astype(np.int32))
ug = jnp.asarray(rng.integers(0, 1_000_000, (T, G)).astype(np.int32))
ent = jnp.concatenate([u_idx, i_idx], axis=1)  # [T, E]
pay = jnp.asarray(rng.standard_normal((T, E, K + 3), np.float32))
O = jnp.asarray(rng.standard_normal((C, G + 1, G + 1), np.float32))
delta = jnp.asarray(rng.standard_normal((G + 1, K), np.float32))
fb_idx = jnp.asarray(
    rng.integers(1_624_000, 2_248_000, (C, F)).astype(np.int32))


def timeit(name, fn, *args, reps=3):
    r = jax.jit(fn)
    out = r(*args)
    jax.block_until_ready(out)
    best = 1e30
    for _ in range(reps):
        t0 = time.time()
        out = r(*args)
        jax.block_until_ready(out)
        best = min(best, time.time() - t0)
    emit(probe=name, ms=round(best * 1e3, 1))
    return best


# 1. per-batch dup-user + item gathers over the round (the current path)
def gathers_all(w):
    def body(c, xs):
        ui, ii = xs
        return c + w[ui].sum() + w[ii].sum(), None
    out, _ = jax.lax.scan(body, 0.0, (u_idx, i_idx))
    return out


timeit("gathers_u_dup_plus_i", gathers_all, w)


# 2. unique-user gathers (G per batch) + item gathers
def gathers_unique_u(w):
    def body(c, xs):
        gi, ii = xs
        return c + w[gi].sum() + w[ii].sum(), None
    out, _ = jax.lax.scan(body, 0.0, (ug, i_idx))
    return out


timeit("gathers_unique_u_plus_i", gathers_unique_u, w)


# 3. items only (the floor if user rows are carried across the chunk)
def gathers_items(w):
    def body(c, ii):
        return c + w[ii].sum(), None
    out, _ = jax.lax.scan(body, 0.0, i_idx)
    return out


timeit("gathers_items_only", gathers_items, w)


# 4. argsort per batch over the round
def sorts(_):
    def body(c, e):
        return c + jnp.argsort(e).sum(), None
    out, _ = jax.lax.scan(body, jnp.int32(0), ent)
    return out


timeit("argsort_per_batch", sorts, w[:1])


# 5. full sorted_dedup + unique write per batch over the round
from svdfeature_tpu.ops.big_embed import sorted_dedup, write_rows_unique  # noqa: E402


def dedup_writes(w):
    def body(wc, xs):
        e, p = xs
        order, si, acc, first, last = sorted_dedup(e, p)
        tgt = jnp.where(last, si, N_TBL - 1)
        rows = jnp.pad(acc, ((0, 0), (0, W - K - 3)))
        return write_rows_unique(wc, tgt, rows), None
    out, _ = jax.lax.scan(body, w, (ent, pay))
    return out


timeit("dedup_plus_write_per_batch", dedup_writes, w)


# 6. overlap matmul per batch
def omm(_):
    def body(c, t):
        return c + (O[t % C] @ delta).sum(), None
    out, _ = jax.lax.scan(body, 0.0, jnp.arange(T))
    return out


timeit("overlap_matmul_per_batch", omm, w[:1])


# 7. chunk-boundary pool ops (gather F rows + dedup write F rows) x C
def pool_ops(w):
    def body(wc, c):
        rows = wc[fb_idx[c]]
        order, si, acc, first, last = sorted_dedup(
            fb_idx[c], rows[:, : K + 3])
        tgt = jnp.where(last, si, N_TBL - 1)
        out = jnp.pad(acc, ((0, 0), (0, W - K - 3)))
        return write_rows_unique(wc, tgt, out), None
    out, _ = jax.lax.scan(body, w, jnp.arange(C))
    return out


timeit("pool_gather_dedup_write_per_chunk", pool_ops, w)

emit(probe="done")
