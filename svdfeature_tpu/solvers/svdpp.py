"""SVD++ trainer: user-grouped training with implicit feedback.

Re-design of SVDPPFeature (apex_svd_base.h:484-592); see ops/svdpp.py and
data/batching_plus.py for the batched math and layout.  Extra config key
``users_per_batch`` (default 128) sets the number of users processed
simultaneously (one row each per step).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..data.batching_plus import pack_plus
from ..data.csr import PlusDataset
from .. import backend
from ..ops.svdpp import (
    predict_batches_plus,
    train_epoch_plus,
    train_epoch_plus_refresh,
)
from .base import SVDFeatureTrainer


def _chunk_users_from_slots(uid_slots, cid, dummy):
    """Shared verification + assembly for the user-carry chunk plan.

    uid_slots: [T, G, M] int64 user-row id per slot (dummy where the
    slot carries no user).  Checks, in order: one id per unit per batch
    (mixed real ids -> None), id constant across the chunk's batches,
    ids distinct within a chunk.  Returns [C, G] int32 (dummy where a
    unit never names a user) or None.  Used by both the packed-plane
    plan (_carry_users_plan) and the pair-candidate plan
    (_pair_chunk_users) so the carry precondition cannot drift between
    them."""
    arr = np.where(uid_slots == dummy, -1, uid_slots)
    per_t_max = arr.max(axis=2)  # [T, G]
    big = np.where(arr < 0, np.iinfo(np.int64).max, arr)
    per_t_min = np.where(per_t_max < 0, -1, big.min(axis=2))
    if (per_t_min != per_t_max).any():
        return None  # mixed ids within one unit's slots
    cid = np.asarray(cid)
    G = per_t_max.shape[1]
    C = int(cid.max()) + 1 if len(cid) else 1
    chunk_users = np.full((C, G), dummy, np.int64)
    for c in range(C):
        rows = per_t_max[cid == c]  # [Tc, G]
        if not len(rows):
            continue
        cu = rows.max(axis=0)
        # constant across the chunk's batches where real
        if (np.where(rows < 0, cu, rows) != cu[None]).any():
            return None
        real = cu[cu >= 0]
        if len(np.unique(real)) != len(real):
            return None  # same user in two units of one chunk
        chunk_users[c] = np.where(cu < 0, dummy, cu)
    return chunk_users.astype(np.int32)


def _pair_stacked(sk_dev, flatP, flatN):
    """Assemble a pair epoch's stacked blocks from the static per-row
    tables and the sampled (pos_row, neg_row) planes ([T, GS] or
    [R*T, GS] for per-round data planes)."""
    uri, urv = sk_dev["u_row_idx"], sk_dev["u_row_val"]
    iri, irv = sk_dev["i_row_idx"], sk_dev["i_row_val"]
    return dict(
        sk_dev["static"],  # label/weight/g: per-epoch [T, ...]
        u_idx=uri[flatP][..., None],
        u_val=urv[flatP][..., None],
        i_idx=jnp.stack([iri[flatP], iri[flatN]], axis=-1),
        i_val=jnp.stack([irv[flatP], -irv[flatN]], axis=-1),
    )


def _train_rounds_plus(
    state, stacked, chunk_id, fb, overlap, lrs, consts, fbh, *, hp, M
):
    """len(lrs) plain SVD++ epochs in one trace: a lax.scan of the epoch
    over rounds (the augmented big-table epoch above ONEHOT_THRESHOLD,
    with the user-carry variant when the skeleton shipped
    fb["chunk_users"]).  The label/weight/g planes are per-epoch
    [T, ...]; the sampled u/i planes are either shared by every round
    ([T, ...]) or per round ([R*T, ...])."""
    T = stacked["label"].shape[0]
    R = lrs.shape[0]
    per_round = {
        kk: v.reshape((R, T) + v.shape[1:])
        for kk, v in stacked.items()
        if R > 1 and v.shape[0] == R * T
    }
    shared = {kk: v for kk, v in stacked.items() if kk not in per_round}

    def round_body(st, xs):
        lr, planes = xs
        rnd = dict(shared, **planes)
        if hp.big_table:
            from ..ops.svdpp_big import train_epoch_plus_big_impl

            st = train_epoch_plus_big_impl(
                st, rnd, chunk_id, fb, overlap, lr, consts, hp, *fbh,
                rows_per_user=M, carry_users="chunk_users" in fb,
            )
        else:
            st = train_epoch_plus.__wrapped__(
                st, rnd, chunk_id, fb, overlap, lr, consts, hp, *fbh,
                rows_per_user=M,
            )
        return st, None

    state, _ = jax.lax.scan(round_body, state, (lrs, per_round))
    return state


# module-level jits (hashable statics) so the compile caches across
# trainer instances — a fresh trainer on the same workload must not pay
# the whole-run compile again
@partial(jax.jit, static_argnames=("hp", "M"), donate_argnums=(0,))
def _pair_assemble_train(
    state, flatP, flatN, lrs, consts, sk_dev, chunk_id, fb, overlap, fbh,
    *, hp, M,
):
    """Jitted assemble+epoch: gathers the sampled rows' (idx, val)
    entries from the static tables and runs the epoch(s) in the same
    dispatch."""
    stacked = _pair_stacked(sk_dev, flatP, flatN)
    return _train_rounds_plus(
        state, stacked, chunk_id, fb, overlap, lrs, consts, fbh, hp=hp, M=M
    )


@partial(
    jax.jit, static_argnames=("hp", "M", "T", "GS"), donate_argnums=(0,)
)
def _pair_multi_train(
    state, opl, onl, lrs, consts, sk_dev, geo, chunk_id, fb, overlap, fbh,
    *, hp, M, T, GS,
):
    """K rounds in ONE dispatch from host-sampled PERMUTATIONS: the
    planes ship as block-local permutation offsets (uint8/uint16, ~4x
    less host-to-device transfer than row-id planes).  Plane assembly
    is FOUR gathers total: per-candidate PACKED tables carry (u_idx,
    u_val, i_idx, i_val) as one int32 row so one gather replaces four,
    and the cyclic pair map + slot placement are precomposed into one
    grid->candidate-position map (jp_slot/jn_slot; pad slots point at
    the tables' trailing dummy row)."""
    K = lrs.shape[0]

    def plane(offs, tbl, base, jslot):
        # tbl: [P+1, W] packed candidate rows (last row = padding);
        # jslot: [T*GS] grid position -> candidate position (P = pad)
        P = tbl.shape[0] - 1
        perm = tbl[:P][base[None, :] + offs.astype(jnp.int32)]  # [K, P, W]
        pad = jnp.broadcast_to(tbl[P][None, None, :], (K, 1, tbl.shape[1]))
        return jnp.concatenate([perm, pad], axis=1)[:, jslot]  # [K, TGS, W]

    gp = plane(opl, geo["pos_tbl"], geo["pstart_elem"], geo["jp_slot"])
    gn = plane(onl, geo["neg_tbl"], geo["nstart_elem"], geo["jn_slot"])
    gp = gp.reshape(K * T, GS, 4)
    gn = gn.reshape(K * T, GS, 2)
    fbits = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
    stacked = dict(
        sk_dev["static"],
        u_idx=gp[..., 0:1],
        u_val=fbits(gp[..., 1:2]),
        i_idx=jnp.stack([gp[..., 2], gn[..., 0]], axis=-1),
        i_val=jnp.stack([fbits(gp[..., 3]), -fbits(gn[..., 1])], axis=-1),
    )
    return _train_rounds_plus(
        state, stacked, chunk_id, fb, overlap, lrs, consts, fbh, hp=hp, M=M
    )


@partial(
    jax.jit, static_argnames=("hp", "M", "T", "GS"), donate_argnums=(0,)
)
def _pair_device_train(
    state, key, lrs, consts, sk_dev, chunk_id, fb, overlap, st, fbh,
    *, hp, M, T, GS,
):
    """R rounds in ONE dispatch: on-device resampling (same law as the
    host sampler) + static-table assembly + R plain epochs."""
    from ..ops.pair_sample import sample_pair_flats

    R = lrs.shape[0]
    fp, fn_ = sample_pair_flats(key, st, R, T * GS)  # [R, T*GS]
    stacked = _pair_stacked(
        sk_dev, fp.reshape(R * T, GS), fn_.reshape(R * T, GS)
    )
    return _train_rounds_plus(
        state, stacked, chunk_id, fb, overlap, lrs, consts, fbh, hp=hp, M=M
    )


@partial(
    jax.jit, static_argnames=("epoch", "hp", "M", "kw"), donate_argnums=(0,)
)
def _scan_epochs(state, lrs, data, consts, fbh, *, epoch, hp, M, kw=()):
    """len(lrs) epochs of one packed dataset in ONE dispatch: a lax.scan
    of ``epoch(state, *data, lr, consts, hp, *fbh, rows_per_user=M,
    **dict(kw))`` over the rounds' learning rates (the whole-run form of
    the packed user-group paths; see SVDPPFeatureTrainer._epoch_fn)."""

    def body(st, lr):
        return epoch(
            st, *data, lr, consts, hp, *fbh, rows_per_user=M, **dict(kw)
        ), None

    state, _ = jax.lax.scan(body, state, lrs)
    return state


class SVDPPFeatureTrainer(SVDFeatureTrainer):
    # tables above ONEHOT_THRESHOLD route to the augmented-layout epoch
    # (ops/svdpp_big.py); requires a disjoint feedback space — with
    # common_feedback_space=1 the small-table layout is kept (_build_hp)
    SUPPORTS_BIG_TABLE = True
    # mesh x big tables: slabs above ONEHOT_THRESHOLD route to the
    # augmented big-slab SVD++ body (parallel/svdpp_mesh_big.py — dedup
    # row updates + dedup pool writebacks), same auto rule as the base
    # solver (solvers/base.py _init_mesh)
    SUPPORTS_MESH_BIG = True

    def __init__(self, mtype):
        super().__init__(mtype)
        self.users_per_batch = 128
        # sort blocks by size when packing: ~3x less padding (faster rounds)
        # at a small early-convergence cost; off by default for reference
        # data-order parity
        self.sort_blocks = 0
        # rows of each user trained simultaneously per step.  The per-user
        # sequential chain is the epoch's critical path (the heaviest
        # user's row count bounds the scan length); M>1 cuts it ~M-fold by
        # widening the within-user step to M rows (same hogwild contract
        # as the base solver's batching).  1 = strict reference row order.
        self.rows_per_user = 1
        self._plus_sharded = {}
        # one-ahead pair-epoch prefetch (PairSource): epoch e+1's host
        # sampling + packing overlaps epoch e's device training
        self._pair_pool = None
        self._pair_future = None
        self._pair_src = None
        self._pair_sk = None
        # pair-epoch dense layout (see _apply_pair_layout): pair counts per
        # user are heavily skewed (ML-100K rank demo: max 1113, median 100),
        # so the strict file-order one-row-per-user grid runs ~18% full and
        # the scan length balloons (6654 steps/round).  Sorting users by
        # pair count + training rank_rows_per_user pairs of a user per step
        # cuts it to ~250 steps at the same P@20 (the pairs are fresh random
        # samples each epoch, so data order carries no signal to preserve —
        # unlike rating blocks, where sort_blocks measurably shifts early
        # convergence and stays off by default).
        self.rank_sort_pairs = 1
        self.rank_rows_per_user = 8
        # pair-epoch batch width: 64 users x 8 rows packs the skewed pair
        # counts of the ML-100K rank demo 74% full, and the demo's P@20
        # golden was met at this layout.  Like the other rank_* keys this
        # only fills in when the user left users_per_batch unset.
        self.rank_users_per_batch = 64
        # on-device pair resampling (ops/pair_sample.py): fuses sampling +
        # assembly + the whole run in ONE device dispatch with zero
        # per-round host work/transfer.  Same sampling law as the host
        # path, different stream.  Off by default: the host path's
        # sampling overlaps device work on a producer thread, while the
        # device sampler pays per-round [U, maxC] argsorts on the device.
        # Turn on when the host is the bottleneck.
        self.rank_device_sample = 0
        self.rank_device_seed = 10
        self._explicit_sort = False
        self._explicit_upb = False
        self._explicit_rpu = False
        self._pair_layout_applied = False

    def set_param(self, name: str, val: str) -> None:
        if name == "users_per_batch":
            self.users_per_batch = int(val)
            self._explicit_upb = True
        if name == "rank_users_per_batch":
            self.rank_users_per_batch = int(val)
        if name == "sort_blocks":
            self.sort_blocks = int(val)
            self._explicit_sort = True
        if name == "rows_per_user":
            self.rows_per_user = int(val)
            self._explicit_rpu = True
        if name == "rank_sort_pairs":
            self.rank_sort_pairs = int(val)
        if name == "rank_rows_per_user":
            self.rank_rows_per_user = int(val)
        if name == "rank_device_sample":
            self.rank_device_sample = int(val)
        if name == "rank_device_seed":
            self.rank_device_seed = int(val)
        super().set_param(name, val)

    def _apply_pair_layout(self) -> None:
        """Switch to the dense pair-epoch layout on first PairSource use.
        Explicit sort_blocks=/rows_per_user= config keys win; the rank-
        specific defaults only fill in what the user left unset."""
        if self._pair_layout_applied:
            return
        self._pair_layout_applied = True
        if not self._explicit_sort and self.rank_sort_pairs:
            self.sort_blocks = 1
        if not self._explicit_rpu and self.rank_rows_per_user:
            self.rows_per_user = self.rank_rows_per_user
        if not self._explicit_upb and self.rank_users_per_batch:
            self.users_per_batch = self.rank_users_per_batch

    def _build_hp(self):
        import dataclasses

        hp = super()._build_hp()
        if hp.big_table:
            if self.model.param.common_feedback_space:
                # feedback rows alias user rows: mid-chunk row updates
                # touch the pool, the chunk closed form does not hold,
                # and the refresh fallback drives the standard layout —
                # keep the small-table path (correct, slower)
                return dataclasses.replace(hp, big_table=False, num_factor=0)
        return hp

    def _carry_users_plan(self, packed):
        """[C, G] user-row ids per chunk when the packed layout supports
        the big-table user-carry epoch (ops/svdpp_big carry_users): every
        unit's user segment is a single constant id (Su == 1), distinct
        across the chunk's units.  Returns None when the layout (or a
        hierarchy expansion) breaks the condition — the generic entry
        path handles those."""
        u_idx = packed.u_idx  # [T, GS, Su]
        if u_idx.shape[2] != 1:
            return None
        M = packed.rows_per_user
        T, GS, _ = u_idx.shape
        G = GS // M
        dummy = self.model.num_rows
        ids = u_idx[:, :, 0].reshape(T, G, M).astype(np.int64)
        return _chunk_users_from_slots(ids, packed.chunk_id, dummy)

    def _pack_plus(self, ds: PlusDataset, cache: bool = True):
        key = id(ds)
        if not cache or key not in self._pack_cache:
            m = self.model
            packed = pack_plus(
                ds,
                self.users_per_batch,
                m.num_rows,
                m.param.num_global,
                m.off_user,
                m.off_item,
                m.off_ufeedback,
                feat_user=self.feat_user,
                feat_item=self.feat_item,
                num_user=m.param.num_user,
                num_item=m.param.num_item,
                num_ufeedback=m.param.num_ufeedback,
                sort_blocks=bool(self.sort_blocks),
                rows_per_user=self.rows_per_user,
                # dense O is O(G^2) per chunk; the big path takes the
                # exact factored form (ops/svdpp_big._ov_mul)
                factored_overlap=self.hp.big_table and self._mesh is None,
            )
            if self._mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                from ..parallel.svdpp_mesh import pad_plus_for_mesh

                host_arrays = packed.device_arrays()
                host_arrays.pop("chunk_id", None)  # passed separately
                M = packed.rows_per_user
                arrays, fbd, Gp, _ = pad_plus_for_mesh(
                    host_arrays,
                    packed.fb_arrays(),
                    packed.num_blocks_local,
                    self.mesh_data,
                    m.num_rows,
                    m.param.num_global,
                    M=M,
                )
                sh = lambda v: NamedSharding(
                    self._mesh, P(None, "data") if v.ndim == 2 else P(None, "data", None)
                )
                rep = NamedSharding(self._mesh, P())
                # remap dataset-row -> packed-slot for the padded G
                GS = packed.num_blocks_local * M
                entry = (
                    {k: jax.device_put(v, sh(v)) for k, v in arrays.items()},
                    jax.device_put(packed.chunk_id, rep),
                    {k: jax.device_put(v, rep) for k, v in fbd.items()},
                    (packed.perm // GS) * (Gp * M) + packed.perm % GS,
                    None,  # overlap unused on the mesh path
                )
            else:
                fbd = packed.fb_arrays()
                arrays = packed.device_arrays()
                if self.hp.big_table and self.hp.reg_method < 4:
                    plan = self._carry_users_plan(packed)
                    if plan is not None:
                        fbd["chunk_users"] = plan  # enables carry_users
                        # the item entry schedule is static across
                        # rounds: precompute the per-batch sorted-dedup
                        # layout (ops/big_embed.make_dedup_layout) so
                        # the epoch skips its per-batch argsort
                        from ..ops.big_embed import make_dedup_layout

                        T = packed.i_idx.shape[0]
                        lay = make_dedup_layout(
                            packed.i_idx.reshape(T, -1).astype(np.int64)
                        )
                        for kk, v in zip(
                            ("i_order", "i_si", "i_fpos", "i_last"), lay,
                        ):
                            arrays[kk] = v
                entry = (
                    jax.device_put(arrays),
                    jax.device_put(packed.chunk_id),
                    jax.device_put(fbd),
                    packed.perm,
                    jax.device_put(packed.fb_overlap),
                )
            if not cache:
                return entry
            self._pack_cache[key] = entry
        return self._pack_cache[key]

    def update_rounds(self, ds, num_rounds: int) -> None:
        """num_rounds passes: pair sources run several rounds per device
        dispatch on an accelerator (backend.Capabilities.accelerator);
        packed user-group data runs the whole run in one dispatch on a
        single process (_train_packed_rounds)."""
        if hasattr(ds, "epoch_dataset"):
            self._apply_pair_layout()
            lrs = []
            for _ in range(num_rounds):
                lrs.append(self.learning_rate)
                if self.tparam.decay_learning_rate:
                    self.learning_rate *= self.tparam.decay_rate
                    self.round_counter += 1
            if self._pair_device_ok(ds):
                # whole run in one dispatch: on-device resampling (fresh
                # pairs per round ride per-round data planes)
                self._train_pair_rounds_device(ds, lrs)
                return
            if self._pair_multi_ok(ds):
                # K rounds per dispatch from host-sampled permutation
                # offsets (default accelerator rank path; see
                # _train_pair_rounds_host)
                self._train_pair_rounds_host(ds, lrs)
                return
            for lr in lrs:
                saved = self.learning_rate
                self.learning_rate = lr
                if self._pair_skeleton_ok(ds):
                    self._train_pair_round(ds)
                else:
                    self._train_packed(self._pair_entry(ds))
                self.learning_rate = saved
            return
        if hasattr(ds, "plan_caps"):
            # streaming user-group buffer: one host-driven pass per round
            for _ in range(num_rounds):
                self.update_all(ds)
                if self.tparam.decay_learning_rate:
                    self.learning_rate *= self.tparam.decay_rate
                    self.round_counter += 1
            return
        if not isinstance(ds, PlusDataset):
            return super().update_rounds(ds, num_rounds)
        entry = self._pack_plus(ds)
        lrs = []
        for _ in range(num_rounds):
            lrs.append(self.learning_rate)
            if self.tparam.decay_learning_rate:
                self.learning_rate *= self.tparam.decay_rate
                self.round_counter += 1
        self._train_packed_rounds(entry, lrs)

    def _train_packed_rounds(self, entry, lrs) -> None:
        """len(lrs) epochs of one packed entry.  A single process runs
        them in one dispatch, a lax.scan of the epoch over rounds
        (_scan_epochs); a mesh, or an entry without an _epoch_fn, runs
        one epoch per round."""
        if not lrs:
            return
        call = None if self._mesh is not None else self._epoch_fn(entry)
        if call is None:
            for lr in lrs:
                saved = self.learning_rate
                self.learning_rate = lr
                self._train_packed(entry)
                self.learning_rate = saved
            return
        epoch, data, kw = call
        self.state = _scan_epochs(
            self.state, jnp.asarray(lrs, jnp.float32), data, self.consts,
            self._fbh(), epoch=epoch, hp=self.hp, M=self.rows_per_user, kw=kw,
        )

    def _epoch_fn(self, entry):
        """(epoch, data, kw) for a single-process packed entry: the jitted
        epoch, its data arguments and its static keywords, so that
        ``epoch(state, *data, lr, consts, hp, *fbh, rows_per_user=M,
        **dict(kw))`` trains one round.  None for entries of another
        layout (subclasses that pack wider entries override this or
        train round by round)."""
        if len(entry) != 5:
            return None
        stacked, chunk_id, fb, _, overlap = entry
        if self.model.param.common_feedback_space:
            # feedback rows alias user rows: mid-chunk row updates touch the
            # pool, so the overlap closed form does not hold — refresh per
            # batch (ops/svdpp.train_epoch_plus_refresh)
            return train_epoch_plus_refresh, (stacked, chunk_id, fb), ()
        if self.hp.big_table:
            from ..ops.svdpp_big import train_epoch_plus_big

            return (
                train_epoch_plus_big,
                (stacked, chunk_id, fb, overlap),
                (("carry_users", "chunk_users" in fb),),
            )
        return train_epoch_plus, (stacked, chunk_id, fb, overlap), ()

    def _run_epoch(self, entry) -> None:
        """One single-process epoch of a packed entry at the current
        learning rate."""
        epoch, data, kw = self._epoch_fn(entry)
        self.state = epoch(
            self.state, *data, jnp.float32(self.learning_rate), self.consts,
            self.hp, *self._fbh(), rows_per_user=self.rows_per_user,
            **dict(kw),
        )

    def _mesh_predict_fn(self, G, F, M):
        """Sharded inference builder: standard slabs or (mesh_big) the
        augmented big-slab forward (consts bound for the gather-time
        lazy views)."""
        if self._mesh_big:
            from ..parallel.svdpp_mesh_big import sharded_svdpp_predict_big

            inner = sharded_svdpp_predict_big(
                self._mesh, self.hp, self._n_real, G, F, M=M
            )
            return lambda st, stacked, cid, fb: inner(
                st, stacked, cid, fb, self.consts
            )
        from ..parallel.svdpp_mesh import sharded_svdpp_predict

        return sharded_svdpp_predict(self._mesh, self.hp, self._n_pad, G, F, M=M)

    def _train_packed(self, entry) -> None:
        stacked, chunk_id, fb, _, _ = entry
        if self._mesh is not None:
            M = self.rows_per_user
            G = stacked["label"].shape[1] // M
            F = fb["fb_idx"].shape[1]
            key = (G, F, M, self._mesh_big)
            if key not in self._plus_sharded:
                if self._mesh_big:
                    from ..parallel.svdpp_mesh_big import (
                        sharded_svdpp_rounds_big as rounds_fn,
                    )

                    n_arg = self._n_real
                else:
                    from ..parallel.svdpp_mesh import (
                        sharded_svdpp_rounds as rounds_fn,
                    )

                    n_arg = self._n_pad
                self._plus_sharded[key] = rounds_fn(
                    self._mesh,
                    self.hp,
                    n_arg,
                    G,
                    F,
                    self.tparam.scale_lr_ufeedback,
                    self.tparam.wd_ufeedback,
                    self.tparam.wd_ufeedback_bias,
                    M=M,
                )
            self.state = self._plus_sharded[key](
                self.state,
                stacked,
                chunk_id,
                fb,
                jnp.asarray([self.learning_rate], jnp.float32),
                self.consts,
            )
            return
        self._run_epoch(entry)

    # ---- streaming (out-of-core user-group buffers) -----------------------
    def pack_plus_chunk(self, chunk: PlusDataset, caps: dict):
        """Pack one streamed user-group chunk to the stream's stable
        shapes (file order — the reference's streaming iterators also
        process blocks in file order, apex_svd_data.cpp:1265-1299).
        Hierarchical side features widen the raw seg caps by their
        worst-case expansion factor; on a mesh the user slots and pool
        are padded to the data axis (pad_plus_for_mesh)."""
        m = self.model
        caps = dict(caps)
        caps["seg_caps"] = self._stream_seg_caps(caps["seg_caps"])
        packed = pack_plus(
            chunk,
            self.users_per_batch,
            m.num_rows,
            m.param.num_global,
            m.off_user,
            m.off_item,
            m.off_ufeedback,
            feat_user=self.feat_user,
            feat_item=self.feat_item,
            num_user=m.param.num_user,
            num_item=m.param.num_item,
            num_ufeedback=m.param.num_ufeedback,
            rows_per_user=self.rows_per_user,
            sort_blocks=bool(self.sort_blocks),  # chunk-local ordering
            **caps,
        )
        arrays = packed.device_arrays()
        fbd = packed.fb_arrays()
        if (
            self._mesh is None
            and self.hp.big_table
            and self.hp.reg_method < 4
        ):
            # NOTE: the plan is per-chunk; a stream whose chunks differ
            # in carry-ability (e.g. one chunk repeats a user id across
            # two blocks) compiles TWO epoch variants — both exact, both
            # cached after their first occurrence, so the cost is one
            # extra compile, not a per-chunk recompile
            plan = self._carry_users_plan(packed)
            if plan is not None:
                # pad to the stream's stable chunk cap so every chunk
                # compiles to the same program (incl. the reserved
                # all-padding chunk, whose users are all dummy)
                c_out = fbd["fb_idx"].shape[0]
                full = np.full((c_out, plan.shape[1]), m.num_rows, np.int32)
                full[: plan.shape[0]] = plan
                fbd["chunk_users"] = full
        if self._mesh is not None:
            from ..parallel.svdpp_mesh import pad_plus_for_mesh

            arrays.pop("chunk_id", None)
            arrays, fbd, _, _ = pad_plus_for_mesh(
                arrays,
                fbd,
                packed.num_blocks_local,
                self.mesh_data,
                m.num_rows,
                m.param.num_global,
                M=packed.rows_per_user,
            )
        return (
            arrays,
            packed.chunk_id,
            fbd,
            packed.fb_overlap,
        )

    def stage_chunk_plus(self, entry):
        """Device staging for one packed plus chunk (mesh-aware)."""
        stacked, chunk_id, fb, overlap = entry
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.mesh import put_process_sharded

            rep = NamedSharding(self._mesh, P())
            return (
                put_process_sharded(stacked, self._mesh),
                jax.device_put(chunk_id, rep),
                {k: jax.device_put(v, rep) for k, v in fb.items()},
                None,  # overlap unused on the mesh path
            )
        return jax.device_put(entry)

    def train_chunk_plus(self, entry) -> None:
        stacked, chunk_id, fb, overlap = entry
        self._train_packed((stacked, chunk_id, fb, None, overlap))

    # ---- skeleton pair epochs (PairSource fast path) ----------------------
    # Pair counts per user are deterministic, so the ENTIRE packed layout
    # except the sampled rows is epoch-invariant: labels, weights, slot->
    # user geometry, feedback pools, overlap matrices, chunk ids, and the
    # slot of every pair.  When each source row is one (user, item) entry
    # pair (the pairwise-rank shape: apex_svd_data.cpp:812-860 merges two
    # single-item rows into a [pos, neg] difference), a round only needs
    # the sampled (pos_row, neg_row) ids — 2 int32 planes — shipped to the
    # device; u/i segments are gathered from static per-row tables inside
    # the training dispatch.  Host work per round drops from full
    # synthesis+packing to the sampling loop, and the transfer from the
    # packed planes to two int32 planes.
    def _pair_skeleton_ok(self, ds) -> bool:
        # (big tables ride the skeleton too: assembly is table-size
        # independent and _train_rounds_plus routes to the augmented
        # epoch)
        if (
            self._mesh is not None
            or self.model.param.common_feedback_space
            or self.feat_user is not None
            or self.feat_item is not None
            or getattr(ds, "cfg", None) is None
            or ds.cfg.rank_sample_pointwise
            or ds.cfg.rank_sample_method // 10 != 0  # labels epoch-static
            or "_gen_rows" in ds.__dict__
        ):
            return False
        rows = getattr(ds, "_rows_cat", None)
        if rows is None or rows.num_row == 0:
            return False
        ng, nu, ni = rows.seg_counts()
        return (
            int(ng.max()) == 0
            and int(nu.max()) <= 1
            and int(ni.max()) == 1
            and int(ni.min()) == 1
        )

    def _build_pair_skeleton(self, ds) -> dict:
        """Pack one throwaway epoch (rng rewound) to harvest the static
        layout, and build the per-row gather tables."""
        m = self.model
        rng_state = ds.rng.get_state()
        eds = ds.epoch_dataset()
        ds.rng.set_state(rng_state)  # round 1 resamples the same stream

        packed = pack_plus(
            eds,
            self.users_per_batch,
            m.num_rows,
            m.param.num_global,
            m.off_user,
            m.off_item,
            m.off_ufeedback,
            num_user=m.param.num_user,
            num_item=m.param.num_item,
            num_ufeedback=m.param.num_ufeedback,
            sort_blocks=bool(self.sort_blocks),
            rows_per_user=self.rows_per_user,
            factored_overlap=self.hp.big_table,  # big pair epochs
        )
        T, GS = packed.label.shape
        rows = ds._rows_cat
        R_ = rows.num_row
        rp = rows.row_ptr.astype(np.int64)
        ar = np.arange(R_, dtype=np.int64)
        _, nu, _ = rows.seg_counts()
        dummy = m.num_rows

        ipos = rp[3 * ar + 2]
        i_row_idx = m.off_item + rows.index[ipos].astype(np.int64)
        i_row_val = rows.value[ipos].astype(np.float32)
        if len(i_row_idx) and rows.index[ipos].max() >= m.param.num_item:
            raise ValueError("item feature index exceed bound")

        upos = rp[3 * ar + 1]
        has_u = nu.astype(bool)
        u_ids = rows.index[np.where(has_u, upos, 0)].astype(np.int64)
        u_vals = rows.value[np.where(has_u, upos, 0)].astype(np.float32)
        # the synthesized pair row keeps only |v|>1e-6 user entries
        # (apex_svd_data.cpp:869-875); mirror by pointing dead entries at
        # the dummy row so they are neither read nor decayed
        live_u = has_u & (np.abs(u_vals) > 1e-6)
        if len(u_ids) and u_ids[live_u].size and u_ids[live_u].max() >= m.param.num_user:
            raise ValueError("user feature index exceed bound")
        u_row_idx = np.where(live_u, m.off_user + u_ids, dummy)
        u_row_val = np.where(live_u, u_vals, 0.0).astype(np.float32)

        def tbl(a, pad):
            return jnp.asarray(
                np.concatenate([a, np.full(1, pad, a.dtype)]).astype(
                    np.int32 if a.dtype.kind == "i" else np.float32
                )
            )

        sk_dev = {
            "static": jax.device_put(
                {
                    "label": packed.label,
                    "weight": packed.weight,
                    "g_idx": packed.g_idx,
                    "g_val": packed.g_val,
                }
            ),
            "u_row_idx": tbl(u_row_idx, dummy),
            "u_row_val": tbl(u_row_val, 0.0),
            "i_row_idx": tbl(i_row_idx, dummy),
            "i_row_val": tbl(i_row_val, 0.0),
        }
        # host copies for the packed candidate tables
        # (_train_pair_rounds_host)
        host_rows = (
            u_row_idx.astype(np.int32),
            u_row_val.astype(np.float32),
            i_row_idx.astype(np.int32),
            i_row_val.astype(np.float32),
        )
        chunk_id = jax.device_put(packed.chunk_id)
        fbd = jax.device_put(packed.fb_arrays())
        overlap = jax.device_put(packed.fb_overlap)

        # "slot": slot of pair j (epoch order) in the [T*GS] grid —
        # epoch-invariant
        sk = {
            "dev": sk_dev,
            "chunk_id": chunk_id,
            "fb": fbd,
            "overlap": overlap,
            "slot": packed.perm,
            "T": T,
            "GS": GS,
            "TGS": T * GS,
            "Rr": R_,
            "host_rows": host_rows,
            "dummy": dummy,
            "G": packed.num_blocks_local,
            "M": packed.rows_per_user,
        }
        return sk

    def _fbh(self):
        return (
            self.tparam.scale_lr_ufeedback,
            self.tparam.wd_ufeedback,
            self.tparam.wd_ufeedback_bias,
        )

    def _pair_chunk_users(self, jp_slot, pstart_elem, uid_cand, sk):
        """[C, G] chunk-user plan for the big-table pair path, derived
        from the epoch-INVARIANT candidate geometry (every candidate
        row's user id per block, placed through jp_slot), so it holds
        for every epoch's sample — unlike a plan read off one epoch's
        assembled planes, which can miss a user whose sampled rows were
        all dead that epoch.  None when the layout disproves the carry
        precondition (mixed ids in a block, duplicate users in a chunk)
        or it does not apply (small table, lazy reg)."""
        if not (self.hp.big_table and self.hp.reg_method < 4):
            return None
        dummy = sk["dummy"]
        # pstart_elem is PER-CANDIDATE: the start position of the block
        # owning each candidate (the sampler adds a block-local offset
        # to it, _pair_multi_train.plane), so block boundaries are where
        # consecutive starts change
        starts = np.asarray(pstart_elem, np.int64)
        P = len(starts)
        if P == 0:
            return None
        u = np.where(uid_cand == dummy, -1, uid_cand).astype(np.int64)
        newblk = np.concatenate([[True], starts[1:] != starts[:-1]])
        bnd = np.flatnonzero(newblk)
        segmax = np.maximum.reduceat(u, bnd)
        big = np.where(u < 0, np.iinfo(np.int64).max, u)
        segmin = np.minimum.reduceat(big, bnd)
        live = segmax >= 0
        if (segmin[live] != segmax[live]).any():
            return None  # two user ids inside one block's candidates
        block_uid = np.where(live, segmax, dummy)
        cand_uid = block_uid[np.cumsum(newblk) - 1]  # [P]
        # place through the grid: slot s -> candidate jp_slot[s] (a
        # block-local permutation keeps the sample inside the block, so
        # the block's uid holds for every epoch); pad slots (== P) ->
        # dummy
        j = np.asarray(jp_slot, np.int64)
        uid_slot = np.where(j >= P, dummy, cand_uid[np.minimum(j, P - 1)])
        T, GS, G, M = sk["T"], sk["GS"], sk["G"], sk["M"]
        return _chunk_users_from_slots(
            uid_slot.reshape(T, G, M), sk["chunk_id"], dummy
        )

    def _pair_flats(self, ds, sk):
        """Sample one epoch and place the pair rows at their static slots;
        padded slots point at the dummy row Rr (weight 0)."""
        pr, nr, _ = ds.epoch_pairs()
        fp = np.full(sk["TGS"], sk["Rr"], np.int32)
        fn_ = np.full(sk["TGS"], sk["Rr"], np.int32)
        fp[sk["slot"]] = pr
        fn_[sk["slot"]] = nr
        return (
            jax.device_put(fp.reshape(sk["T"], sk["GS"])),
            jax.device_put(fn_.reshape(sk["T"], sk["GS"])),
        )

    def _pair_multi_ok(self, ds) -> bool:
        """Several rounds per dispatch: an accelerator behind the process
        (backend capability table), a skeleton-eligible source and the
        method-0 sampling law (data/rank pair_geometry and
        ops/pair_sample cover exactly _sample_block's method 0).  The
        per-round path (_train_pair_round) keeps the exact sequential
        numpy stream for the CPU and for round-at-a-time callers (the
        ranker state machine, per-round model saves).  Builds the
        skeleton on first use."""
        if not (
            backend.capabilities().accelerator
            and self._pair_skeleton_ok(ds)
            and ds.cfg.rank_sample_method == 0
        ):
            return False
        if self._pair_sk is None or self._pair_src != id(ds):
            self._pair_sk = self._build_pair_skeleton(ds)
            self._pair_src = id(ds)
            self._pair_future = None
        return True

    def _pair_device_ok(self, ds) -> bool:
        """Whole-run path with on-device resampling (rank_device_sample=1,
        ops/pair_sample.py)."""
        return bool(self.rank_device_sample) and self._pair_multi_ok(ds)

    def _train_pair_rounds_device(self, ds, lrs) -> None:
        """R rounds in one _pair_device_train dispatch."""
        sk = self._pair_sk
        if "sampler" not in sk:
            from ..ops.pair_sample import build_pair_sampler_statics

            sk["sampler"] = build_pair_sampler_statics(
                ds, sk["slot"], sk["TGS"]
            )
            sk["key_round"] = 0
        key = jax.random.fold_in(
            jax.random.PRNGKey(self.rank_device_seed), sk["key_round"]
        )
        sk["key_round"] += len(lrs)
        self.state = _pair_device_train(
            self.state,
            key,
            jnp.asarray(lrs, jnp.float32),
            self.consts,
            sk["dev"],
            sk["chunk_id"],
            sk["fb"],
            sk["overlap"],
            sk["sampler"],
            self._fbh(),
            hp=self.hp,
            M=sk["M"],
            T=sk["T"],
            GS=sk["GS"],
        )

    # K rounds per _pair_multi_train dispatch: large enough to amortize
    # the per-dispatch transfer of one 2x[K, P-ish] offset block, small
    # enough that the producer thread's batched sampling stays ahead of
    # the device
    PAIR_BLOCK_ROUNDS = 8

    def _train_pair_rounds_host(self, ds, lrs) -> None:
        """lrs rounds in ceil(R/K) _pair_multi_train dispatches; block
        j+1's batched sampling (data/rank.sample_offsets) runs on the
        producer thread while block j trains."""
        sk = self._pair_sk
        if "geo" not in sk:
            geo = ds.pair_geometry()
            S = len(geo["jp"])
            slot_inv = np.full(sk["TGS"], S, np.int64)
            slot_inv[sk["slot"]] = np.arange(S)
            uri, urv, iri, irv = sk["host_rows"]
            bits = lambda f: f.view(np.int32)
            dummy = sk["dummy"]
            pr, nr = geo["pos_rows"], geo["neg_rows"]
            pos_tbl = np.concatenate([
                np.stack([uri[pr], bits(urv[pr]), iri[pr], bits(irv[pr])], 1),
                np.array([[dummy, 0, dummy, 0]], np.int32),
            ]).astype(np.int32)
            neg_tbl = np.concatenate([
                np.stack([iri[nr], bits(irv[nr])], 1),
                np.array([[dummy, 0]], np.int32),
            ]).astype(np.int32)

            def jslot(jmap, P):
                # grid position -> candidate position; pad slots -> P
                j = np.take(jmap, np.minimum(slot_inv, S - 1))
                return np.where(slot_inv == S, P, j).astype(np.int32)

            jp_slot = jslot(geo["jp"], len(pr))
            sk["geo"] = jax.device_put(
                {
                    "pos_tbl": pos_tbl,
                    "neg_tbl": neg_tbl,
                    "pstart_elem": geo["pstart_elem"],
                    "nstart_elem": geo["nstart_elem"],
                    "jp_slot": jp_slot,
                    "jn_slot": jslot(geo["jn"], len(nr)),
                }
            )
            sk["multi_rng"] = np.random.default_rng(self.rank_device_seed)
            plan = self._pair_chunk_users(
                jp_slot, geo["pstart_elem"], uri[pr], sk
            )
            if plan is not None:
                # enables the big epoch's user-carry variant for the
                # assembled pair planes (epoch-independent: derived
                # from the CANDIDATE tables, not one epoch's sample)
                sk["fb"] = dict(sk["fb"], chunk_users=jax.device_put(plan))
        if self._pair_pool is None:
            import concurrent.futures

            self._pair_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pairgen"
            )

        K = self.PAIR_BLOCK_ROUNDS
        blocks = [lrs[i: i + K] for i in range(0, len(lrs), K)]
        if not blocks:  # zero rounds: no-op like the per-round loop
            return

        def sample(n):
            opl, onl = ds.sample_offsets(n, sk["multi_rng"])
            return jax.device_put((opl, onl))

        fut = self._pair_pool.submit(sample, len(blocks[0]))
        for j, blk_lrs in enumerate(blocks):
            opl, onl = fut.result()
            if j + 1 < len(blocks):
                fut = self._pair_pool.submit(sample, len(blocks[j + 1]))
            self.state = _pair_multi_train(
                self.state,
                opl,
                onl,
                jnp.asarray(blk_lrs, jnp.float32),
                self.consts,
                sk["dev"],
                sk["geo"],
                sk["chunk_id"],
                sk["fb"],
                sk["overlap"],
                self._fbh(),
                hp=self.hp,
                M=sk["M"],
                T=sk["T"],
                GS=sk["GS"],
            )

    def _train_pair_round(self, ds) -> None:
        """One skeleton-path round, next round's sampling one-ahead on the
        producer thread (same overlap discipline as _pair_entry)."""
        if self._pair_pool is None:
            import concurrent.futures

            self._pair_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pairgen"
            )
        if self._pair_src == id(ds) and self._pair_future is not None:
            flats = self._pair_future.result()
        else:
            if self._pair_src != id(ds) or self._pair_sk is None:
                self._pair_sk = self._build_pair_skeleton(ds)
            flats = self._pair_flats(ds, self._pair_sk)
        self._pair_src = id(ds)
        sk = self._pair_sk
        self._pair_future = self._pair_pool.submit(self._pair_flats, ds, sk)
        self.state = _pair_assemble_train(
            self.state,
            flats[0],
            flats[1],
            jnp.asarray([self.learning_rate], jnp.float32),
            self.consts,
            sk["dev"],
            sk["chunk_id"],
            sk["fb"],
            sk["overlap"],
            self._fbh(),
            hp=self.hp,
            M=sk["M"],
        )

    def _pair_entry(self, ds):
        """Packed entry for a fresh pair epoch, one-ahead overlapped.

        The reference regenerates pairs inline per block on the training
        thread (apex_svd_data.cpp:812-1025); serially that host work
        dominates a device round, so epoch e+1's sampling + packing runs on
        a producer thread while epoch e trains (jax dispatch is async —
        the same overlap discipline as data/streaming.py).  Pair counts
        are deterministic (data/rank.py), so shapes and the jit cache are
        stable across epochs; the PairSource's rng is only ever advanced
        on one thread at a time, preserving the sequential trajectory."""
        self._apply_pair_layout()
        if self._pair_pool is None:
            import concurrent.futures

            self._pair_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pairgen"
            )
        if self._pair_src == id(ds) and self._pair_future is not None:
            entry = self._pair_future.result()
        else:
            entry = self._pack_plus(ds.epoch_dataset(), cache=False)
        self._pair_src = id(ds)
        # both the sampling and the packing run on the producer thread
        self._pair_future = self._pair_pool.submit(
            lambda: self._pack_plus(ds.epoch_dataset(), cache=False)
        )
        return entry

    def _stream_round_plus(self, ds) -> None:
        from ..data.streaming import stream_train_round_plus

        # sort_blocks under streaming is CHUNK-LOCAL: each streamed
        # chunk packs with the size-desc ordering applied within itself
        # (pack_plus sorts whatever dataset it is handed — here one
        # chunk), and the cap plan mirrors that ordering
        # (plan_caps sort_local), so the sorted-packing scan-length win
        # survives out-of-core training in the reference's
        # bounded-memory iterator contract
        # (apex-utils/apex_buffer_loader.h:39-233).  Trajectory == a
        # staged run on the equivalently chunk-locally-sorted dataset
        # (tests/test_streaming.py).
        # trajectory == staged run only when chunks split into whole
        # user-batches (stream_train_round_plus docstring); round down
        # rather than silently diverge
        bpc = ds.blocks_per_chunk
        if bpc % self.users_per_batch:
            new = max(self.users_per_batch, bpc - bpc % self.users_per_batch)
            import warnings

            warnings.warn(
                f"streaming: blocks_per_chunk={bpc} is not a multiple of "
                f"users_per_batch={self.users_per_batch}; rounding to {new} "
                "to keep the staged-run trajectory guarantee"
            )
            ds.blocks_per_chunk = new
        stream_train_round_plus(self, ds)

    def update_all(self, ds) -> None:
        if hasattr(ds, "plan_caps"):  # StreamingPlusBuffer
            self._stream_round_plus(ds)
            return
        if hasattr(ds, "epoch_dataset"):  # PairSource: fresh pairs per epoch
            self._apply_pair_layout()
            if self._pair_device_ok(ds):
                self._train_pair_rounds_device(ds, [self.learning_rate])
            elif self._pair_skeleton_ok(ds):
                self._train_pair_round(ds)
            else:
                self._train_packed(self._pair_entry(ds))
            return
        if not isinstance(ds, PlusDataset):
            return super().update_all(ds)
        self._train_packed(self._pack_plus(ds))

    def predict_all(self, ds) -> np.ndarray:
        if hasattr(ds, "plan_caps"):  # streaming source: bounded-memory eval
            caps = ds.plan_caps(self.users_per_batch, self.rows_per_user)
            caps = dict(caps)
            caps["seg_caps"] = self._stream_seg_caps(caps["seg_caps"])
            m = self.model
            st = None if self._mesh is not None else self.state_or_model()
            out = []
            for chunk in ds.chunks():
                packed = pack_plus(
                    chunk, self.users_per_batch, m.num_rows,
                    m.param.num_global, m.off_user, m.off_item,
                    m.off_ufeedback, feat_user=self.feat_user,
                    feat_item=self.feat_item, num_user=m.param.num_user,
                    num_item=m.param.num_item,
                    num_ufeedback=m.param.num_ufeedback,
                    rows_per_user=self.rows_per_user, **caps,
                )
                if self._mesh is not None:
                    # sharded streamed eval: tables stay row-sharded
                    from jax.sharding import NamedSharding, PartitionSpec as P

                    from ..parallel.mesh import put_process_sharded
                    from ..parallel.svdpp_mesh import pad_plus_for_mesh

                    M = packed.rows_per_user
                    arrays = packed.device_arrays()
                    arrays.pop("chunk_id", None)
                    arrays, fbd, Gp, Fp = pad_plus_for_mesh(
                        arrays, packed.fb_arrays(), packed.num_blocks_local,
                        self.mesh_data, m.num_rows, m.param.num_global, M=M,
                    )
                    key = ("pred", Gp, Fp, M, self._mesh_big)
                    if key not in self._plus_sharded:
                        self._plus_sharded[key] = self._mesh_predict_fn(
                            Gp, Fp, M
                        )
                    rep = NamedSharding(self._mesh, P())
                    preds = self._plus_sharded[key](
                        self.state,
                        put_process_sharded(arrays, self._mesh),
                        jax.device_put(packed.chunk_id, rep),
                        {k: jax.device_put(v, rep) for k, v in fbd.items()},
                    )
                    if jax.process_count() > 1:
                        from jax.experimental.multihost_utils import (
                            process_allgather,
                        )

                        preds = process_allgather(preds, tiled=True)
                    GS = packed.num_blocks_local * M
                    perm = (packed.perm // GS) * (Gp * M) + packed.perm % GS
                    out.append(np.asarray(preds).reshape(-1)[perm])
                    continue
                preds = np.asarray(
                    predict_batches_plus(
                        st,
                        jax.device_put(packed.device_arrays()),
                        jax.device_put(packed.chunk_id),
                        jax.device_put(packed.fb_arrays()),
                        self.hp,
                        rows_per_user=self.rows_per_user,
                    )
                ).reshape(-1)
                out.append(preds[packed.perm])
            return (
                np.concatenate(out) if out else np.zeros(0, np.float32)
            )
        if hasattr(ds, "epoch_dataset"):
            self._apply_pair_layout()
            entry = self._pack_plus(ds.epoch_dataset(), cache=False)
        elif isinstance(ds, PlusDataset):
            entry = self._pack_plus(ds)
        else:
            return super().predict_all(ds)
        stacked, chunk_id, fb, perm, _ = entry
        if self._mesh is not None:
            # inference runs on the mesh itself — tables stay row-sharded
            # (parallel/svdpp_mesh.sharded_svdpp_predict)
            M = self.rows_per_user
            G = stacked["label"].shape[1] // M
            F = fb["fb_idx"].shape[1]
            key = ("pred", G, F, M, self._mesh_big)
            if key not in self._plus_sharded:
                self._plus_sharded[key] = self._mesh_predict_fn(G, F, M)
            preds = self._plus_sharded[key](self.state, stacked, chunk_id, fb)
            if jax.process_count() > 1:
                from jax.experimental.multihost_utils import process_allgather

                preds = process_allgather(preds, tiled=True)
            return np.asarray(preds).reshape(-1)[perm]
        preds = np.asarray(
            predict_batches_plus(
                self.state_or_model(), stacked, chunk_id, fb, self.hp,
                rows_per_user=self.rows_per_user,
            )
        ).reshape(-1)
        # perm maps dataset row -> packed slot (t*G + g)
        return preds[perm]
