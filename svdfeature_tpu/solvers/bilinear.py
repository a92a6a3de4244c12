"""Bilinear solver (extend_type=15): per-item x user-property interactions.

Re-design of SVDBiLinearTrainer (solvers/bilinear/apex_svd_bilinear.h:
28-212) on top of the SVD++ stack: a dense matrix W_bi[item, bi_feedback]
adds  sum_items sum_props W_bi[iid, pid] * ival * pval  to the score,
where the user properties are the block's feedback entries with
id < num_bi_feedback, and the feedback *factor* sum starts at
start_ufeedback (prepare_ufeedback's start_fid filter, :170-181).

Note the reference quirk (SURVEY.md §2.1 #10): its prepare/update_ufeedback
overrides are declared virtual on a non-virtual base, so calls from the
inherited update() bind statically.  In the shipped binary the start_fid
filter therefore never applies on the main update path; we implement the
*intended* behavior (filter applied), which only differs when
start_ufeedback > 0.

Checkpoint layout appends BParam (136 bytes) + W_bi after the SVDModel
section (apex_svd_bilinear.h:63-72).
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import jax
import jax.numpy as jnp
import numpy as np

from ..data.batching_plus import pack_plus
from ..data.csr import PlusDataset
from ..model import _read_t2d, _write_t2d
from ..ops.svdpp_bilinear import (
    predict_batches_bi,
    train_epoch_bi,
    train_epoch_bi_refresh,
)
from .svdpp import SVDPPFeatureTrainer


class BParam:
    NBYTES = 4 * (2 + 32)

    def __init__(self) -> None:
        self.num_bi_feedback = 0
        self.start_ufeedback = 0

    def set_param(self, name: str, val: str) -> None:
        if name == "num_bi_feedback":
            self.num_bi_feedback = int(val)
        if name == "start_ufeedback":
            self.start_ufeedback = int(val)

    def to_bytes(self) -> bytes:
        return struct.pack("<ii", self.num_bi_feedback, self.start_ufeedback) + b"\0" * 128

    def load(self, f: BinaryIO) -> None:
        raw = f.read(self.NBYTES)
        self.num_bi_feedback, self.start_ufeedback = struct.unpack("<ii", raw[:8])


class SVDBiLinearTrainer(SVDPPFeatureTrainer):
    # above ONEHOT_THRESHOLD both the unified table (augmented layout,
    # ops/svdpp_big.py) and W_bi (touched-rows dedup writes,
    # ops/svdpp_bilinear._bi_step_big) ride the big-table path; requires
    # a disjoint feedback space like SVD++ (svdpp._build_hp falls back
    # to the small layout under common_feedback_space=1)
    SUPPORTS_BIG_TABLE = True

    # mesh x big tables: slabs above ONEHOT_THRESHOLD route to the
    # augmented big-slab bilinear body (parallel/bilinear_mesh_big.py —
    # dedup row updates for BOTH the unified table and W_bi), same auto
    # rule as the base solver (solvers/base.py _init_mesh)
    SUPPORTS_MESH_BIG = True

    def _init_mesh(self) -> None:
        super()._init_mesh()
        ni = self.mparam.num_item
        if self._mesh_big:
            # scratch-interleaved W_bi slabs for the dedup write path
            from ..parallel.bilinear_mesh_big import shard_bi_big

            self.W_bi, self._nb_real = shard_bi_big(self.W_bi, self._mesh)
            return
        # row-shard W_bi over the model axis (padded, dummy last row)
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.bilinear_mesh import pad_bi_rows

        self._n_bi_pad = pad_bi_rows(ni, self.mesh_model)
        Wb = np.zeros((self._n_bi_pad, self.bparam.num_bi_feedback), np.float32)
        Wb[:ni] = np.asarray(self.W_bi)
        self.W_bi = jax.device_put(
            Wb, NamedSharding(self._mesh, P("model", None))
        )

    def _wbi_host(self) -> np.ndarray:
        """The logical [num_item, nbf] W_bi for IO/inspection, whatever
        the device layout (plain, mesh-padded, or mesh-big interleaved)."""
        ni = self.mparam.num_item
        if self._mesh is not None and self._mesh_big:
            from ..parallel.bilinear_mesh_big import unshard_bi_big

            return np.asarray(
                unshard_bi_big(self.W_bi, self.mesh_model, self._nb_real, ni)
            )
        return np.asarray(self.W_bi)[:ni]

    def __init__(self, mtype):
        super().__init__(mtype)
        self.bparam = BParam()
        self.reg_bi_feedback = 0
        self.wd_bi_feedback = 0.0
        self.slr_bi_feedback = 1.0
        self.W_bi = None  # [num_item, num_bi_feedback]
        self._bi_allocated = False

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "reg_bi_feedback":
            self.reg_bi_feedback = int(val)
        if name == "slr_bi_feedback":
            self.slr_bi_feedback = float(val)
        if name == "wd_bi_feedback":
            self.wd_bi_feedback = float(val)
        if not self._bi_allocated:
            self.bparam.set_param(name, val)

    # ---- model lifecycle ----------------------------------------------------
    def init_model(self) -> None:
        super().init_model()
        self.W_bi = jnp.zeros(
            (self.mparam.num_item, self.bparam.num_bi_feedback), jnp.float32
        )
        self._bi_allocated = True

    def load_model(self, f: BinaryIO) -> None:
        super().load_model(f)
        self.bparam.load(f)
        self.W_bi = jnp.asarray(_read_t2d(f))
        self._bi_allocated = True

    def save_model(self, f: BinaryIO) -> None:
        super().save_model(f)
        f.write(self.bparam.to_bytes())
        # de-pad/de-interleave the mesh's row-sharded W_bi for disk
        _write_t2d(f, self._wbi_host())

    # ---- packing: user-property matrix + filtered feedback pool -------------
    def _bi_extras(self, packed):
        """(filtered fb, up, overlap) from a packed plus chunk.

        start_ufeedback filter for the factor path: zero the values of
        filtered entries (they stay in the pool but contribute nothing
        and receive no writeback since delta scales by their value); the
        overlap closed form must reflect the FILTERED pool.  ``up`` is
        the dense per-slot user-property matrix [C, G+1, nbf] built from
        the RAW pool values."""
        m = self.model
        fb = packed.fb_arrays()
        start = self.bparam.start_ufeedback
        overlap = packed.fb_overlap
        if start > 0:
            local = fb["fb_idx"] - m.off_ufeedback
            keep = local >= start
            fb = dict(fb, fb_val=np.where(keep, fb["fb_val"], 0.0).astype(np.float32))
            from ..data.batching_plus import compute_fb_overlap

            overlap = compute_fb_overlap(
                fb["fb_idx"], fb["fb_val"], fb["fb_block"],
                packed.num_blocks_local,
            )
        nbf = self.bparam.num_bi_feedback
        C, F = packed.fb_idx.shape
        G = packed.num_blocks_local
        up = np.zeros((C, G + 1, nbf), np.float32)
        raw = packed.fb_arrays()
        local = raw["fb_idx"].astype(np.int64) - m.off_ufeedback
        for c in range(C):
            mask = (local[c] >= 0) & (local[c] < nbf) & (raw["fb_block"][c] < G)
            if mask.any():
                up[c, raw["fb_block"][c][mask], local[c][mask]] = raw["fb_val"][c][mask]
        return fb, up, overlap

    def _pack_plus(self, ds: PlusDataset, cache: bool = True):
        key = (id(ds), "bi")
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
                rows_per_user=self.rows_per_user,
            )
            fb, up, overlap = self._bi_extras(packed)
            nbf = self.bparam.num_bi_feedback
            if self._mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                from ..parallel.svdpp_mesh import pad_plus_for_mesh

                host_arrays = packed.device_arrays()
                host_arrays.pop("chunk_id", None)
                G = packed.num_blocks_local
                M = packed.rows_per_user
                arrays, fbd, Gp, _ = pad_plus_for_mesh(
                    host_arrays, fb, G, self.mesh_data, m.num_rows,
                    m.param.num_global, M=M,
                )
                if Gp != G:  # widen the per-user property matrix to Gp+1
                    pad = np.zeros((up.shape[0], Gp - G, nbf), np.float32)
                    up = np.concatenate([up[:, :G], pad, up[:, G:]], axis=1)
                sh = lambda v: NamedSharding(
                    self._mesh,
                    P(None, "data") if v.ndim == 2 else P(None, "data", None),
                )
                rep = NamedSharding(self._mesh, P())
                GS = G * M
                entry = (
                    {k: jax.device_put(v, sh(v)) for k, v in arrays.items()},
                    jax.device_put(packed.chunk_id, rep),
                    {k: jax.device_put(v, rep) for k, v in fbd.items()},
                    (packed.perm // GS) * (Gp * M) + packed.perm % GS,
                    jax.device_put(up, rep),
                    None,  # overlap unused on the mesh path (per-batch refresh)
                )
                if not cache:
                    return entry
                self._pack_cache[key] = entry
                return self._pack_cache[key]
            entry = (
                jax.device_put(packed.device_arrays()),
                jax.device_put(packed.chunk_id),
                jax.device_put(fb),
                packed.perm,
                jax.device_put(up),
                jax.device_put(overlap),
            )
            if not cache:
                return entry
            self._pack_cache[key] = entry
        return self._pack_cache[key]

    # ---- streaming (out-of-core user-group buffers) -----------------------
    def pack_plus_chunk(self, chunk: PlusDataset, caps: dict):
        """Pack one streamed user-group chunk with the bilinear extras
        (filtered pool, per-slot property matrix, filtered overlap) at
        the stream's stable shapes."""
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
        fb, up, overlap = self._bi_extras(packed)
        arrays = packed.device_arrays()
        if self._mesh is not None:
            from ..parallel.svdpp_mesh import pad_plus_for_mesh

            arrays.pop("chunk_id", None)
            G = packed.num_blocks_local
            arrays, fb, Gp, _ = pad_plus_for_mesh(
                arrays, fb, G, self.mesh_data, m.num_rows, m.param.num_global,
                M=packed.rows_per_user,
            )
            if Gp != G:
                nbf = self.bparam.num_bi_feedback
                pad = np.zeros((up.shape[0], Gp - G, nbf), np.float32)
                up = np.concatenate([up[:, :G], pad, up[:, G:]], axis=1)
        return (arrays, packed.chunk_id, fb, up, overlap)

    def stage_chunk_plus(self, entry):
        stacked, chunk_id, fb, up, overlap = entry
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.mesh import put_process_sharded

            rep = NamedSharding(self._mesh, P())
            return (
                put_process_sharded(stacked, self._mesh),
                jax.device_put(chunk_id, rep),
                {k: jax.device_put(v, rep) for k, v in fb.items()},
                jax.device_put(up, rep),
                None,  # overlap unused on the mesh path
            )
        return jax.device_put(entry)

    def train_chunk_plus(self, entry) -> None:
        stacked, chunk_id, fb, up, overlap = entry
        self._train_packed((stacked, chunk_id, fb, None, up, overlap))

    def _train_packed(self, entry) -> None:
        stacked, chunk_id, fb, _, up, overlap = entry
        if self._mesh is not None:
            M = self.rows_per_user
            G = stacked["label"].shape[1] // M
            F = fb["fb_idx"].shape[1]
            key = ("bi", G, F, M, self._mesh_big)
            if key not in self._plus_sharded:
                if self._mesh_big:
                    from ..parallel.bilinear_mesh_big import (
                        sharded_bilinear_rounds_big,
                    )

                    self._plus_sharded[key] = sharded_bilinear_rounds_big(
                        self._mesh, self.hp, self._n_real, self._nb_real,
                        G, F, self.model.off_item, self.mparam.num_item,
                        self.reg_bi_feedback,
                        self.tparam.scale_lr_ufeedback,
                        self.tparam.wd_ufeedback,
                        self.tparam.wd_ufeedback_bias,
                        self.slr_bi_feedback,
                        self.wd_bi_feedback,
                        M=M,
                    )
                else:
                    from ..parallel.bilinear_mesh import sharded_bilinear_rounds

                    self._plus_sharded[key] = sharded_bilinear_rounds(
                        self._mesh, self.hp, self._n_pad, self._n_bi_pad, G, F,
                        self.model.off_item, self.reg_bi_feedback,
                        self.tparam.scale_lr_ufeedback,
                        self.tparam.wd_ufeedback,
                        self.tparam.wd_ufeedback_bias,
                        self.slr_bi_feedback,
                        self.wd_bi_feedback,
                        M=M,
                    )
            self.state, self.W_bi = self._plus_sharded[key](
                self.state, self.W_bi, stacked, chunk_id, fb, up,
                jnp.asarray([self.learning_rate], jnp.float32), self.consts,
            )
            return
        if self.model.param.common_feedback_space:
            # pool rows alias user rows: overlap closed form invalid,
            # refresh per batch
            self.state, self.W_bi = train_epoch_bi_refresh(
                self.state, self.W_bi, stacked, chunk_id, fb, up,
                jnp.float32(self.learning_rate), self.consts, self.hp,
                self.tparam.scale_lr_ufeedback,
                self.tparam.wd_ufeedback,
                self.tparam.wd_ufeedback_bias,
                self.slr_bi_feedback,
                self.wd_bi_feedback,
                self.reg_bi_feedback,
                self.model.off_item,
                rows_per_user=self.rows_per_user,
            )
            return
        if self.hp.big_table:
            from ..ops.svdpp_bilinear import train_epoch_bi_big

            self.state, self.W_bi = train_epoch_bi_big(
                self.state, self.W_bi, stacked, chunk_id, fb, overlap, up,
                jnp.float32(self.learning_rate), self.consts, self.hp,
                self.tparam.scale_lr_ufeedback,
                self.tparam.wd_ufeedback,
                self.tparam.wd_ufeedback_bias,
                self.slr_bi_feedback,
                self.wd_bi_feedback,
                self.reg_bi_feedback,
                self.model.off_item,
                rows_per_user=self.rows_per_user,
            )
            return
        self.state, self.W_bi = train_epoch_bi(
            self.state,
            self.W_bi,
            stacked,
            chunk_id,
            fb,
            overlap,
            up,
            jnp.float32(self.learning_rate),
            self.consts,
            self.hp,
            self.tparam.scale_lr_ufeedback,
            self.tparam.wd_ufeedback,
            self.tparam.wd_ufeedback_bias,
            self.slr_bi_feedback,
            self.wd_bi_feedback,
            self.reg_bi_feedback,
            self.model.off_item,
            rows_per_user=self.rows_per_user,
        )

    def _bi_predict_fn(self, G, F, M=1):
        """Sharded bilinear inference builder: standard slabs or
        (mesh_big) the augmented big-slab forward (consts bound for the
        gather-time lazy views)."""
        if self._mesh_big:
            from ..parallel.bilinear_mesh_big import sharded_bilinear_predict_big

            inner = sharded_bilinear_predict_big(
                self._mesh, self.hp, self._n_real, self._nb_real, G, F,
                self.model.off_item, self.mparam.num_item, M=M,
            )
            return lambda st, Wb, stacked, cid, fb, up: inner(
                st, Wb, stacked, cid, fb, up, self.consts
            )
        from ..parallel.bilinear_mesh import sharded_bilinear_predict

        return sharded_bilinear_predict(
            self._mesh, self.hp, self._n_pad, self._n_bi_pad, G, F,
            self.model.off_item, M=M,
        )

    def predict_all(self, ds) -> np.ndarray:
        if hasattr(ds, "plan_caps"):  # streaming source: bounded-memory eval
            return self._predict_streamed_bi(ds)
        if hasattr(ds, "epoch_dataset"):
            entry = self._pack_plus(ds.epoch_dataset(), cache=False)
        elif isinstance(ds, PlusDataset):
            entry = self._pack_plus(ds)
        else:
            return super(SVDPPFeatureTrainer, self).predict_all(ds)
        stacked, chunk_id, fb, perm, up, _ = entry
        if self._mesh is not None:
            M = self.rows_per_user
            G = stacked["label"].shape[1] // M
            F = fb["fb_idx"].shape[1]
            key = ("bi-pred", G, F, M, self._mesh_big)
            if key not in self._plus_sharded:
                self._plus_sharded[key] = self._bi_predict_fn(G, F, M)
            preds = np.asarray(
                self._plus_sharded[key](
                    self.state, self.W_bi, stacked, chunk_id, fb, up
                )
            ).reshape(-1)
            return preds[perm]
        preds = np.asarray(
            predict_batches_bi(
                self.state_or_model(),
                self.W_bi,
                stacked,
                chunk_id,
                fb,
                up,
                self.hp,
                self.model.off_item,
                rows_per_user=self.rows_per_user,
            )
        ).reshape(-1)
        return preds[perm]

    def _predict_streamed_bi(self, ds) -> np.ndarray:
        """Bounded-memory streamed eval with the bilinear extras; mirrors
        SVDPPFeatureTrainer.predict_all's plan_caps branch."""
        m = self.model
        caps = dict(ds.plan_caps(self.users_per_batch, self.rows_per_user))
        caps["seg_caps"] = self._stream_seg_caps(caps["seg_caps"])
        st = None if self._mesh is not None else self.state_or_model()
        out = []
        for chunk in ds.chunks():
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
                **caps,
            )
            fb, up, _ = self._bi_extras(packed)
            if self._mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                from ..parallel.mesh import put_process_sharded
                from ..parallel.svdpp_mesh import pad_plus_for_mesh

                arrays = packed.device_arrays()
                arrays.pop("chunk_id", None)
                G = packed.num_blocks_local
                M = packed.rows_per_user
                arrays, fbd, Gp, Fp = pad_plus_for_mesh(
                    arrays, fb, G, self.mesh_data, m.num_rows,
                    m.param.num_global, M=M,
                )
                if Gp != G:
                    nbf = self.bparam.num_bi_feedback
                    pad = np.zeros((up.shape[0], Gp - G, nbf), np.float32)
                    up = np.concatenate([up[:, :G], pad, up[:, G:]], axis=1)
                key = ("bi-pred", Gp, Fp, M, self._mesh_big)
                if key not in self._plus_sharded:
                    self._plus_sharded[key] = self._bi_predict_fn(Gp, Fp, M)
                rep = NamedSharding(self._mesh, P())
                preds = self._plus_sharded[key](
                    self.state,
                    self.W_bi,
                    put_process_sharded(arrays, self._mesh),
                    jax.device_put(packed.chunk_id, rep),
                    {k: jax.device_put(v, rep) for k, v in fbd.items()},
                    jax.device_put(up, rep),
                )
                if jax.process_count() > 1:
                    from jax.experimental.multihost_utils import process_allgather

                    preds = process_allgather(preds, tiled=True)
                GS = G * M
                perm = (packed.perm // GS) * (Gp * M) + packed.perm % GS
                out.append(np.asarray(preds).reshape(-1)[perm])
                continue
            preds = np.asarray(
                predict_batches_bi(
                    st, self.W_bi, packed.device_arrays(), packed.chunk_id,
                    fb, up, self.hp, self.model.off_item,
                    rows_per_user=self.rows_per_user,
                )
            ).reshape(-1)
            out.append(preds[packed.perm])
        return np.concatenate(out) if out else np.zeros(0, np.float32)
