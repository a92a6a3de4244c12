"""Multi-IMFB trainer (extend_type=2): local implicit feedback stacks.

Re-design of SVDPPMultiIMFB (solvers/multi-imfb/apex_multi_imfb.h:31-194);
see ops/imfb.py and data/batching_imfb.py.  Config key
``ufeedback_disable_level`` (repeatable) disables feedback updates at the
given stack depth (:54-63).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..data.batching_imfb import pack_imfb
from ..data.csr import TAG_DEFAULT, PlusDataset
from ..ops.imfb import (
    predict_batches_imfb,
    train_epoch_imfb,
    train_epoch_imfb_big,
    train_epoch_imfb_carried,
)
from .svdpp import SVDPPFeatureTrainer


class SVDPPMultiIMFBTrainer(SVDPPFeatureTrainer):
    # above ONEHOT_THRESHOLD the stacked epoch rides the augmented layout
    # (ops/imfb.train_epoch_imfb_big): row updates via _forward_entries +
    # dedup writes, context writebacks via _fb_writeback_big keyed fb_ctx
    SUPPORTS_BIG_TABLE = True
    # mesh x big tables: slabs above ONEHOT_THRESHOLD route to the
    # augmented big-slab stacked body (parallel/imfb_mesh_big.py — dedup
    # row updates + dedup context writebacks), same auto rule as the
    # base solver (solvers/base.py _init_mesh)
    SUPPORTS_MESH_BIG = True

    def __init__(self, mtype):
        super().__init__(mtype)
        self.disable_levels = set()
        self._plain_cache = {}

    def _plain_svdpp(self, ds) -> bool:
        """An all-DEFAULT tag stream degenerates to plain SVD++: every
        block pushes its own feedback, processes its rows, pops — depth
        stays 0 throughout (apex_multi_imfb.h:31-194 reduces to
        apex_svd_base.h:484-592), verified to float roundoff
        (tests/test_side_solvers.py).  Such datasets take the WHOLE
        SVD++ fast path (sort_blocks, rows_per_user, streaming) unless
        depth-0 updates are disabled."""
        if 0 in self.disable_levels:
            return False
        key = id(ds)
        if key not in self._plain_cache:
            if isinstance(ds, PlusDataset):
                plain = bool((ds.extend_tag == TAG_DEFAULT).all())
            elif hasattr(ds, "phys"):  # StreamingPlusBuffer pre-scan
                plain = all(tag == TAG_DEFAULT for _, _, tag in ds.phys)
            else:
                plain = False
            self._plain_cache[key] = plain
        return self._plain_cache[key]

    def _stream_round_plus(self, ds) -> None:
        if self._plain_svdpp(ds):
            return super()._stream_round_plus(ds)
        # stacked out-of-core training: the reference trains extend_type=2
        # from its binary buffer in bounded memory like every solver
        # (apex_buffer_loader.h:39-233 feeding apex_multi_imfb.h:31-194);
        # here the stream's stacked-aware cap pre-scan bounds per-chunk
        # (depth, contexts, pool entries) and open contexts carry across
        # chunks (StreamingPlusBuffer.plan_caps_imfb / chunks_imfb)
        from ..data.streaming import stream_train_round_imfb

        if self.sort_blocks and self.rows_per_user > 2:
            import warnings

            # same measured frontier as the staged path (_pack_plus)
            warnings.warn(
                "sort_blocks=1 with rows_per_user>2 on STACKED data is "
                "measured divergent (PERF.md 'stacked scan frontier') — "
                "keep file order or reduce rows_per_user"
            )
        # sort_blocks streams chunk-locally, like the plain SVD++ path:
        # pack_imfb sorts units within each fragment (context snapshots
        # ride along, so the tag-walk semantics are order-free) and
        # plan_caps_imfb(sort_local) sizes the caps for that ordering
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
        stream_train_round_imfb(self, ds)

    def _imfb_enabled(self, ctx_depth: np.ndarray) -> np.ndarray:
        """Per-(chunk, local-context) update gate from the stack depths
        (ufeedback_disable_level, apex_multi_imfb.h:54-63); the extra
        last column is the always-off pad slot."""
        enabled = np.ones(
            (ctx_depth.shape[0], ctx_depth.shape[1] + 1), np.float32
        )
        enabled[:, -1] = 0.0  # pad slot
        for lvl in self.disable_levels:
            enabled[:, :-1][ctx_depth == lvl] = 0.0
        enabled[:, :-1][ctx_depth < 0] = 0.0  # unused slots
        return enabled

    # ---- streaming (out-of-core stacked sources) ------------------------
    def pack_imfb_chunk(self, chunk, carry, caps: dict):
        """Pack one streamed stacked chunk to the stream's stable shapes;
        ``carry`` holds the feedback contexts still open at the chunk
        boundary (pack_imfb initial_stack)."""
        m = self.model
        caps = dict(caps)
        caps["seg_caps"] = self._stream_seg_caps(caps["seg_caps"])
        packed = pack_imfb(
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
            initial_stack=carry,
            rows_per_user=self.rows_per_user,
            sort_blocks=bool(self.sort_blocks),  # chunk-local ordering
            **caps,
        )
        enabled = self._imfb_enabled(packed.ctx_depth)
        arrays = packed.device_arrays()
        perm = packed.perm
        if self._mesh is not None:
            from ..parallel.imfb_mesh import pad_imfb_for_mesh

            nseg = packed.ctx_depth.shape[1] + 1
            arrays.pop("chunk_id", None)
            fbd = {
                k: getattr(packed, k) for k in ("fb_idx", "fb_val", "fb_ctx")
            }
            G = packed.label.shape[1]
            arrays, fbd, Gp, _ = pad_imfb_for_mesh(
                arrays, fbd, G, self.mesh_data, m.num_rows,
                m.param.num_global, nseg, M=packed.rows_per_user,
            )
            perm = (perm // G) * Gp + perm % G
            overlap = None
        else:
            fbd = packed.fb_arrays()
            overlap = None
            if not m.param.common_feedback_space:
                from ..data.batching_plus import compute_fb_overlap

                overlap = compute_fb_overlap(
                    packed.fb_idx, packed.fb_val, packed.fb_ctx,
                    packed.ctx_depth.shape[1],
                )
        return (arrays, packed.chunk_id, fbd, enabled, overlap, perm)

    def stage_chunk_imfb(self, entry):
        """Device staging for one packed stacked chunk (mesh-aware)."""
        arrays, chunk_id, fbd, enabled, overlap, perm = entry
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.mesh import put_process_sharded

            rep = NamedSharding(self._mesh, P())
            return (
                put_process_sharded(arrays, self._mesh),
                jax.device_put(chunk_id, rep),
                {k: jax.device_put(v, rep) for k, v in fbd.items()},
                jax.device_put(enabled, rep),
                None,
                perm,
            )
        return (
            jax.device_put(arrays),
            jax.device_put(chunk_id),
            jax.device_put(fbd),
            jax.device_put(enabled),
            None if overlap is None else jax.device_put(overlap),
            perm,
        )

    def train_chunk_imfb(self, entry) -> None:
        arrays, chunk_id, fbd, enabled, overlap, _ = entry
        self._train_packed((arrays, chunk_id, fbd, None, enabled, overlap))

    def _predict_streamed_imfb(self, ds) -> np.ndarray:
        """Bounded-memory prediction over a streamed stacked source."""
        caps = ds.plan_caps_imfb(self.users_per_batch, self.rows_per_user)
        out = []
        for chunk, carry in ds.chunks_imfb():
            entry = self.stage_chunk_imfb(self.pack_imfb_chunk(chunk, carry, caps))
            arrays, chunk_id, fbd, enabled, _, perm = entry
            if self._mesh is not None:
                G = arrays["label"].shape[1]
                F = fbd["fb_idx"].shape[1]
                nseg = enabled.shape[1]
                key = ("imfb-pred", G, F, nseg, self._mesh_big)
                if key not in self._plus_sharded:
                    self._plus_sharded[key] = self._imfb_mesh_predict_fn(
                        G, F, nseg
                    )
                preds = self._plus_sharded[key](
                    self.state, arrays, chunk_id, fbd
                )
                if jax.process_count() > 1:
                    from jax.experimental.multihost_utils import (
                        process_allgather,
                    )

                    preds = process_allgather(preds, tiled=True)
                out.append(np.asarray(preds).reshape(-1)[perm])
                continue
            preds = np.asarray(
                predict_batches_imfb(
                    self.state_or_model(), arrays, chunk_id, fbd, self.hp
                )
            ).reshape(-1)
            out.append(preds[perm])
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def set_param(self, name: str, val: str) -> None:
        if name == "ufeedback_disable_level":
            self.disable_levels.add(int(val))
        super().set_param(name, val)

    def _pack_plus(self, ds: PlusDataset, cache: bool = True):
        if self._plain_svdpp(ds):
            return super()._pack_plus(ds, cache)
        if self.sort_blocks and self.rows_per_user > 2:
            import warnings

            warnings.warn(
                "sort_blocks=1 with rows_per_user>2 on STACKED data is "
                "measured divergent (sorted heavy-unit chunks double the "
                "context-coupling gain; PERF.md 'stacked scan frontier') — "
                "keep file order or reduce rows_per_user"
            )
        key = (id(ds), "imfb")
        if not cache or key not in self._pack_cache:
            m = self.model
            packed = pack_imfb(
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
                sort_blocks=bool(self.sort_blocks),
            )
            enabled = self._imfb_enabled(packed.ctx_depth)
            if self._mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                from ..parallel.imfb_mesh import pad_imfb_for_mesh

                nseg = packed.ctx_depth.shape[1] + 1
                host_arrays = packed.device_arrays()
                host_arrays.pop("chunk_id", None)
                fbd = {k: getattr(packed, k) for k in ("fb_idx", "fb_val", "fb_ctx")}
                G = host_arrays["label"].shape[1]
                arrays, fbd, Gp, _ = pad_imfb_for_mesh(
                    host_arrays, fbd, G, self.mesh_data, m.num_rows,
                    m.param.num_global, nseg, M=packed.rows_per_user,
                )
                sh = lambda v: NamedSharding(
                    self._mesh,
                    P(None, "data") if v.ndim == 2 else P(None, "data", None),
                )
                rep = NamedSharding(self._mesh, P())
                entry = (
                    {k: jax.device_put(v, sh(v)) for k, v in arrays.items()},
                    jax.device_put(packed.chunk_id, rep),
                    {k: jax.device_put(v, rep) for k, v in fbd.items()},
                    # remap dataset-row -> packed-slot for the padded G
                    (packed.perm // G) * Gp + packed.perm % G,
                    jax.device_put(enabled, rep),
                    None,  # overlap unused on the mesh path
                )
                if not cache:
                    return entry
                self._pack_cache[key] = entry
                return self._pack_cache[key]
            overlap = None
            if not m.param.common_feedback_space:
                # closed-form carried aggregates need the per-chunk
                # context-overlap matrices (keyed by fb_ctx slots)
                from ..data.batching_plus import compute_fb_overlap

                overlap = jax.device_put(
                    compute_fb_overlap(
                        packed.fb_idx, packed.fb_val, packed.fb_ctx,
                        packed.ctx_depth.shape[1],
                    )
                )
            entry = (
                jax.device_put(packed.device_arrays()),
                jax.device_put(packed.chunk_id),
                jax.device_put(packed.fb_arrays()),
                packed.perm,
                jax.device_put(enabled),
                overlap,
            )
            if not cache:
                return entry
            self._pack_cache[key] = entry
        return self._pack_cache[key]

    def _train_packed(self, entry) -> None:
        if len(entry) == 5:  # plain SVD++ entry (degenerate route)
            return super()._train_packed(entry)
        stacked, chunk_id, fb, _, enabled, _ = entry
        if self._mesh is not None:
            M = self.rows_per_user
            G = stacked["label"].shape[1]  # slots per batch (G_users * M)
            F = fb["fb_idx"].shape[1]
            nseg = enabled.shape[1]
            key = ("imfb", G, F, nseg, M, self._mesh_big)
            if key not in self._plus_sharded:
                if self._mesh_big:
                    from ..parallel.imfb_mesh_big import (
                        sharded_imfb_rounds_big as rounds_fn,
                    )

                    n_arg = self._n_real
                else:
                    from ..parallel.imfb_mesh import (
                        sharded_imfb_rounds as rounds_fn,
                    )

                    n_arg = self._n_pad
                self._plus_sharded[key] = rounds_fn(
                    self._mesh, self.hp, n_arg, G, F, nseg,
                    self.tparam.scale_lr_ufeedback,
                    self.tparam.wd_ufeedback,
                    self.tparam.wd_ufeedback_bias,
                    M=M,
                )
            self.state = self._plus_sharded[key](
                self.state, stacked, chunk_id, fb, enabled,
                jnp.asarray([self.learning_rate], jnp.float32), self.consts,
            )
            return
        self._run_epoch(entry)

    def _epoch_fn(self, entry):
        """The stacked epochs (6-tuple entries); plain SVD++ entries take
        the parent's."""
        if len(entry) == 5:  # plain SVD++ entry (degenerate route)
            return super()._epoch_fn(entry)
        stacked, chunk_id, fb, _, enabled, overlap = entry
        if self.hp.big_table:
            return train_epoch_imfb_big, (stacked, chunk_id, fb, enabled), ()
        if overlap is not None:
            # disjoint feedback space: pool work O(chunks) via the
            # carried closed form (ops/imfb.train_epoch_imfb_carried)
            return (
                train_epoch_imfb_carried,
                (stacked, chunk_id, fb, overlap, enabled),
                (),
            )
        return train_epoch_imfb, (stacked, chunk_id, fb, enabled), ()

    def _imfb_mesh_predict_fn(self, G, F, nseg):
        """Sharded stacked inference builder (standard or big slabs)."""
        if self._mesh_big:
            from ..parallel.imfb_mesh_big import sharded_imfb_predict_big

            inner = sharded_imfb_predict_big(
                self._mesh, self.hp, self._n_real, G, F, nseg
            )
            return lambda st, stacked, cid, fb: inner(
                st, stacked, cid, fb, self.consts
            )
        from ..parallel.imfb_mesh import sharded_imfb_predict

        return sharded_imfb_predict(self._mesh, self.hp, self._n_pad, G, F, nseg)

    def predict_all(self, ds) -> np.ndarray:
        if hasattr(ds, "plan_caps"):  # streaming source
            if self._plain_svdpp(ds):
                return super().predict_all(ds)
            return self._predict_streamed_imfb(ds)
        if isinstance(ds, PlusDataset) and self._plain_svdpp(ds):
            return super().predict_all(ds)
        if hasattr(ds, "epoch_dataset"):
            entry = self._pack_plus(ds.epoch_dataset(), cache=False)
        elif isinstance(ds, PlusDataset):
            entry = self._pack_plus(ds)
        else:
            return super(SVDPPFeatureTrainer, self).predict_all(ds)
        stacked, chunk_id, fb, perm, enabled, _ = entry
        if self._mesh is not None:
            # sharded inference — tables stay row-sharded on the mesh
            G = stacked["label"].shape[1]
            F = fb["fb_idx"].shape[1]
            nseg = enabled.shape[1]
            key = ("imfb-pred", G, F, nseg, self._mesh_big)
            if key not in self._plus_sharded:
                self._plus_sharded[key] = self._imfb_mesh_predict_fn(G, F, nseg)
            preds = np.asarray(
                self._plus_sharded[key](self.state, stacked, chunk_id, fb)
            ).reshape(-1)
            return preds[perm]
        preds = np.asarray(
            predict_batches_imfb(self.state_or_model(), stacked, chunk_id, fb, self.hp)
        ).reshape(-1)
        return preds[perm]
