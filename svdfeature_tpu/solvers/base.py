"""Base SGD solver: the batched SVDFeature trainer.

Re-design of class SVDFeature (solvers/base-solver/apex_svd_base.h:79-479).
The trainer owns the model pytree (with dummy padding rows appended), packs
datasets into fixed-shape stacked batches once, stages them on device, and
runs each round as a single on-device lax.scan of the fused train step.
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.batching import PackedBatches, pack_csr
from ..data.csr import CSRDataset
from ..model import SVDModel
from ..ops.embed import (
    HyperParams,
    TrainConsts,
    TrainState,
    predict_batches,
    train_epoch,
    train_rounds,
)
from ..params import ParameterSet, SVDModelParam, SVDTrainParam, SVDTypeParam
from ..utils.sparse_feature_array import SparseFeatureArray

DEFAULT_BATCH_SIZE = 1024


class SVDFeatureTrainer:
    """Random-order-format trainer (ISVDTrainer contract, apex_svd.h:33-107)."""

    # large tables route to the sorted-dedup augmented-row step
    # (ops/big_embed.py); derived solvers whose epoch kernels drive the
    # state directly (SVD++ family) opt out until wired
    SUPPORTS_BIG_TABLE = True
    # big-slab MESH path (parallel/mesh_big.py): augmented sharded slabs +
    # per-shard dedup writes.  Solvers with their own mesh step bodies
    # (SVD++ family) keep the standard slab layout until wired
    SUPPORTS_MESH_BIG = True

    def __init__(self, mtype: SVDTypeParam):
        self.mtype = mtype
        self.mparam = SVDModelParam()
        self.tparam = SVDTrainParam()
        self.u_param = ParameterSet("up:", "uip:")
        self.i_param = ParameterSet("ip:", "uip:")
        self.g_param = ParameterSet("gp:", "gp:")
        self.name_feat_user: Optional[str] = None
        self.name_feat_item: Optional[str] = None
        self.feat_user: Optional[SparseFeatureArray] = None
        self.feat_item: Optional[SparseFeatureArray] = None
        self.batch_size = DEFAULT_BATCH_SIZE
        self.seed = 10
        # exact_rng=1: init draws come from the bit-exact apex_random port
        # (glibc rand), matching the reference binary's round-0 snapshot
        # byte-for-byte; numpy RandomState otherwise (fast, vectorized)
        self.exact_rng = False
        self.round_counter = 0
        self.learning_rate: float = 0.01
        self.model: Optional[SVDModel] = None
        self.state: Optional[TrainState] = None
        self.consts: Optional[TrainConsts] = None
        self.hp: Optional[HyperParams] = None
        self._space_allocated = False
        self._pack_cache: Dict[int, object] = {}
        # multi-chip: mesh_data x mesh_model devices (parallel/mesh.py);
        # 1x1 = single-device fused path
        self.mesh_data = 1
        self.mesh_model = 1
        # mesh_big: sorted-dedup big-slab mesh path (parallel/mesh_big.py).
        # -1 = auto (on when a shard's slab exceeds ONEHOT_THRESHOLD rows
        # and the backend's capability row says so), 0 = off, 1 = force on
        self.mesh_big = -1
        self._mesh_big = False
        self._n_real: Optional[int] = None
        self._mesh = None
        self._n_pad: Optional[int] = None
        self._tbl_rows: Optional[int] = None  # unpadded table rows incl. dummy
        self._sharded_rounds = None
        self._sharded_pred = None

    # ---- configuration -----------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        if name == "feature_user":
            self.name_feat_user = val
        if name == "feature_item":
            self.name_feat_item = val
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "mesh_data":
            self.mesh_data = int(val)
        if name == "mesh_model":
            self.mesh_model = int(val)
        if name == "mesh_big":
            self.mesh_big = int(val)
        if name == "seed":
            self.seed = int(val)
        if name == "exact_rng":
            self.exact_rng = bool(int(val))
        self.tparam.set_param(name, val)
        self.u_param.set_param(name, val)
        self.i_param.set_param(name, val)
        self.g_param.set_param(name, val)
        if not self._space_allocated:
            self.mparam.set_param(name, val)

    # ---- model lifecycle ----------------------------------------------------
    def init_model(self) -> None:
        self.model = SVDModel.rand_init(
            self.mparam, self.mtype, seed=self.seed, exact_rng=self.exact_rng
        )
        self.mparam = self.model.param  # base_score transformed
        self._space_allocated = True

    def load_model(self, f: BinaryIO) -> None:
        self.model = SVDModel.load(f, self.mtype)
        self.mparam = self.model.param
        self._space_allocated = True

    def save_model(self, f: BinaryIO) -> None:
        self._sync_model_from_state()
        self.model.save(f)

    def _std_state(self) -> TrainState:
        """State in the standard (w,b,ref) layout regardless of the
        big-table augmented packing (single-device or mesh big slabs)."""
        if self._mesh_big:
            from ..parallel.mesh_big import unshard_state_big

            return unshard_state_big(
                self.state, self.mesh_model, self.hp.num_factor, self._tbl_rows
            )
        if self.hp is not None and self.hp.big_table:
            from ..ops.big_embed import deaugment_state

            return deaugment_state(
                self.state, self.hp.num_factor, n_rows=self.model.num_rows + 1
            )
        return self.state

    def _sync_model_from_state(self) -> None:
        if self.state is not None:
            st = self._std_state()
            n = self.model.num_rows  # excludes dummy + mesh padding rows
            self.model = dataclasses.replace(
                self.model,
                w=st.w[:n],
                b=st.b[:n],
                g=st.g[:-1],
            )

    # ---- trainer lifecycle ---------------------------------------------------
    def init_trainer(self) -> None:
        if self.name_feat_user and self.name_feat_user != "NULL":
            self.feat_user = SparseFeatureArray.load(self.name_feat_user)
        if self.name_feat_item and self.name_feat_item != "NULL":
            self.feat_item = SparseFeatureArray.load(self.name_feat_item)
        m = self.model
        n = m.num_rows
        k = m.num_factor
        # dummy row appended for padding targets
        self.state = TrainState(
            w=jnp.concatenate([m.w, jnp.zeros((1, k), jnp.float32)]),
            b=jnp.concatenate([m.b, jnp.zeros((1,), jnp.float32)]),
            g=jnp.concatenate([m.g, jnp.zeros((1,), jnp.float32)]),
            step=jnp.zeros((), jnp.int32),
            ref_ui=jnp.zeros((n + 1,), jnp.int32),
            ref_g=jnp.zeros((m.param.num_global + 1,), jnp.int32),
        )
        self.consts = self._build_consts()
        self.hp = self._build_hp()
        self.learning_rate = self.tparam.learning_rate
        self.round_counter = 0
        if self.mesh_data * self.mesh_model > 1:
            self._init_mesh()
        elif self.hp.big_table:
            from ..ops.big_embed import augment_state

            self.state = augment_state(self.state, k)

    def _init_mesh(self) -> None:
        """Shard the trainer over a (mesh_data x mesh_model) device mesh."""
        from ..parallel.mesh import (
            make_mesh,
            shard_consts,
            shard_state,
            sharded_train_rounds,
        )

        need = self.mesh_data * self.mesh_model
        devs = jax.devices()
        if len(devs) < need:
            # never move to another platform: a mesh that does not fit
            # the default backend is a configuration error
            raise ValueError(
                f"mesh_data*mesh_model={need} exceeds the "
                f"{len(devs)} {devs[0].platform} devices of the default backend"
            )
        self._check_mesh_supported()
        # data-sharded batches need B % mesh_data == 0
        if self.batch_size % self.mesh_data:
            self.batch_size += self.mesh_data - self.batch_size % self.mesh_data
        self._tbl_rows = int(self.state.w.shape[0])
        self._mesh = make_mesh(self.mesh_data, self.mesh_model, devs)
        # big slabs: above ONEHOT_THRESHOLD local rows the sorted-dedup
        # big-slab path (parallel/mesh_big.py) takes the updates
        from .. import backend
        from ..ops.embed import ONEHOT_THRESHOLD

        slab = -(-self._tbl_rows // self.mesh_model)
        auto_big = (
            slab > ONEHOT_THRESHOLD and backend.capabilities().accelerator
        )
        use_big = self.SUPPORTS_MESH_BIG and (
            self.mesh_big == 1 or (self.mesh_big == -1 and auto_big)
        )
        if use_big:
            from ..parallel.mesh_big import (
                shard_consts_big,
                shard_state_big,
                sharded_train_rounds_big,
            )

            k = self.model.num_factor
            self.hp = dataclasses.replace(
                self.hp, num_factor=k, big_table=False
            )
            self._mesh_big = True
            self.state, self._n_real = shard_state_big(self.state, self._mesh, k)
            self.consts = shard_consts_big(self.consts, self._mesh, self._n_real)
            self._sharded_rounds = sharded_train_rounds_big(
                self._mesh, self.hp, self._n_real
            )
            return
        self.state, self._n_pad = shard_state(self.state, self._mesh)
        self.consts = shard_consts(self.consts, self._mesh, self._n_pad)
        self._sharded_rounds = sharded_train_rounds(self._mesh, self.hp, self._n_pad)

    def _check_mesh_supported(self) -> None:
        """Base solver: all reg modes are sharded (0-3 eager via the local
        slab, 4/5 lazy via sharded ref counters)."""

    def _build_hp(self) -> HyperParams:
        p = self.model.param
        from ..ops.embed import ONEHOT_THRESHOLD

        # the sorted-dedup big-table path applies off-mesh only (the mesh
        # path row-shards the table into per-device slabs instead)
        big = (
            self.SUPPORTS_BIG_TABLE
            and self.model.num_rows + 1 > ONEHOT_THRESHOLD
            and self.mesh_data * self.mesh_model == 1
        )
        return HyperParams(
            big_table=big,
            num_factor=p.num_factor if big else 0,
            active_type=self.mtype.active_type,
            no_user_bias=p.no_user_bias,
            reg_method=self.tparam.reg_method,
            reg_global=self.tparam.reg_global,
            user_nonnegative=p.user_nonnegative,
            item_nonnegative=p.item_nonnegative,
            base_score=float(p.base_score),
            # batch_size=1 selects the reference's plain global update
            # (apex_svd_base.h:384-387); larger batches use the damped
            # batched variant (ops/embed._update_global)
            exact_global=(self.batch_size == 1),
        )

    def _build_consts(self) -> TrainConsts:
        """Densify per-row weight-decay tables (ParameterSet ranges override
        the scalar wd over id ranges; apex_svd_base.h:33-75,188-283)."""
        m = self.model
        p = m.param
        n = m.num_rows
        wd_u = np.zeros(n + 1, np.float32)
        wd_i = np.zeros(n + 1, np.float32)
        # ids reaching reg_user are user-local ids; table rows off_user+id
        wd_u[m.off_user : m.off_user + p.num_user] = self.u_param.wd_table(
            p.num_user, self.tparam.wd_user
        )
        wd_i[m.off_item : m.off_item + p.num_item] = self.i_param.wd_table(
            p.num_item, self.tparam.wd_item
        )
        # hierarchical parents live in the same id spaces, covered above
        wd_g = np.zeros(p.num_global + 1, np.float32)
        if p.num_global:
            wd_g[: p.num_global] = self.g_param.wd_table(
                p.num_global, self.tparam.wd_global
            )
            wd_g[: self.tparam.num_regfree_global] = 0.0
        return TrainConsts(
            wd_u_row=jnp.asarray(wd_u),
            wd_i_row=jnp.asarray(wd_i),
            wd_g_row=jnp.asarray(wd_g),
            wd_user_bias=jnp.float32(self.tparam.wd_user_bias),
            wd_item_bias=jnp.float32(self.tparam.wd_item_bias),
        )

    def set_round(self, nround: int) -> None:
        """Learning-rate decay schedule (apex_svd_base.h:470-478)."""
        if self.tparam.decay_learning_rate:
            assert self.round_counter <= nround, "round counter restriction"
            while self.round_counter < nround:
                self.learning_rate *= self.tparam.decay_rate
                self.round_counter += 1

    def finish_round(self) -> None:
        pass

    # ---- data packing ---------------------------------------------------------
    def _pack(self, ds: CSRDataset):
        key = id(ds)
        if key not in self._pack_cache:
            m = self.model
            packed = pack_csr(
                ds,
                self.batch_size,
                m.num_rows,
                m.param.num_global,
                m.off_user,
                m.off_item,
                feat_user=self.feat_user,
                feat_item=self.feat_item,
                num_user=m.param.num_user,
                num_item=m.param.num_item,
            )
            arrays = packed.arrays()
            if self._mesh is not None:
                # multi-process: each host stages only its data slice
                from ..parallel.mesh import put_process_sharded

                arrays = put_process_sharded(arrays, self._mesh)
            else:
                arrays = jax.device_put(arrays)
            self._pack_cache[key] = (arrays, ds.num_row)
        return self._pack_cache[key]

    # ---- streaming (out-of-core) ---------------------------------------------
    def _stream_seg_caps(self, raw_caps):
        """Stable per-row segment caps for streamed chunks.  The stream's
        structure pre-scan measures RAW per-row widths; hierarchical side
        features (SparseFeatureArray) expand each id occurrence by its
        parent list at pack time, so the cap grows by the worst-case
        expansion factor (1 + max parents per id) — stable across chunks,
        one compilation covers the stream."""
        caps = list(raw_caps)
        for seg, feat in ((1, self.feat_user), (2, self.feat_item)):
            if feat is not None and feat.num_row:
                mp = int(np.diff(feat.row_ptr).max(initial=0))
                caps[seg] = int(raw_caps[seg]) * (1 + mp)
        return tuple(caps)

    def pack_chunk(self, chunk: CSRDataset, min_batches: int, max_nnz):
        """Pack one streamed chunk to the stream's stable shapes."""
        m = self.model
        packed = pack_csr(
            chunk,
            self.batch_size,
            m.num_rows,
            m.param.num_global,
            m.off_user,
            m.off_item,
            feat_user=self.feat_user,
            feat_item=self.feat_item,
            num_user=m.param.num_user,
            num_item=m.param.num_item,
            seg_caps=self._stream_seg_caps(max_nnz),
            min_batches=min_batches,
        )
        return packed.arrays(), chunk.num_row

    def stage_chunk(self, arrays):
        """Device staging for one packed chunk: data-sharded over the mesh
        (each host stages only its slice) or a plain device_put."""
        if self._mesh is not None:
            from ..parallel.mesh import put_process_sharded

            return put_process_sharded(arrays, self._mesh)
        return jax.device_put(arrays)

    def train_chunk(self, arrays) -> None:
        """One on-device pass over a staged chunk (dispatch is async, so
        the producer thread's next pack/transfer overlaps this)."""
        if self._mesh is not None:
            self.state = self._sharded_rounds(
                self.state,
                arrays,
                jnp.asarray([self.learning_rate], jnp.float32),
                self.consts,
            )
            return
        self.state = train_epoch(
            self.state, arrays, jnp.float32(self.learning_rate), self.consts, self.hp
        )

    def _round_stream_chunk(self, ds) -> None:
        """Round examples_per_chunk down to a batch_size multiple (up for
        tiny values): the streamed trajectory equals the staged run only
        when every chunk splits into whole batches (data/streaming.py
        module docstring); validated here, at the first use of the
        source, rather than silently diverging."""
        epc = ds.examples_per_chunk
        if epc % self.batch_size:
            new = max(self.batch_size, epc - epc % self.batch_size)
            import warnings

            warnings.warn(
                f"streaming: examples_per_chunk={epc} is not a multiple of "
                f"batch_size={self.batch_size}; rounding to {new} to keep "
                "the staged-run trajectory guarantee"
            )
            ds.examples_per_chunk = new

    # ---- training / prediction --------------------------------------------------
    def update_all(self, ds: CSRDataset) -> None:
        """One pass over the dataset (one round)."""
        if hasattr(ds, "chunks"):  # streaming source (data/streaming.py)
            from ..data.streaming import stream_train_round

            self._round_stream_chunk(ds)
            stream_train_round(self, ds)
            return
        stacked, _ = self._pack(ds)
        if self._mesh is not None:
            self.state = self._sharded_rounds(
                self.state,
                stacked,
                jnp.asarray([self.learning_rate], jnp.float32),
                self.consts,
            )
            return
        self.state = train_epoch(
            self.state, stacked, jnp.float32(self.learning_rate), self.consts, self.hp
        )

    def update_rounds(self, ds: CSRDataset, num_rounds: int) -> None:
        """Run num_rounds full passes in one device dispatch, applying the
        per-round lr decay schedule (set_round semantics) on device."""
        if hasattr(ds, "chunks"):  # streaming: one host-driven pass/round
            for _ in range(num_rounds):
                self.update_all(ds)
                if self.tparam.decay_learning_rate:
                    self.learning_rate *= self.tparam.decay_rate
                    self.round_counter += 1
            return
        stacked, _ = self._pack(ds)
        lrs = []
        for _ in range(num_rounds):
            lrs.append(self.learning_rate)
            if self.tparam.decay_learning_rate:
                self.learning_rate *= self.tparam.decay_rate
                self.round_counter += 1
        lrs = jnp.asarray(lrs, jnp.float32)
        if self._mesh is not None:
            self.state = self._sharded_rounds(self.state, stacked, lrs, self.consts)
            return
        self.state = train_rounds(self.state, stacked, lrs, self.consts, self.hp)

    def predict_all(self, ds: CSRDataset) -> np.ndarray:
        if hasattr(ds, "chunks"):  # streaming source: bounded-memory eval
            # (the reference's task_eval consumes the thread iterator the
            # same way, svd_feature_infer.cpp:243-277)
            Tc = -(-min(ds.examples_per_chunk, ds.num_row) // self.batch_size)
            if self._mesh is not None:
                # sharded streamed eval: tables stay row-sharded, each
                # chunk is data-sharded and scored on the mesh
                if self._sharded_pred is None:
                    if self._mesh_big:
                        from ..parallel.mesh_big import sharded_predict_big

                        self._sharded_pred = sharded_predict_big(
                            self._mesh, self.hp, self._n_real
                        )
                    else:
                        from ..parallel.mesh import sharded_predict

                        self._sharded_pred = sharded_predict(
                            self._mesh, self.hp, self._n_pad
                        )
                out = []
                for chunk in ds.chunks():
                    arrays, nrow = self.pack_chunk(chunk, Tc, ds.max_nnz)
                    preds = self._sharded_pred(self.state, self.stage_chunk(arrays))
                    if jax.process_count() > 1:
                        from jax.experimental.multihost_utils import (
                            process_allgather,
                        )

                        preds = process_allgather(preds, tiled=True)
                    out.append(np.asarray(preds).reshape(-1)[:nrow])
                return np.concatenate(out) if out else np.zeros(0, np.float32)
            st = self.state_or_model()
            out = []
            for chunk in ds.chunks():
                arrays, nrow = self.pack_chunk(chunk, Tc, ds.max_nnz)
                preds = predict_batches(st, jax.device_put(arrays), self.hp)
                out.append(np.asarray(preds).reshape(-1)[:nrow])
            return (
                np.concatenate(out) if out else np.zeros(0, np.float32)
            )
        stacked, nrow = self._pack(ds)
        if self._mesh is not None:
            # inference runs on the mesh itself — tables stay row-sharded
            # (parallel/mesh.sharded_predict); single-process only fetches
            # the [T, B] prediction matrix, never the table
            if self._sharded_pred is None:
                if self._mesh_big:
                    from ..parallel.mesh_big import sharded_predict_big

                    self._sharded_pred = sharded_predict_big(
                        self._mesh, self.hp, self._n_real
                    )
                else:
                    from ..parallel.mesh import sharded_predict

                    self._sharded_pred = sharded_predict(
                        self._mesh, self.hp, self._n_pad
                    )
            preds = self._sharded_pred(self.state, stacked)
            if jax.process_count() > 1:
                from jax.experimental.multihost_utils import process_allgather

                preds = process_allgather(preds, tiled=True)
            return np.asarray(preds).reshape(-1)[:nrow]
        preds = predict_batches(self.state_or_model(), stacked, self.hp)
        return np.asarray(preds).reshape(-1)[:nrow]

    def state_or_model(self) -> TrainState:
        if self.state is None:
            self.init_trainer()
        if self._mesh_big or (self.hp is not None and self.hp.big_table):
            return self._std_state()
        if self._mesh is not None:
            # inference uses the single-device layout: drop mesh padding rows
            n = self._tbl_rows
            return TrainState(
                w=jnp.asarray(self.state.w[:n]),
                b=jnp.asarray(self.state.b[:n]),
                g=jnp.asarray(self.state.g),
                step=self.state.step,
                ref_ui=jnp.asarray(self.state.ref_ui[:n]),
                ref_g=self.state.ref_g,
            )
        return self.state
