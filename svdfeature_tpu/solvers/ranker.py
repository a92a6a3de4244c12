"""Ranker: batched re-design of the tag-driven streaming rank engine.

Re-design of SVDFeatureRanker (solvers/base-solver/apex_svd_base.h:
597-813).  The reference is a per-row state machine (tags in the label
field: ITEM=0 defines a candidate, USER=2 starts a user section, POS=1 /
BAN=-1 tag candidates, SPEC=3 adds pair-specific scores, PROCESS=4 ranks
and emits).  Here the protocol is parsed on the host into (a) one candidate
item matrix and (b) per-user sections, and scoring becomes one matmul
``scores = U @ ifactors^T + bias`` over all users at once, with banned
candidates masked and rank positions computed by score comparison.
"""

from __future__ import annotations

from typing import BinaryIO, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.csr import CSRDataset, PlusDataset
from ..data.batching import _pad_segment
from ..data.batching_plus import merge_split_blocks
from ..model import SVDModel
from ..params import SVDTypeParam, svd_type, svdranker_tag as tag
from ..utils.sparse_feature_array import SparseFeatureArray


class SVDFeatureRanker:
    def __init__(self, mtype: SVDTypeParam):
        self.mtype = mtype
        self.top_k = 0
        self.num_item_set = 0
        self.name_feat_user: Optional[str] = None
        self.name_feat_item: Optional[str] = None
        self.feat_user: Optional[SparseFeatureArray] = None
        self.feat_item: Optional[SparseFeatureArray] = None
        self.model: Optional[SVDModel] = None

    def set_param(self, name: str, val: str) -> None:
        if name == "feature_user":
            self.name_feat_user = val
        if name == "feature_item":
            self.name_feat_item = val
        if name == "top_k":
            self.top_k = int(val)

    def load_model(self, f: BinaryIO) -> None:
        self.model = SVDModel.load(f, self.mtype)

    def init_ranker(self, num_item_set: int) -> None:
        self.num_item_set = num_item_set
        if self.name_feat_user and self.name_feat_user != "NULL":
            self.feat_user = SparseFeatureArray.load(self.name_feat_user)
        if self.name_feat_item and self.name_feat_item != "NULL":
            self.feat_item = SparseFeatureArray.load(self.name_feat_item)

    # ------------------------------------------------------------------
    def _expand(self, idx, val, feat, scale_by_parent):
        if feat is None or feat.num_row == 0:
            return idx, val
        ei, ev, _ = feat.expand(
            idx, val, np.zeros(len(idx), np.int64), scale_by_parent
        )
        return np.concatenate([idx, ei]), np.concatenate([val, ev])

    def _ifactor_bias(self, g, u, i):
        """prepare_ifactor (apex_svd_base.h:687-710): item-feature factor
        sum + item bias + global bias contribution, as numpy arrays."""
        m = self.model
        w = np.asarray(m.w)
        b = np.asarray(m.b)
        gb = np.asarray(m.g)
        ii, iv = self._expand(i[0].astype(np.int64), i[1], self.feat_item, True)
        vec = (w[m.off_item + ii] * iv[:, None]).sum(0)
        bias = float((b[m.off_item + ii] * iv).sum())
        if len(g[0]):
            bias += float((gb[g[0].astype(np.int64)] * g[1]).sum())
        return vec, bias

    def process_dataset(self, ds) -> np.ndarray:
        """Run the whole protocol; returns the flat emission list
        (top-k item ids or rank positions of positives)."""
        m = self.model
        w = np.asarray(m.w)
        b = np.asarray(m.b)
        k = m.num_factor
        usergroup = self.mtype.format_type == svd_type.USER_GROUP_FORMAT

        if isinstance(ds, PlusDataset):
            blocks = merge_split_blocks(ds)
        else:
            from ..data.csr import PlusBlock

            blocks = [
                PlusBlock(
                    fb_index=np.zeros(0, np.uint32),
                    fb_value=np.zeros(0, np.float32),
                    data=ds,
                )
            ]

        NI = self.num_item_set
        ifactors = np.zeros((max(NI, 1), k), np.float32)
        ibias = np.zeros(max(NI, 1), np.float32)
        n_item = 0

        # per-user sections gathered for batched scoring
        users: List[dict] = []
        results: List[List[int]] = []
        cur = None
        for blk in blocks:
            fb = None
            if usergroup and blk.num_ufeedback:
                fb = (
                    w[m.off_ufeedback + blk.fb_index.astype(np.int64)]
                    * blk.fb_value[:, None]
                ).sum(0)
            d = blk.data
            for r in range(d.num_row):
                label, g, u, i = d.row(r)
                t = int(label)
                if t == tag.ITEM_TAG:
                    assert n_item < NI, "item instance exceed specified item set size"
                    ifactors[n_item], ibias[n_item] = self._ifactor_bias(g, u, i)
                    n_item += 1
                elif t == tag.USER_TAG:
                    uvec = fb.copy() if fb is not None else np.zeros(k, np.float32)
                    ubias = 0.0
                    ui, uv = self._expand(
                        u[0].astype(np.int64), u[1], self.feat_user, False
                    )
                    uvec += (w[m.off_user + ui] * uv[:, None]).sum(0)
                    cur = dict(
                        u=uvec, pos=[], ban=[], spec=[], spec_score=[]
                    )
                elif t in (tag.POS_SAMPLE, tag.BAN_SAMPLE):
                    for idx in u[0]:
                        idx = int(idx)
                        assert idx < n_item, "sample item index exceed bound"
                        # an item may carry at most one tag per user section
                        # (proc_tag, apex_svd_base.h:741-749: item_tag[idx]==0
                        # asserted before tagging)
                        assert idx not in cur["pos"] and idx not in cur["ban"], (
                            "each pos sample item can not occur in baned sample list"
                        )
                        (cur["pos"] if t == tag.POS_SAMPLE else cur["ban"]).append(idx)
                elif t == tag.SPEC_SAMPLE:
                    assert len(u[0]) == 1, "must specify item index of sample"
                    idx = int(u[0][0])
                    vec, bias = self._ifactor_bias(g, u, i)
                    cur["spec"].append(idx)
                    cur["spec_score"].append(bias + float(vec @ cur["u"]))
                elif t == tag.PROCESS_TAG:
                    users.append(cur)
                    results.append(None)
                    cur = None

        if not users:
            return np.zeros(0, np.int32)

        # batched scoring: one matmul over all user sections
        U = np.stack([usr["u"] for usr in users])  # [nU, k]
        scores = U @ ifactors[:n_item].T + ibias[None, :n_item]  # [nU, NI]
        for ui_, usr in enumerate(users):
            for idx, s in zip(usr["spec"], usr["spec_score"]):
                scores[ui_, idx] += s

        out: List[int] = []
        for ui_, usr in enumerate(users):
            s = scores[ui_].copy()
            ban = np.asarray(usr["ban"], np.int64)
            nonban = np.ones(n_item, bool)
            if len(ban):
                nonban[ban] = False
            if self.top_k > 0:
                cand = np.nonzero(nonban)[0]
                assert len(cand) >= self.top_k, "k can not exceed candidate size"
                order = cand[np.argsort(-s[cand], kind="stable")]
                out.extend(int(x) for x in order[: self.top_k])
            else:
                # rank position of each positive = its index in the
                # descending-score sort of all NON-BANNED candidates
                # (proc_rank, apex_svd_base.h:759-782: banned items are
                # skipped before sorting; positives are always in the
                # candidate list since pos+ban on one item asserts above)
                for p in usr["pos"]:
                    out.append(int(np.sum(nonban & (s > s[p]))))
        return np.asarray(out, np.int32)
