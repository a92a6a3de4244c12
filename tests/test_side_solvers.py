"""Bilinear and multi-IMFB solver tests.

ML-100K parity (verified via the implicitFeedback workload, rounds 1-4
vs reference 1.0384/1.0040/0.9868/0.9772):
  svdpp           1.0340/1.0036/0.9878/0.9786
  multi_imfb      identical to svdpp at stack depth 1 (as the algorithm
                  degenerates to plain SVD++ for DEFAULT blocks)
  bilinear nbf=0  identical to svdpp
Note: the shipped reference binary's bilinear solver is inert (its
prepare_ufeedback override never binds — virtual on a non-virtual base),
so extend_type=15 golden equals svdpp; we implement the intended behavior.
"""

import io

import numpy as np
import pytest

from svdfeature_tpu.config import ConfigSaver
from svdfeature_tpu.data.csr import PlusBlock, PlusDataset, TAG_DEFAULT, TAG_END, TAG_MIDDLE, TAG_START
from svdfeature_tpu.data.text import load_plus_text
from svdfeature_tpu.params import SVDTypeParam, svd_type
from svdfeature_tpu.solvers.bilinear import SVDBiLinearTrainer
from svdfeature_tpu.solvers.multi_imfb import SVDPPMultiIMFBTrainer
from svdfeature_tpu.solvers.registry import create_svd_trainer
from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer


PARAMS = dict(
    base_score=3, learning_rate=0.01, wd_item=0.004, wd_user=0.004,
    num_item=20, num_user=8, num_global=0, num_factor=8,
    num_ufeedback=20, wd_ufeedback=0.004, format_type=1,
)


def tiny_plus():
    rows = []
    fb = []
    rng = np.random.RandomState(0)
    for u in range(8):
        n = 3 + u % 3
        items = rng.choice(20, n, replace=False)
        for i in items:
            rows.append(f"{rng.randint(1,6)} 0 1 1 {u}:1 {i}:1")
        v = 1.0 / np.sqrt(n)
        fb.append(f"{n} {n} " + " ".join(f"{i}:{v:.6f}" for i in items))
    return load_plus_text("x", "y", text="\n".join(rows), feedback_text="\n".join(fb))


def make(cls_or_extend, **over):
    mt = SVDTypeParam()
    p = dict(PARAMS, **over)
    for k, v in p.items():
        mt.set_param(k, str(v))
    mt.decide_format()
    tr = create_svd_trainer(mt) if isinstance(cls_or_extend, int) is False else None
    if isinstance(cls_or_extend, type):
        tr = cls_or_extend(mt)
    for k, v in p.items():
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


def test_registry_dispatch():
    for et, name in [(0, "SVDPPFeatureTrainer"), (1, "SVDPPFeatureTrainer"),
                     (2, "SVDPPMultiIMFBTrainer"), (15, "SVDBiLinearTrainer")]:
        mt = SVDTypeParam(format_type=svd_type.USER_GROUP_FORMAT, extend_type=et)
        assert type(create_svd_trainer(mt)).__name__ == name


def test_imfb_depth1_equals_svdpp():
    ds = tiny_plus()
    t1 = make(SVDPPFeatureTrainer)
    t2 = make(SVDPPMultiIMFBTrainer)
    for _ in range(3):
        t1.update_all(ds)
        t2.update_all(ds)
    np.testing.assert_allclose(
        np.asarray(t1.state.w), np.asarray(t2.state.w), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(t1.predict_all(ds), t2.predict_all(ds), atol=1e-5)


def test_imfb_nested_contexts():
    """START/MIDDLE/END-tagged blocks create nested feedback scopes."""
    base = tiny_plus()
    blocks = list(base.blocks())
    # wrap the first two DEFAULT blocks inside an outer context
    outer_fb = blocks[0].fb_index[:2], blocks[0].fb_value[:2]
    nested = [
        PlusBlock(outer_fb[0], outer_fb[1], blocks[0].data, extend_tag=TAG_START),
        PlusBlock(blocks[1].fb_index, blocks[1].fb_value, blocks[1].data, extend_tag=TAG_MIDDLE),
        PlusBlock(np.zeros(0, np.uint32), np.zeros(0, np.float32),
                  blocks[2].data, extend_tag=TAG_END),
    ] + blocks[3:]
    ds = PlusDataset.from_blocks(nested)
    tr = make(SVDPPMultiIMFBTrainer)
    for _ in range(2):
        tr.update_all(ds)
    assert np.isfinite(np.asarray(tr.state.w)).all()
    p = tr.predict_all(ds)
    assert np.isfinite(p).all() and len(p) == ds.rows.num_row


def test_imfb_disable_level():
    ds = tiny_plus()
    tr = make(SVDPPMultiIMFBTrainer)
    tr.set_param("ufeedback_disable_level", "0")
    tr.init_model()
    tr.init_trainer()
    w0 = np.asarray(tr.state.w)[: 20].copy()  # feedback rows
    tr.update_all(ds)
    # disabled level -> no feedback writeback at depth 0
    np.testing.assert_array_equal(np.asarray(tr.state.w)[:20], w0)


def test_bilinear_zero_props_equals_svdpp():
    ds = tiny_plus()
    t1 = make(SVDPPFeatureTrainer)
    t2 = make(SVDBiLinearTrainer)  # num_bi_feedback=0
    for _ in range(3):
        t1.update_all(ds)
        t2.update_all(ds)
    np.testing.assert_allclose(
        np.asarray(t1.state.w), np.asarray(t2.state.w), rtol=1e-5, atol=1e-6
    )


def test_bilinear_active_and_model_io():
    ds = tiny_plus()
    tr = make(SVDBiLinearTrainer, num_bi_feedback=10, wd_bi_feedback=0.004)
    for _ in range(3):
        tr.update_all(ds)
    Wb = np.asarray(tr.W_bi)
    assert Wb.shape == (20, 10)
    assert np.abs(Wb).max() > 0  # plugin actually trained
    # model IO roundtrip with the appended BModel section
    buf = io.BytesIO()
    tr.save_model(buf)
    buf.seek(0)
    tr2 = make(SVDBiLinearTrainer, num_bi_feedback=10)
    tr2.load_model(buf)
    assert buf.read() == b""
    np.testing.assert_array_equal(np.asarray(tr2.W_bi), Wb)
    tr2.init_trainer()
    np.testing.assert_allclose(tr.predict_all(ds), tr2.predict_all(ds), atol=1e-6)


@pytest.mark.parametrize("reg", [0, 1, 2, 3, 4, 5])
def test_bilinear_reg_modes(reg):
    ds = tiny_plus()
    tr = make(SVDBiLinearTrainer, num_bi_feedback=10, wd_bi_feedback=0.01,
              reg_bi_feedback=reg)
    tr.update_all(ds)
    assert np.isfinite(np.asarray(tr.W_bi)).all()


@pytest.mark.parametrize("reg", [0, 1, 4, 5])
def test_imfb_lazy_reg_matches_svdpp(reg):
    """At stack depth 1 multi-IMFB degenerates to plain SVD++ for EVERY
    reg mode — including lazy 4/5, which need the _lazy_catchup the
    eager modes don't (regularize(pre), apex_svd_base.h:457)."""
    ds = tiny_plus()
    t1 = make(SVDPPFeatureTrainer, reg_method=reg, wd_user=0.01, wd_item=0.01)
    t2 = make(SVDPPMultiIMFBTrainer, reg_method=reg, wd_user=0.01, wd_item=0.01)
    for _ in range(3):
        t1.update_all(ds)
        t2.update_all(ds)
    np.testing.assert_allclose(
        np.asarray(t1.state.w), np.asarray(t2.state.w), rtol=1e-5, atol=1e-6
    )
    if reg >= 4:
        np.testing.assert_array_equal(
            np.asarray(t1.state.ref_ui), np.asarray(t2.state.ref_ui)
        )


@pytest.mark.parametrize("reg", [0, 4])
def test_imfb_routes_big_table(monkeypatch, reg):
    """Forcing ONEHOT_THRESHOLD below the table size must flip multi-IMFB
    onto the augmented epoch (ops/imfb.train_epoch_imfb_big) with an
    unchanged training outcome, including nested contexts and disable
    levels."""
    from svdfeature_tpu.ops import embed

    base = tiny_plus()
    blocks = list(base.blocks())
    nested = [
        PlusBlock(blocks[0].fb_index[:2], blocks[0].fb_value[:2],
                  blocks[0].data, extend_tag=TAG_START),
        PlusBlock(blocks[1].fb_index, blocks[1].fb_value, blocks[1].data,
                  extend_tag=TAG_END),
    ] + blocks[2:]
    ds = PlusDataset.from_blocks(nested)

    def run():
        tr = make(SVDPPMultiIMFBTrainer, reg_method=reg, wd_user=0.01,
                  wd_item=0.01)
        tr.set_param("ufeedback_disable_level", "1")
        tr.init_model()
        tr.init_trainer()
        for _ in range(3):
            tr.update_all(ds)
        return tr

    tr1 = run()
    p1 = tr1.predict_all(ds)
    monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    tr2 = run()
    assert tr2.hp.big_table
    p2 = tr2.predict_all(ds)
    np.testing.assert_allclose(p2, p1, rtol=1e-4, atol=1e-5)
    tr1._sync_model_from_state()
    tr2._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(tr2.model.w), np.asarray(tr1.model.w), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(tr2.model.b), np.asarray(tr1.model.b), rtol=1e-4, atol=1e-6
    )


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("solver", ["imfb", "bilinear"])
def test_update_rounds_matches_round_loop(monkeypatch, solver, big):
    """update_rounds on stacked multi-IMFB data scans the stacked epoch
    (carried or big-table) over rounds in one dispatch; bilinear trains
    round by round.  Either way the state equals the per-round loop's."""
    import jax

    from svdfeature_tpu.ops import embed

    base = tiny_plus()
    blocks = list(base.blocks())
    nested = [
        PlusBlock(blocks[0].fb_index[:2], blocks[0].fb_value[:2],
                  blocks[0].data, extend_tag=TAG_START),
        PlusBlock(blocks[1].fb_index, blocks[1].fb_value, blocks[1].data,
                  extend_tag=TAG_END),
    ] + blocks[2:]
    ds = PlusDataset.from_blocks(nested) if solver == "imfb" else base
    if big:
        monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)

    def build():
        if solver == "imfb":
            return make(SVDPPMultiIMFBTrainer, wd_user=0.01, wd_item=0.01)
        return make(SVDBiLinearTrainer, num_bi_feedback=10, wd_bi_feedback=0.01)

    tr1, tr2 = build(), build()
    assert tr1.hp.big_table == big
    entry = tr1._pack_plus(ds)
    assert len(entry) == 6
    assert (tr1._epoch_fn(entry) is None) == (solver == "bilinear")
    tr1.update_rounds(ds, 3)
    for _ in range(3):
        tr2.update_all(ds)
    for a, b in zip(jax.tree.leaves(tr1.state), jax.tree.leaves(tr2.state)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
        )


@pytest.mark.parametrize("reg", [0, 2, 5])
def test_bilinear_routes_big_table(monkeypatch, reg):
    """Forcing ONEHOT_THRESHOLD below the table size must flip bilinear
    onto the augmented epoch (ops/svdpp_bilinear.train_epoch_bi_big, W_bi
    on dedup writes) with an unchanged training outcome — mirrors
    tests/test_svdpp_big.py::test_solver_routes_big_table."""
    from svdfeature_tpu.ops import embed

    ds = tiny_plus()
    kw = dict(num_bi_feedback=10, wd_bi_feedback=0.01, reg_bi_feedback=reg)
    tr1 = make(SVDBiLinearTrainer, **kw)
    for _ in range(3):
        tr1.update_all(ds)
    p1 = tr1.predict_all(ds)

    monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    tr2 = make(SVDBiLinearTrainer, **kw)
    assert tr2.hp.big_table
    for _ in range(3):
        tr2.update_all(ds)
    np.testing.assert_allclose(
        np.asarray(tr2.W_bi), np.asarray(tr1.W_bi), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(tr2.predict_all(ds), p1, rtol=1e-4, atol=1e-5)
    # checkpoint sync deaugments cleanly
    tr2._sync_model_from_state()
    tr1._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(tr2.model.w), np.asarray(tr1.model.w), rtol=1e-4, atol=1e-6
    )


@pytest.mark.parametrize("reg", [0, 4])
def test_imfb_carried_matches_refresh(reg):
    """train_epoch_imfb_carried (pool work O(chunks) via the context-
    overlap closed form) is trajectory-identical to the per-batch
    refresh epoch, including nested contexts and disable levels."""
    import jax
    import jax.numpy as jnp

    from svdfeature_tpu.ops.imfb import train_epoch_imfb, train_epoch_imfb_carried

    base = tiny_plus()
    blocks = list(base.blocks())
    nested = [
        PlusBlock(blocks[0].fb_index[:2], blocks[0].fb_value[:2],
                  blocks[0].data, extend_tag=TAG_START),
        PlusBlock(blocks[1].fb_index, blocks[1].fb_value, blocks[1].data,
                  extend_tag=TAG_END),
    ] + blocks[2:]
    ds = PlusDataset.from_blocks(nested)

    tr = make(SVDPPMultiIMFBTrainer, reg_method=reg, wd_user=0.01,
              wd_item=0.01)
    tr.set_param("ufeedback_disable_level", "1")
    tr.init_model()
    tr.init_trainer()
    stacked, chunk_id, fb, _, enabled, overlap = tr._pack_plus(ds)
    assert overlap is not None
    args = (jnp.float32(0.01), tr.consts, tr.hp,
            tr.tparam.scale_lr_ufeedback, tr.tparam.wd_ufeedback,
            tr.tparam.wd_ufeedback_bias)
    st1 = jax.tree.map(jnp.copy, tr.state)
    st2 = jax.tree.map(jnp.copy, tr.state)
    for _ in range(3):
        st1 = train_epoch_imfb(st1, stacked, chunk_id, fb, enabled, *args)
        st2 = train_epoch_imfb_carried(
            st2, stacked, chunk_id, fb, overlap, enabled, *args
        )
    np.testing.assert_allclose(
        np.asarray(st1.w), np.asarray(st2.w), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st1.b), np.asarray(st2.b), rtol=1e-4, atol=1e-6
    )
    assert int(st1.step) == int(st2.step)
    if reg >= 4:
        np.testing.assert_array_equal(
            np.asarray(st1.ref_ui), np.asarray(st2.ref_ui)
        )


def test_imfb_mesh_matches_single_device():
    """Multi-IMFB on a (2x2) mesh (parallel/imfb_mesh.py) matches the
    single-device trainer — model weights, biases and predictions —
    including nested contexts and a disabled stack level (the reference
    trains extend_type=2 like any other solver, apex_multi_imfb.h:31-194)."""
    import jax

    if len(jax.devices("cpu")) < 4:
        pytest.skip("not enough devices")
    base = tiny_plus()
    blocks = list(base.blocks())
    nested = [
        PlusBlock(blocks[0].fb_index[:2], blocks[0].fb_value[:2],
                  blocks[0].data, extend_tag=TAG_START),
        PlusBlock(blocks[1].fb_index, blocks[1].fb_value, blocks[1].data,
                  extend_tag=TAG_END),
    ] + blocks[2:]
    ds = PlusDataset.from_blocks(nested)

    def run(extra):
        tr = make(SVDPPMultiIMFBTrainer, wd_user=0.01, wd_item=0.01, **extra)
        tr.set_param("ufeedback_disable_level", "1")
        tr.init_model()
        tr.init_trainer()
        for _ in range(3):
            tr.update_all(ds)
        return tr

    single = run({})
    meshed = run(dict(mesh_data=2, mesh_model=2))
    single._sync_model_from_state()
    meshed._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(meshed.model.w), np.asarray(single.model.w),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(meshed.model.b), np.asarray(single.model.b),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        meshed.predict_all(ds), single.predict_all(ds), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("reg", [0, 2, 5])
def test_bilinear_mesh_matches_single_device(reg):
    """Bilinear on a (2x2) mesh (parallel/bilinear_mesh.py) matches the
    single-device trainer — weights, W_bi and predictions — across W_bi
    reg modes (the reference trains extend_type=15 like any other solver,
    apex_svd_bilinear.h:28-212)."""
    import jax

    if len(jax.devices("cpu")) < 4:
        pytest.skip("not enough devices")
    ds = tiny_plus()
    kw = dict(num_bi_feedback=10, wd_bi_feedback=0.01, reg_bi_feedback=reg,
              start_ufeedback=2)

    def run(extra):
        tr = make(SVDBiLinearTrainer, **kw, **extra)
        for _ in range(3):
            tr.update_all(ds)
        return tr

    single = run({})
    meshed = run(dict(mesh_data=2, mesh_model=2))
    single._sync_model_from_state()
    meshed._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(meshed.model.w), np.asarray(single.model.w),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(meshed.W_bi)[: meshed.mparam.num_item],
        np.asarray(single.W_bi), rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        meshed.predict_all(ds), single.predict_all(ds), rtol=1e-4, atol=1e-5
    )
    # checkpoint bytes identical (mesh W_bi de-padded on save)
    import io as _io

    b1, b2 = _io.BytesIO(), _io.BytesIO()
    single.save_model(b1)
    meshed.save_model(b2)
    assert len(b1.getvalue()) == len(b2.getvalue())


def test_imfb_degenerate_routes_to_svdpp():
    """All-DEFAULT tag streams take the WHOLE SVD++ fast path (5-tuple
    plain entries, sort_blocks/rows_per_user accepted, bit-identical
    trajectory); stacked or depth-0-disabled runs keep the imfb epoch."""
    ds = tiny_plus()
    t2 = make(SVDPPMultiIMFBTrainer, sort_blocks=1, rows_per_user=2)
    assert t2._plain_svdpp(ds)
    assert len(t2._pack_plus(ds)) == 5  # plain SVD++ entry
    t1 = make(SVDPPFeatureTrainer, sort_blocks=1, rows_per_user=2)
    for _ in range(2):
        t1.update_all(ds)
        t2.update_all(ds)
    np.testing.assert_array_equal(np.asarray(t1.state.w), np.asarray(t2.state.w))
    np.testing.assert_array_equal(t1.predict_all(ds), t2.predict_all(ds))

    # stacked data -> imfb entry (6-tuple), no routing
    blocks = list(ds.blocks())
    nested = [
        PlusBlock(blocks[0].fb_index[:2], blocks[0].fb_value[:2],
                  blocks[0].data, extend_tag=TAG_START),
        PlusBlock(np.zeros(0, np.uint32), np.zeros(0, np.float32),
                  blocks[1].data, extend_tag=TAG_END),
    ] + blocks[2:]
    sds = PlusDataset.from_blocks(nested)
    t3 = make(SVDPPMultiIMFBTrainer)
    assert not t3._plain_svdpp(sds)
    assert len(t3._pack_plus(sds)) == 6

    # disable_level 0 opts out of the routing (depth-0 updates masked)
    t4 = make(SVDPPMultiIMFBTrainer)
    t4.set_param("ufeedback_disable_level", "0")
    assert not t4._plain_svdpp(ds)
    assert len(t4._pack_plus(ds)) == 6


def test_imfb_degenerate_streams(tmp_path):
    """streaming=1 composes with multi-IMFB on all-DEFAULT buffers (the
    degenerate SVD++ route); stacked streams train out-of-core too
    (tests/test_streaming.py::test_imfb_stacked_streamed_matches_staged)."""
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.streaming import StreamingPlusBuffer

    ds = tiny_plus()
    path = str(tmp_path / "p.buffer")
    write_plus_buffer(path, ds)
    src = StreamingPlusBuffer(path, blocks_per_chunk=4)

    staged = make(SVDPPMultiIMFBTrainer)
    streamed = make(SVDPPMultiIMFBTrainer)
    assert streamed._plain_svdpp(src)
    for _ in range(2):
        staged.update_all(ds)
        streamed.update_all(src)
    np.testing.assert_array_equal(
        np.asarray(staged.state.w), np.asarray(streamed.state.w)
    )

    # a stacked stream trains out-of-core and matches the staged run
    blocks = list(ds.blocks())
    nested = [
        PlusBlock(blocks[0].fb_index[:2], blocks[0].fb_value[:2],
                  blocks[0].data, extend_tag=TAG_START),
        PlusBlock(np.zeros(0, np.uint32), np.zeros(0, np.float32),
                  blocks[1].data, extend_tag=TAG_END),
    ] + blocks[2:]
    sds = PlusDataset.from_blocks(nested)
    spath = str(tmp_path / "s.buffer")
    write_plus_buffer(spath, sds)
    ssrc = StreamingPlusBuffer(spath, blocks_per_chunk=4)
    s_staged = make(SVDPPMultiIMFBTrainer)
    s_streamed = make(SVDPPMultiIMFBTrainer)
    for _ in range(2):
        s_staged.update_all(sds)
        s_streamed.update_all(ssrc)
    np.testing.assert_allclose(
        np.asarray(s_staged.state.w), np.asarray(s_streamed.state.w),
        atol=1e-6,
    )


def test_imfb_sorted_units_close_to_unsorted():
    """sort_blocks=1 on stacked multi-IMFB: size-desc unit packing keeps
    predictions close to file order (only the hogwild order changes;
    context snapshots ride with their units)."""
    from tests.test_streaming import make_imfb_trainer, make_stacked_ds

    ds = make_stacked_ds()
    a = make_imfb_trainer()
    b = make_imfb_trainer(dict(sort_blocks=1))
    for _ in range(5):
        a.update_all(ds)
        b.update_all(ds)
    pa, pb = a.predict_all(ds), b.predict_all(ds)
    assert pa.shape == pb.shape
    # ordering deviation is real but bounded (the tiny 12-user toy
    # amplifies it; the full-horizon quality gate for the sorted M=8
    # config is the bench's stacked RMSE band)
    assert np.isfinite(pb).all()
    assert np.abs(pa - pb).max() < 0.1


def test_imfb_sort_guards(tmp_path):
    """sort_blocks=1 on the stacked path warns about the measured
    rows_per_user>2 divergence (PERF.md 'stacked scan frontier') on BOTH
    the staged and the streamed route (streaming itself now composes
    with sort_blocks chunk-locally — tests/test_streaming.py)."""
    import warnings

    from tests.test_streaming import make_imfb_trainer, make_stacked_ds
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.streaming import StreamingPlusBuffer

    ds = make_stacked_ds()
    path = str(tmp_path / "p.buffer")
    write_plus_buffer(path, ds)

    tr2 = make_imfb_trainer(dict(sort_blocks=1, rows_per_user=4))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tr2.update_all(ds)
    assert any("divergent" in str(w.message) for w in rec)

    tr3 = make_imfb_trainer(dict(sort_blocks=1, rows_per_user=4))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tr3.update_all(StreamingPlusBuffer(path, blocks_per_chunk=4))
    assert any("divergent" in str(w.message) for w in rec)
