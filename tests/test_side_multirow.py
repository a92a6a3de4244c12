"""rows_per_user (M>1) for the side solvers (bilinear, multi-IMFB).

Mirrors tests/test_svdpp_multirow.py's guarantees for the two plugin
solvers (the reference drives all SVD++ subclasses through the same
sequential loop, apex_svd_base.h:568-582, so the M-wide Jacobi widening
must compose with the plugin terms the same way):

  1. units with a single row are bit-identical between M=1 and M>1
     (the widened step reduces exactly — for multi-IMFB this includes
     contexts SHARED across units, which sum undamped at M=1);
  2. the M=2 trajectory stays close to M=1 on multirow data (the damped
     Jacobi deviation, same contract as plain SVD++);
  3. M>1 composes with the mesh, the big-table route, and streaming,
     matching the single-device M>1 trajectory.
"""

import numpy as np
import pytest

from svdfeature_tpu.data.csr import (
    PlusDataset,
    TAG_DEFAULT,
    TAG_END,
    TAG_MIDDLE,
    TAG_START,
)
from svdfeature_tpu.data.text import load_plus_text
from svdfeature_tpu.params import SVDTypeParam

from tests.test_streaming import (
    make_imfb_trainer,
    make_plus_ds,
    make_stacked_ds,
)


def _cpu_devices(n):
    import jax

    ds = jax.devices("cpu")
    return ds if len(ds) >= n else None


def make_bi_trainer(extra=None):
    from svdfeature_tpu.solvers.bilinear import SVDBiLinearTrainer

    tr = SVDBiLinearTrainer(SVDTypeParam(format_type=1))
    params = dict(
        num_user=12, num_item=12, num_ufeedback=15, num_factor=8,
        base_score=3, learning_rate=0.01, wd_user=0.004, wd_item=0.004,
        wd_ufeedback=0.004, users_per_batch=2, num_bi_feedback=15,
        wd_bi_feedback=0.002,
    )
    params.update(extra or {})
    for k, v in params.items():
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


def single_row_plus_ds(tags=None):
    rows = "\n".join(f"4 0 1 1 {u}:1 {10 - u}:1" for u in range(4))
    fb = "\n".join(f"1 2 {u}:0.5 {u + 3}:0.5" for u in range(4))
    ds = load_plus_text("x", "y", text=rows, feedback_text=fb)
    if tags is None:
        return ds
    blocks = list(ds.blocks())
    return PlusDataset.from_blocks(
        [
            type(b)(b.fb_index, b.fb_value, b.data, extend_tag=t)
            for b, t in zip(blocks, tags)
        ]
    )


# ---- bilinear ------------------------------------------------------------

def test_bilinear_single_row_users_bitwise_equal():
    ds = single_row_plus_ds()
    outs = {}
    for m in (1, 4):
        tr = make_bi_trainer(
            dict(num_user=4, num_ufeedback=10, num_bi_feedback=10,
                 rows_per_user=m)
        )
        for _ in range(3):
            tr.update_all(ds)
        outs[m] = (np.asarray(tr.state.w), np.asarray(tr.W_bi))
    np.testing.assert_array_equal(outs[1][0], outs[4][0])
    np.testing.assert_array_equal(outs[1][1], outs[4][1])


def test_bilinear_multirow_trajectory_close():
    ds = make_plus_ds()
    t1 = make_bi_trainer(dict(rows_per_user=1))
    t2 = make_bi_trainer(dict(rows_per_user=2))
    for _ in range(5):
        t1.update_all(ds)
        t2.update_all(ds)
    p1, p2 = t1.predict_all(ds), t2.predict_all(ds)
    assert np.abs(p1 - p2).max() < 0.05


def test_bilinear_multirow_mesh_matches_single_device():
    if _cpu_devices(4) is None:
        pytest.skip("not enough devices")
    ds = make_plus_ds()
    t2 = make_bi_trainer(dict(rows_per_user=2))
    tm = make_bi_trainer(dict(rows_per_user=2, mesh_data=2, mesh_model=2))
    assert tm._mesh is not None
    for _ in range(5):
        t2.update_all(ds)
        tm.update_all(ds)
    t2._sync_model_from_state()
    tm._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(tm.model.w), np.asarray(t2.model.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        tm._wbi_host(), np.asarray(t2._wbi_host()), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        tm.predict_all(ds), t2.predict_all(ds), rtol=1e-4, atol=1e-5
    )


def test_bilinear_multirow_big_table_matches_small(monkeypatch):
    """M=2 on the forced big-table route == M=2 on the small route."""
    from svdfeature_tpu.ops import embed

    ds = make_plus_ds()
    small = make_bi_trainer(dict(rows_per_user=2))
    for _ in range(3):
        small.update_all(ds)
    monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    big = make_bi_trainer(dict(rows_per_user=2))
    assert big.hp.big_table
    for _ in range(3):
        big.update_all(ds)
    small._sync_model_from_state()
    big._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(big.model.w), np.asarray(small.model.w),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(big.W_bi)[:12], np.asarray(small.W_bi)[:12],
        rtol=1e-4, atol=1e-5,
    )


def test_bilinear_multirow_streamed_matches_staged(tmp_path):
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.streaming import StreamingPlusBuffer

    ds = make_plus_ds()
    path = str(tmp_path / "p.buffer")
    write_plus_buffer(path, ds)
    staged = make_bi_trainer(dict(rows_per_user=2))
    streamed = make_bi_trainer(dict(rows_per_user=2))
    src = StreamingPlusBuffer(path, blocks_per_chunk=4)
    for _ in range(3):
        staged.update_all(ds)
        streamed.update_all(src)
    staged._sync_model_from_state()
    streamed._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(streamed.model.w), np.asarray(staged.model.w),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        streamed.predict_all(src), staged.predict_all(ds),
        rtol=1e-4, atol=1e-5,
    )


# ---- multi-IMFB (stacked contexts) ----------------------------------------

def test_imfb_single_row_units_bitwise_equal():
    # START/MIDDLE/END tags: contexts are SHARED across units in a batch,
    # so this also pins that cross-unit sharing stays undamped
    ds = single_row_plus_ds([TAG_START, TAG_DEFAULT, TAG_MIDDLE, TAG_END])
    outs = {}
    for m in (1, 4):
        tr = make_imfb_trainer(
            dict(num_user=4, num_ufeedback=10, rows_per_user=m)
        )
        for _ in range(3):
            tr.update_all(ds)
        outs[m] = np.asarray(tr.state.w)
    np.testing.assert_array_equal(outs[1], outs[4])


def test_imfb_multirow_trajectory_close():
    ds = make_stacked_ds()
    t1 = make_imfb_trainer(dict(rows_per_user=1))
    t2 = make_imfb_trainer(dict(rows_per_user=2))
    for _ in range(5):
        t1.update_all(ds)
        t2.update_all(ds)
    p1, p2 = t1.predict_all(ds), t2.predict_all(ds)
    assert np.abs(p1 - p2).max() < 0.05


def test_imfb_multirow_mesh_matches_single_device():
    if _cpu_devices(4) is None:
        pytest.skip("not enough devices")
    ds = make_stacked_ds()
    t2 = make_imfb_trainer(dict(rows_per_user=2))
    tm = make_imfb_trainer(dict(rows_per_user=2, mesh_data=2, mesh_model=2))
    assert tm._mesh is not None
    for _ in range(5):
        t2.update_all(ds)
        tm.update_all(ds)
    t2._sync_model_from_state()
    tm._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(tm.model.w), np.asarray(t2.model.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        tm.predict_all(ds), t2.predict_all(ds), rtol=1e-4, atol=1e-5
    )


def test_imfb_multirow_big_table_matches_small(monkeypatch):
    from svdfeature_tpu.ops import embed

    ds = make_stacked_ds()
    small = make_imfb_trainer(dict(rows_per_user=2))
    for _ in range(3):
        small.update_all(ds)
    monkeypatch.setattr(embed, "ONEHOT_THRESHOLD", 4)
    big = make_imfb_trainer(dict(rows_per_user=2))
    assert big.hp.big_table
    for _ in range(3):
        big.update_all(ds)
    small._sync_model_from_state()
    big._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(big.model.w), np.asarray(small.model.w),
        rtol=1e-4, atol=1e-5,
    )


def test_imfb_multirow_stacked_streamed_matches_staged(tmp_path):
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.streaming import StreamingPlusBuffer

    ds = make_stacked_ds()
    path = str(tmp_path / "p.buffer")
    write_plus_buffer(path, ds)
    staged = make_imfb_trainer(dict(rows_per_user=2))
    streamed = make_imfb_trainer(dict(rows_per_user=2))
    src = StreamingPlusBuffer(path, blocks_per_chunk=4)
    for _ in range(5):
        staged.update_all(ds)
        streamed.update_all(src)
    staged._sync_model_from_state()
    streamed._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(streamed.model.w), np.asarray(staged.model.w),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        streamed.predict_all(src), staged.predict_all(ds),
        rtol=1e-4, atol=1e-5,
    )


def test_bilinear_multirow_streamed_mesh_matches_staged(tmp_path):
    """All three axes at once: streaming x (2x2) mesh x rows_per_user=2
    equals the staged single-device M=2 trainer."""
    if _cpu_devices(4) is None:
        pytest.skip("not enough devices")
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.streaming import StreamingPlusBuffer

    ds = make_plus_ds()
    path = str(tmp_path / "p.buffer")
    write_plus_buffer(path, ds)
    staged = make_bi_trainer(dict(rows_per_user=2))
    meshed = make_bi_trainer(
        dict(rows_per_user=2, mesh_data=2, mesh_model=2)
    )
    src = StreamingPlusBuffer(path, blocks_per_chunk=4)
    for _ in range(3):
        staged.update_all(ds)
        meshed.update_all(src)
    staged._sync_model_from_state()
    meshed._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(meshed.model.w), np.asarray(staged.model.w),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        meshed.predict_all(src), staged.predict_all(ds),
        rtol=1e-4, atol=1e-5,
    )


def test_imfb_multirow_stacked_streamed_mesh_matches_staged(tmp_path):
    """Stacked multi-IMFB x streaming x mesh x rows_per_user=2."""
    if _cpu_devices(4) is None:
        pytest.skip("not enough devices")
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.streaming import StreamingPlusBuffer

    ds = make_stacked_ds()
    path = str(tmp_path / "p.buffer")
    write_plus_buffer(path, ds)
    staged = make_imfb_trainer(dict(rows_per_user=2))
    meshed = make_imfb_trainer(
        dict(rows_per_user=2, mesh_data=2, mesh_model=2)
    )
    src = StreamingPlusBuffer(path, blocks_per_chunk=4)
    for _ in range(3):
        staged.update_all(ds)
        meshed.update_all(src)
    staged._sync_model_from_state()
    meshed._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(meshed.model.w), np.asarray(staged.model.w),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        meshed.predict_all(src), staged.predict_all(ds),
        rtol=1e-4, atol=1e-5,
    )
