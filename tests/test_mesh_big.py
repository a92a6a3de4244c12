"""Mesh big-slab path (parallel/mesh_big.py) parity tests.

The sorted-dedup sharded step must match the single-device general step
(ops/embed.train_step) for every regularization mode and mesh shape —
the same contract tests/test_sharding.py pins for the one-hot mesh path
and tests/test_big_embed.py pins for the single-chip big path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from svdfeature_tpu.ops.embed import train_step
from svdfeature_tpu.parallel.mesh_big import (
    big_layout,
    shard_consts_big,
    shard_state_big,
    sharded_predict_big,
    sharded_train_rounds_big,
    sharded_train_step_big,
    unshard_state_big,
)
from svdfeature_tpu.parallel.mesh import make_mesh
from tests.conftest import cpu_devices

import __graft_entry__ as ge


def _shard_batch(batch, mesh):
    return {
        k: jax.device_put(
            v, NamedSharding(mesh, P("data") if v.ndim == 1 else P("data", None))
        )
        for k, v in batch.items()
    }


def _big_hp(hp, k):
    return dataclasses.replace(hp, num_factor=k, big_table=False)


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 1), (1, 2), (4, 2)])
@pytest.mark.parametrize("num_global", [0, 5])
def test_big_sharded_step_matches_single(n_data, n_model, num_global):
    if len(cpu_devices()) < n_data * n_model:
        pytest.skip("not enough devices")
    K = 8
    state, batch, hp, consts = ge._toy_setup(
        batch_size=8 * max(n_data, 1), k=K, num_global=num_global
    )
    ref = train_step(
        jax.tree.map(jnp.copy, state), batch, jnp.float32(0.005), consts, hp
    )
    mesh = make_mesh(n_data, n_model, cpu_devices())
    hp = _big_hp(hp, K)
    sstate, n_real = shard_state_big(state, mesh, K)
    sconsts = shard_consts_big(consts, mesh, n_real)
    step = sharded_train_step_big(mesh, hp, n_real)
    out = step(sstate, _shard_batch(batch, mesh), jnp.float32(0.005), sconsts)
    n = ref.w.shape[0]
    got = unshard_state_big(out, n_model, K, n)
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(ref.w), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.b), np.asarray(ref.b), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.g), np.asarray(ref.g), rtol=2e-5, atol=1e-6)
    assert int(got.step) == int(ref.step)


@pytest.mark.parametrize("reg_method", [0, 1, 2, 3, 4, 5])
def test_big_multi_step_trajectory(reg_method):
    """Several big-slab sharded steps match the single-device trajectory
    across every regularization mode (incl. lazy 4/5, whose ref
    timestamps ride the augmented rows)."""
    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    K = 8
    state, batch, hp, consts = ge._toy_setup(batch_size=16, k=K, num_global=4)
    hp = dataclasses.replace(hp, reg_method=reg_method)
    ref = jax.tree.map(jnp.copy, state)
    lr = jnp.float32(0.01)
    for _ in range(5):
        ref = train_step(ref, batch, lr, consts, hp)
    mesh = make_mesh(2, 2, cpu_devices())
    bhp = _big_hp(hp, K)
    sstate, n_real = shard_state_big(state, mesh, K)
    sconsts = shard_consts_big(consts, mesh, n_real)
    step = sharded_train_step_big(mesh, bhp, n_real)
    sbatch = _shard_batch(batch, mesh)
    for _ in range(5):
        sstate = step(sstate, sbatch, lr, sconsts)
    n = ref.w.shape[0]
    got = unshard_state_big(sstate, 2, K, n)
    np.testing.assert_allclose(
        np.asarray(got.w), np.asarray(ref.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.b), np.asarray(ref.b), rtol=1e-4, atol=1e-5
    )
    if reg_method >= 4:
        # lazy ref timestamps ride the augmented rows; the global dummy
        # row's stamp is the only allowed difference (it is scrubbed at
        # checkpoint time and its factors stay zero)
        np.testing.assert_array_equal(
            np.asarray(got.ref_ui)[: n - 1], np.asarray(ref.ref_ui)[: n - 1]
        )


def test_big_rounds_and_predict():
    """Whole-round dispatch + sharded inference on big slabs agree with
    the single-device round loop."""
    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    from svdfeature_tpu.ops.embed import predict_batches, train_rounds

    K = 8
    state, batch, hp, consts = ge._toy_setup(batch_size=16, k=K, num_global=4)
    stacked = jax.tree.map(lambda x: jnp.stack([x, x, x]), batch)
    lrs = jnp.asarray([0.01, 0.009, 0.008], jnp.float32)
    ref = train_rounds(
        jax.tree.map(jnp.copy, state), stacked, lrs, consts, hp
    )
    ref_pred = predict_batches(ref, stacked, hp)

    mesh = make_mesh(2, 2, cpu_devices())
    bhp = _big_hp(hp, K)
    sstate, n_real = shard_state_big(state, mesh, K)
    sconsts = shard_consts_big(consts, mesh, n_real)
    sstacked = {
        k: jax.device_put(
            v,
            NamedSharding(
                mesh, P(None, "data") if v.ndim == 2 else P(None, "data", None)
            ),
        )
        for k, v in stacked.items()
    }
    run = sharded_train_rounds_big(mesh, bhp, n_real)
    sstate = run(sstate, sstacked, lrs, sconsts)
    n = ref.w.shape[0]
    got = unshard_state_big(sstate, 2, K, n)
    np.testing.assert_allclose(
        np.asarray(got.w), np.asarray(ref.w), rtol=1e-4, atol=1e-5
    )
    pred = sharded_predict_big(mesh, bhp, n_real)(sstate, sstacked)
    np.testing.assert_allclose(
        np.asarray(pred), np.asarray(ref_pred), rtol=1e-4, atol=1e-5
    )


def test_trainer_mesh_big_config_path():
    """Config-driven: mesh_big=1 must reproduce the single-device model,
    checkpoint through save/load, and predict on the mesh."""
    import io

    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    from svdfeature_tpu.data.text import load_feature_text
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer

    text = "\n".join(
        f"{(i % 5) + 1} 0 1 1 {i % 29}:1 {(i * 7) % 37}:1" for i in range(200)
    )
    ds = load_feature_text("x", text=text)
    params = dict(
        num_user=29, num_item=37, num_factor=8, base_score=3,
        learning_rate=0.01, wd_user=0.004, wd_item=0.004, batch_size=32,
    )

    def run(extra):
        tr = SVDFeatureTrainer(SVDTypeParam())
        for n, v in {**params, **extra}.items():
            tr.set_param(n, str(v))
        tr.init_model()
        tr.init_trainer()
        for _ in range(3):
            tr.update_all(ds)
        return tr

    ref = run({})
    sh = run({"mesh_data": 2, "mesh_model": 2, "mesh_big": 1})
    assert sh._mesh_big
    np.testing.assert_allclose(
        np.asarray(sh.predict_all(ds)), np.asarray(ref.predict_all(ds)),
        rtol=1e-4, atol=1e-5,
    )
    ref._sync_model_from_state()
    sh._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(sh.model.w), np.asarray(ref.model.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sh.model.b), np.asarray(ref.model.b), rtol=1e-4, atol=1e-5
    )

    # checkpoint-resume through the reference binary format
    buf = io.BytesIO()
    sh.save_model(buf)
    buf.seek(0)
    b = SVDFeatureTrainer(SVDTypeParam())
    for n, v in {**params, "mesh_data": 2, "mesh_model": 2, "mesh_big": 1}.items():
        b.set_param(n, str(v))
    b.load_model(buf)
    b.init_trainer()
    b.update_all(ds)
    ref.update_all(ds)
    ref._sync_model_from_state()
    b._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(b.model.w), np.asarray(ref.model.w), rtol=1e-4, atol=1e-5
    )


def test_big_layout_roundtrip():
    """shard/unshard must be exact inverses at awkward row counts."""
    for n, n_model in [(10, 4), (16, 4), (7, 2), (8193, 2)]:
        if len(cpu_devices()) < n_model:
            pytest.skip("not enough devices")
        K = 4
        rng = np.random.RandomState(0)
        from svdfeature_tpu.ops.embed import TrainState

        state = TrainState(
            w=jnp.asarray(rng.rand(n, K).astype(np.float32)),
            b=jnp.asarray(rng.rand(n).astype(np.float32)),
            g=jnp.asarray(rng.rand(3).astype(np.float32)),
            step=jnp.int32(5),
            ref_ui=jnp.asarray(rng.randint(0, 9, n).astype(np.int32)),
            ref_g=jnp.zeros((3,), jnp.int32),
        )
        mesh = make_mesh(1, n_model, cpu_devices())
        sstate, n_real = shard_state_big(state, mesh, K)
        assert big_layout(n, n_model) == (n_real, n_real + 1)
        back = unshard_state_big(sstate, n_model, K, n)
        np.testing.assert_array_equal(np.asarray(back.w), np.asarray(state.w))
        np.testing.assert_array_equal(np.asarray(back.b), np.asarray(state.b))
        np.testing.assert_array_equal(
            np.asarray(back.ref_ui), np.asarray(state.ref_ui)
        )


@pytest.mark.parametrize("reg,m", [(0, 1), (1, 1), (4, 1), (5, 1), (0, 2)])
def test_svdpp_mesh_big_config_path(reg, m):
    """SVD++ x mesh x big slabs (parallel/svdpp_mesh_big.py): mesh_big=1
    on the user-group solver must reproduce the single-device SVD++
    trajectory — reg modes incl. lazy 4/5 and rows_per_user>1 — and
    predict on the mesh from the augmented slabs."""
    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    from svdfeature_tpu.data.text import load_plus_text
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    rng = np.random.RandomState(3)
    rows, fbs = [], []
    for u in range(16):
        r = rng.randint(2, 6)
        for _ in range(r):
            rows.append(f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 30)}:1")
        nf = rng.randint(1, 5)
        ids = rng.choice(12, size=nf, replace=False)
        fbs.append(f"{r} {nf} " + " ".join(f"{j}:0.5" for j in ids))
    ds = load_plus_text(
        "x", "y", text="\n".join(rows), feedback_text="\n".join(fbs)
    )
    params = dict(
        num_user=16, num_item=30, num_ufeedback=12, num_factor=8,
        base_score=3, learning_rate=0.01, wd_user=0.004, wd_item=0.004,
        wd_ufeedback=0.004, users_per_batch=4, reg_method=reg,
        rows_per_user=m,
    )

    def run(extra):
        tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1))
        for n, v in {**params, **extra}.items():
            tr.set_param(n, str(v))
        tr.init_model()
        tr.init_trainer()
        for _ in range(3):
            tr.update_all(ds)
        return tr

    ref = run({})
    sh = run({"mesh_data": 2, "mesh_model": 2, "mesh_big": 1})
    assert sh._mesh_big
    ref._sync_model_from_state()
    sh._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(sh.model.w), np.asarray(ref.model.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sh.model.b), np.asarray(ref.model.b), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sh.predict_all(ds)), np.asarray(ref.predict_all(ds)),
        rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("reg", [0, 4])
def test_imfb_mesh_big_config_path(reg):
    """Multi-IMFB x mesh x big slabs (parallel/imfb_mesh_big.py):
    mesh_big=1 on the stacked-context solver must reproduce the
    single-device stacked trajectory — nested contexts, a disabled stack
    level, eager and lazy reg — and predict on the mesh from the
    augmented slabs (the reference trains extend_type=2 like any other
    solver at any table size, apex_multi_imfb.h:31-194)."""
    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    from svdfeature_tpu.data.csr import (
        PlusBlock, PlusDataset, TAG_END, TAG_START,
    )
    from svdfeature_tpu.data.text import load_plus_text
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.multi_imfb import SVDPPMultiIMFBTrainer

    rng = np.random.RandomState(5)
    rows, fbs = [], []
    for u in range(12):
        r = rng.randint(2, 5)
        for _ in range(r):
            rows.append(f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 24)}:1")
        nf = rng.randint(1, 5)
        ids = rng.choice(10, size=nf, replace=False)
        fbs.append(f"{r} {nf} " + " ".join(f"{j}:0.5" for j in ids))
    base = load_plus_text(
        "x", "y", text="\n".join(rows), feedback_text="\n".join(fbs)
    )
    # nest the first two users under a shared outer context (depth 2)
    blocks = list(base.blocks())
    nested = [
        PlusBlock(blocks[0].fb_index[:2], blocks[0].fb_value[:2],
                  blocks[0].data, extend_tag=TAG_START),
        PlusBlock(blocks[1].fb_index, blocks[1].fb_value, blocks[1].data,
                  extend_tag=TAG_END),
    ] + blocks[2:]
    ds = PlusDataset.from_blocks(nested)
    params = dict(
        num_user=12, num_item=24, num_ufeedback=10, num_factor=8,
        base_score=3, learning_rate=0.01, wd_user=0.004, wd_item=0.004,
        wd_ufeedback=0.004, users_per_batch=4, reg_method=reg,
        ufeedback_disable_level=1,
    )

    def run(extra):
        tr = SVDPPMultiIMFBTrainer(
            SVDTypeParam(format_type=1, extend_type=2)
        )
        for n, v in {**params, **extra}.items():
            tr.set_param(n, str(v))
        tr.init_model()
        tr.init_trainer()
        for _ in range(3):
            tr.update_all(ds)
        return tr

    ref = run({})
    sh = run({"mesh_data": 2, "mesh_model": 2, "mesh_big": 1})
    assert sh._mesh_big
    ref._sync_model_from_state()
    sh._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(sh.model.w), np.asarray(ref.model.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sh.model.b), np.asarray(ref.model.b), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sh.predict_all(ds)), np.asarray(ref.predict_all(ds)),
        rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("reg_bi,start", [(0, 0), (2, 2)])
def test_bilinear_mesh_big_config_path(reg_bi, start):
    """Bilinear x mesh x big slabs (parallel/bilinear_mesh_big.py):
    mesh_big=1 on extend_type=15 must reproduce the single-device
    trajectory — unified table, W_bi (dedup writes on scratch-interleaved
    slabs) and predictions — across W_bi reg modes and the
    start_ufeedback filter (the reference trains extend_type=15 like any
    other solver at any table size, apex_svd_bilinear.h:28-212)."""
    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    from svdfeature_tpu.data.text import load_plus_text
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.bilinear import SVDBiLinearTrainer

    rng = np.random.RandomState(11)
    rows, fbs = [], []
    for u in range(12):
        r = rng.randint(2, 5)
        for _ in range(r):
            rows.append(f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 24)}:1")
        nf = rng.randint(2, 6)
        ids = rng.choice(12, size=nf, replace=False)
        fbs.append(f"{r} {nf} " + " ".join(f"{j}:0.5" for j in ids))
    ds = load_plus_text(
        "x", "y", text="\n".join(rows), feedback_text="\n".join(fbs)
    )
    params = dict(
        num_user=12, num_item=24, num_ufeedback=12, num_factor=8,
        base_score=3, learning_rate=0.01, wd_user=0.004, wd_item=0.004,
        wd_ufeedback=0.004, users_per_batch=4,
        num_bi_feedback=10, wd_bi_feedback=0.01, reg_bi_feedback=reg_bi,
        start_ufeedback=start,
    )

    def run(extra):
        tr = SVDBiLinearTrainer(SVDTypeParam(format_type=1, extend_type=15))
        for n, v in {**params, **extra}.items():
            tr.set_param(n, str(v))
        tr.init_model()
        tr.init_trainer()
        for _ in range(3):
            tr.update_all(ds)
        return tr

    ref = run({})
    sh = run({"mesh_data": 2, "mesh_model": 2, "mesh_big": 1})
    assert sh._mesh_big
    ref._sync_model_from_state()
    sh._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(sh.model.w), np.asarray(ref.model.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        sh._wbi_host(), ref._wbi_host(), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sh.predict_all(ds)), np.asarray(ref.predict_all(ds)),
        rtol=1e-4, atol=1e-5,
    )
