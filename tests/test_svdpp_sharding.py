"""Sharded SVD++ parity: the (data, model)-mesh SVD++ step must match the
single-device fused step (ops/svdpp._plus_step) numerically, including the
feedback segment-sum (SP analogue) and closed-form writeback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from svdfeature_tpu.ops.embed import HyperParams, TrainConsts, TrainState
from svdfeature_tpu.ops.svdpp import _plus_step
from svdfeature_tpu.parallel.mesh import make_mesh, shard_consts, shard_state
from svdfeature_tpu.parallel.svdpp_mesh import sharded_svdpp_step
from tests.conftest import cpu_devices


def _toy_plus(G=8, F=16, k=8, seed=0, nonneg=False, no_user_bias=False):
    num_user, num_item, num_fb = 12, 20, 16
    n = num_user + num_item + num_fb  # unified row space; dummy row = n
    n_g = 5
    rng = np.random.RandomState(seed)
    w = rng.randn(n + 1, k).astype(np.float32) * 0.1
    b = rng.randn(n + 1).astype(np.float32) * 0.1
    g = rng.randn(n_g).astype(np.float32) * 0.1
    w[-1] = 0.0
    b[-1] = 0.0
    g[-1] = 0.0
    state = TrainState(
        w=jnp.asarray(w), b=jnp.asarray(b), g=jnp.asarray(g),
        step=jnp.zeros((), jnp.int32),
        ref_ui=jnp.zeros((n + 1,), jnp.int32),
        ref_g=jnp.zeros((n_g,), jnp.int32),
    )
    off_item, off_fb = num_user, num_user + num_item
    batch = {
        "label": rng.randint(1, 6, G).astype(np.float32),
        "weight": np.ones(G, np.float32),
        "g_idx": rng.randint(0, n_g - 1, (G, 1)).astype(np.int32),
        "g_val": rng.rand(G, 1).astype(np.float32),
        "u_idx": (np.arange(G) % num_user).astype(np.int32)[:, None],
        "u_val": np.ones((G, 1), np.float32),
        "i_idx": (off_item + rng.randint(0, num_item, (G, 2))).astype(np.int32),
        "i_val": rng.rand(G, 2).astype(np.float32) + 0.1,
    }
    # real index with zero value: decay must still count the touch
    batch["i_val"][0, 1] = 0.0
    # one absent (padded) user slot
    batch["weight"][G - 1] = 0.0
    batch["label"][G - 1] = 0.0
    batch["u_idx"][G - 1] = n
    batch["u_val"][G - 1] = 0.0
    batch["i_idx"][G - 1] = n
    batch["i_val"][G - 1] = 0.0
    batch["g_idx"][G - 1] = n_g - 1
    batch["g_val"][G - 1] = 0.0
    batch = {k_: jnp.asarray(v) for k_, v in batch.items()}
    fb_idx = np.full(F, n, np.int32)
    fb_val = np.zeros(F, np.float32)
    fb_block = np.full(F, G, np.int32)
    pos = 0
    for u in range(G - 1):
        for _ in range(int(rng.randint(1, 3))):
            if pos < F:
                fb_idx[pos] = off_fb + rng.randint(0, num_fb)
                fb_val[pos] = rng.rand() + 0.1
                fb_block[pos] = u
                pos += 1
    cfb = {
        "fb_idx": jnp.asarray(fb_idx),
        "fb_val": jnp.asarray(fb_val),
        "fb_block": jnp.asarray(fb_block),
    }
    hp = HyperParams(
        active_type=0, base_score=3.0,
        no_user_bias=int(no_user_bias),
        user_nonnegative=int(nonneg), item_nonnegative=int(nonneg),
    )
    consts = TrainConsts(
        wd_u_row=jnp.full((n + 1,), 0.004, jnp.float32),
        wd_i_row=jnp.full((n + 1,), 0.003, jnp.float32),
        wd_g_row=jnp.concatenate(
            [jnp.full((n_g - 1,), 0.002, jnp.float32), jnp.zeros((1,))]
        ),
        wd_user_bias=jnp.float32(0.004),
        wd_item_bias=jnp.float32(0.004),
    )
    lr = jnp.float32(0.01)
    lr_fb = float(lr) * 1.0
    fb_hyper = (
        jnp.float32(lr_fb),
        jnp.float32(1.0 - lr_fb * 0.004),
        jnp.float32(1.0 - lr_fb * 0.002),
    )
    return state, batch, cfb, lr, fb_hyper, consts, hp


def _shard_inputs(mesh, state, batch, cfb, consts, G):
    sstate, n_pad = shard_state(state, mesh)
    sconsts = shard_consts(consts, mesh, n_pad)
    sbatch = dict(batch)
    sbatch = {
        k: jax.device_put(
            v, NamedSharding(mesh, P("data") if v.ndim == 1 else P("data", None))
        )
        for k, v in sbatch.items()
    }
    scfb = {k: jax.device_put(v, NamedSharding(mesh, P())) for k, v in cfb.items()}
    return sstate, sbatch, scfb, sconsts, n_pad


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 1), (1, 2), (4, 2)])
@pytest.mark.parametrize("nonneg", [False, True])
def test_sharded_svdpp_matches_single(n_data, n_model, nonneg):
    if len(cpu_devices()) < n_data * n_model:
        pytest.skip("not enough devices")
    state, batch, cfb, lr, fbh, consts, hp = _toy_plus(nonneg=nonneg)
    ref = _plus_step(
        jax.tree.map(jnp.copy, state), batch, cfb, lr, consts, hp, fbh
    )
    mesh = make_mesh(n_data, n_model, cpu_devices())
    G, F = batch["label"].shape[0], cfb["fb_idx"].shape[0]
    sstate, sbatch, scfb, sconsts, n_pad = _shard_inputs(
        mesh, state, batch, cfb, consts, G
    )
    step = sharded_svdpp_step(mesh, hp, n_pad, G, F)
    out = step(sstate, sbatch, scfb, lr, fbh, sconsts)
    n = ref.w.shape[0]
    np.testing.assert_allclose(
        np.asarray(out.w)[:n], np.asarray(ref.w), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(out.b)[:n], np.asarray(ref.b), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(out.g), np.asarray(ref.g), rtol=2e-5, atol=1e-6
    )
    assert int(out.step) == int(ref.step)


def test_sharded_svdpp_trajectory():
    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    state, batch, cfb, lr, fbh, consts, hp = _toy_plus()
    ref = jax.tree.map(jnp.copy, state)
    for _ in range(5):
        ref = _plus_step(ref, batch, cfb, lr, consts, hp, fbh)
    mesh = make_mesh(2, 2, cpu_devices())
    G, F = batch["label"].shape[0], cfb["fb_idx"].shape[0]
    sstate, sbatch, scfb, sconsts, n_pad = _shard_inputs(
        mesh, state, batch, cfb, consts, G
    )
    step = sharded_svdpp_step(mesh, hp, n_pad, G, F)
    for _ in range(5):
        sstate = step(sstate, sbatch, scfb, lr, fbh, sconsts)
    n = ref.w.shape[0]
    np.testing.assert_allclose(
        np.asarray(sstate.w)[:n], np.asarray(ref.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sstate.b)[:n], np.asarray(ref.b), rtol=1e-4, atol=1e-5
    )


def test_svdpp_trainer_mesh_config_path():
    """Config-driven multi-chip SVD++ training (mesh_data/mesh_model) must
    match the single-device trainer, including G/F mesh padding."""
    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    from svdfeature_tpu.data.text import load_plus_text
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    rng = np.random.RandomState(3)
    data_lines, fb_lines = [], []
    for u in range(12):
        nrows = int(rng.randint(3, 7))
        nfb = int(rng.randint(2, 5))
        fb_lines.append(
            f"{nrows} {nfb} "
            + " ".join(f"{rng.randint(0, 15)}:1" for _ in range(nfb))
        )
        for _ in range(nrows):
            data_lines.append(f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 20)}:1")
    ds = load_plus_text(
        "x", "y", text="\n".join(data_lines), feedback_text="\n".join(fb_lines)
    )
    params = dict(
        num_user=12, num_item=20, num_ufeedback=15, num_factor=8, base_score=3,
        learning_rate=0.01, wd_user=0.004, wd_item=0.004, wd_ufeedback=0.004,
        users_per_batch=5,  # pads 5 -> 6 on a 2-wide data axis
    )

    def run(extra):
        mt = SVDTypeParam(format_type=1)
        tr = SVDPPFeatureTrainer(mt)
        for n, v in {**params, **extra}.items():
            tr.set_param(n, str(v))
        tr.init_model()
        tr.init_trainer()
        for _ in range(3):
            tr.update_all(ds)
        return tr

    ref = run({})
    sh = run({"mesh_data": 2, "mesh_model": 2})
    np.testing.assert_allclose(
        np.asarray(sh.predict_all(ds)), np.asarray(ref.predict_all(ds)),
        rtol=1e-4, atol=1e-5,
    )
    ref._sync_model_from_state()
    sh._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(sh.model.w), np.asarray(ref.model.w), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("reg_method,reg_global", [(4, 0), (5, 0), (4, 4), (5, 5)])
def test_sharded_svdpp_lazy_reg_trajectory(reg_method, reg_global):
    """Lazy reg 4/5 on the SVD++ mesh: sharded ref counters must drive the
    same catch-up as the single-device _plus_step (reference lazy modes,
    apex_svd_base.h:188-310, applied in block order :568-582)."""
    import dataclasses

    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    state, batch, cfb, lr, fbh, consts, hp = _toy_plus()
    hp = dataclasses.replace(hp, reg_method=reg_method, reg_global=reg_global)
    ref = jax.tree.map(jnp.copy, state)
    for _ in range(5):
        ref = _plus_step(ref, batch, cfb, lr, consts, hp, fbh)
    mesh = make_mesh(2, 2, cpu_devices())
    G, F = batch["label"].shape[0], cfb["fb_idx"].shape[0]
    sstate, sbatch, scfb, sconsts, n_pad = _shard_inputs(
        mesh, state, batch, cfb, consts, G
    )
    step = sharded_svdpp_step(mesh, hp, n_pad, G, F)
    for _ in range(5):
        sstate = step(sstate, sbatch, scfb, lr, fbh, sconsts)
    n = ref.w.shape[0]
    np.testing.assert_allclose(
        np.asarray(sstate.w)[:n], np.asarray(ref.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sstate.b)[:n], np.asarray(ref.b), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sstate.g), np.asarray(ref.g), rtol=1e-4, atol=1e-5
    )
    # dummy-row ref excluded: the sharded stamp there is value-inert
    # (w[dummy] is scrubbed every step and the ref is never checkpointed;
    # single-device _lazy_catchup pins it to 0 for big-path parity)
    np.testing.assert_array_equal(
        np.asarray(sstate.ref_ui)[: n - 1], np.asarray(ref.ref_ui)[: n - 1]
    )
    np.testing.assert_array_equal(np.asarray(sstate.ref_g), np.asarray(ref.ref_g))


def _widen_multirow(batch, G, M, n, n_g, seed=1):
    """[G] one-row batch -> [G*M] M-rows-per-user batch (slot = g*M + m),
    with ragged users (some m-slots absent)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k_, v in batch.items():
        v = np.asarray(v)
        rep = np.repeat(v, M, axis=0)
        out[k_] = rep.copy()
    for g in range(G):
        rows = int(rng.randint(1, M + 1)) if float(batch["weight"][g]) > 0 else 0
        for m in range(M):
            s = g * M + m
            if m >= rows:
                out["weight"][s] = 0.0
                out["label"][s] = 0.0
                out["u_idx"][s] = n
                out["u_val"][s] = 0.0
                out["i_idx"][s] = n
                out["i_val"][s] = 0.0
                out["g_idx"][s] = n_g - 1
                out["g_val"][s] = 0.0
            elif m > 0:
                # distinct item rows per extra slot keeps the test honest
                out["i_idx"][s] = (out["i_idx"][s] - 12) % 20 + 12
                out["label"][s] = float(rng.randint(1, 6))
    return {k_: jnp.asarray(v) for k_, v in out.items()}


@pytest.mark.parametrize("n_data,n_model", [(2, 2), (4, 2)])
def test_sharded_svdpp_multirow(n_data, n_model):
    """rows_per_user=M on the mesh: the M-wide implicitly-damped feedback
    step must match the single-device _plus_step(rows_per_user=M)."""
    if len(cpu_devices()) < n_data * n_model:
        pytest.skip("not enough devices")
    M = 4
    state, batch, cfb, lr, fbh, consts, hp = _toy_plus(G=8)
    n = state.w.shape[0] - 1
    mbatch = _widen_multirow(batch, 8, M, n, state.g.shape[0])
    ref = jax.tree.map(jnp.copy, state)
    for _ in range(4):
        ref = _plus_step(
            ref, mbatch, cfb, lr, consts, hp, fbh, rows_per_user=M
        )
    mesh = make_mesh(n_data, n_model, cpu_devices())
    G, F = 8, cfb["fb_idx"].shape[0]
    sstate, sbatch, scfb, sconsts, n_pad = _shard_inputs(
        mesh, state, mbatch, cfb, consts, G
    )
    step = sharded_svdpp_step(mesh, hp, n_pad, G, F, M=M)
    for _ in range(4):
        sstate = step(sstate, sbatch, scfb, lr, fbh, sconsts)
    nn = ref.w.shape[0]
    np.testing.assert_allclose(
        np.asarray(sstate.w)[:nn], np.asarray(ref.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sstate.b)[:nn], np.asarray(ref.b), rtol=1e-4, atol=1e-5
    )
    assert int(sstate.step) == int(ref.step)


def test_svdpp_trainer_mesh_multirow_lazy_config_path():
    """Config-driven: mesh + rows_per_user>1 + lazy reg compose (the three
    round-2 refusals) and match the single-device trainer."""
    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    from svdfeature_tpu.data.text import load_plus_text
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    rng = np.random.RandomState(7)
    data_lines, fb_lines = [], []
    for u in range(10):
        nrows = int(rng.randint(3, 8))
        nfb = int(rng.randint(2, 5))
        fb_lines.append(
            f"{nrows} {nfb} "
            + " ".join(f"{rng.randint(0, 15)}:1" for _ in range(nfb))
        )
        for _ in range(nrows):
            data_lines.append(
                f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 20)}:1"
            )
    ds = load_plus_text(
        "x", "y", text="\n".join(data_lines), feedback_text="\n".join(fb_lines)
    )
    params = dict(
        num_user=10, num_item=20, num_ufeedback=15, num_factor=8, base_score=3,
        learning_rate=0.01, wd_user=0.004, wd_item=0.004, wd_ufeedback=0.004,
        users_per_batch=5, rows_per_user=2, reg_method=4,
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
    sh = run({"mesh_data": 2, "mesh_model": 2})
    np.testing.assert_allclose(
        np.asarray(sh.predict_all(ds)), np.asarray(ref.predict_all(ds)),
        rtol=1e-4, atol=1e-5,
    )
    ref._sync_model_from_state()
    sh._sync_model_from_state()
    np.testing.assert_allclose(
        np.asarray(sh.model.w), np.asarray(ref.model.w), rtol=1e-4, atol=1e-5
    )


def test_sharded_svdpp_onehot_branch(monkeypatch):
    """The one-hot forms of the sharded reductions/writebacks
    (mesh._seg_sum/_seg_sum_stacked, embed._scatter_rows/_scatter_vals,
    svdpp._fb_writeback inside the mesh step) must match the scatter
    branch bit-for-bit-ish — forced on CPU by patching the selector."""
    if len(cpu_devices()) < 4:
        pytest.skip("not enough devices")
    state, batch, cfb, lr, fbh, consts, hp = _toy_plus()
    mesh = make_mesh(2, 2, cpu_devices())
    G, F = batch["label"].shape[0], cfb["fb_idx"].shape[0]
    sstate, sbatch, scfb, sconsts, n_pad = _shard_inputs(
        mesh, state, batch, cfb, consts, G
    )
    ref = jax.tree.map(jnp.copy, sstate)
    step = sharded_svdpp_step(mesh, hp, n_pad, G, F)
    for _ in range(3):
        ref = step(ref, sbatch, scfb, lr, fbh, sconsts)

    from svdfeature_tpu.ops import embed
    from svdfeature_tpu.ops import svdpp as svdpp_ops

    monkeypatch.setattr(embed, "_use_onehot", lambda n: True)
    # svdpp binds the selector at import time — patch its copy too so
    # _fb_writeback inside the mesh step takes the one-hot branch
    monkeypatch.setattr(svdpp_ops, "_use_onehot", lambda n: True)
    step_oh = sharded_svdpp_step(mesh, hp, n_pad, G, F)
    st = jax.tree.map(jnp.copy, sstate)
    for _ in range(3):
        st = step_oh(st, sbatch, scfb, lr, fbh, sconsts)
    np.testing.assert_allclose(
        np.asarray(st.w), np.asarray(ref.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.b), np.asarray(ref.b), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.g), np.asarray(ref.g), rtol=1e-4, atol=1e-5
    )
