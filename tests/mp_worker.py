"""Multi-process mesh worker (launched by tests/test_multiprocess.py).

Each process owns 2 CPU devices; together they form a 2x2 (data, model)
mesh spanning both processes — the CPU stand-in for a 2-host cluster.
Trains the tiny deterministic workload and writes the final table to a
per-process .npz for the driver to compare against single-process truth.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_NUM_CPU_DEVICES"] = "2"
os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")

import numpy as np


def main():
    coord, num_proc, pid, out = sys.argv[1:5]
    import jax

    jax.distributed.initialize(
        coordinator_address=coord, num_processes=int(num_proc), process_id=int(pid)
    )
    assert jax.process_count() == int(num_proc)
    assert len(jax.devices()) == 2 * int(num_proc)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from svdfeature_tpu.data.text import load_feature_text
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer

    rng = np.random.RandomState(0)
    lines = [
        f"{rng.randint(1, 6)} 0 1 1 {rng.randint(0, 30)}:1 {rng.randint(0, 50)}:1"
        for _ in range(512)
    ]
    ds = load_feature_text("x", text="\n".join(lines))

    tr = SVDFeatureTrainer(SVDTypeParam())
    for k, v in dict(
        num_user=30, num_item=50, num_factor=8, base_score=3,
        learning_rate=0.01, wd_user=0.004, wd_item=0.004,
        batch_size=64, mesh_data=2, mesh_model=2, seed=7,
    ).items():
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    for _ in range(2):
        tr.update_all(ds)
    w = np.asarray(jax.device_get(tr.state.w))
    b = np.asarray(jax.device_get(tr.state.b))
    np.savez(out, w=w, b=b)


if __name__ == "__main__":
    main()
