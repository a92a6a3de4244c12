"""What (users_per_batch G, rows_per_user M) geometry makes the
KDD-scale SVD++ epoch (ops/svdpp_big.py) fastest on the GPU, and how
far is it from the reference-CPU baseline (golden/GOLDEN.json
bigSvdpp)?

Uses bench.make_big_plus()'s exact synthetic (2M rows).  One process;
warm at the timed round count, time to jax.block_until_ready.

Run from the repository root on a machine with a GPU:
  python scripts/bench_svdpp_big.py
"""

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))


def emit(**kw):
    print(json.dumps(kw), flush=True)


emit(device=jax.devices()[0].device_kind, count=len(jax.devices()))

import bench  # noqa: E402
from svdfeature_tpu.params import SVDTypeParam  # noqa: E402
from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer  # noqa: E402

t0 = time.time()
pds, dims = bench.make_big_plus()
EX = dims["EX"]
emit(probe="dataset", rows=EX, build_s=round(time.time() - t0, 1))

GEOMS = [(512, 8), (1024, 8), (2048, 8), (4096, 8), (2048, 16), (1024, 4)]
if os.environ.get("GEOMS"):
    GEOMS = [tuple(map(int, gm.split("x"))) for gm in os.environ["GEOMS"].split(",")]

R = 3
for G, M in GEOMS:
    tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1))
    for kk, vv in dict(
        num_user=dims["NU"], num_item=dims["NI"], num_ufeedback=dims["NF"],
        num_factor=dims["KF"], base_score=3, learning_rate=0.005,
        wd_user=0.004, wd_item=0.004, wd_ufeedback=0.004,
        users_per_batch=G, rows_per_user=M, sort_blocks=1,
    ).items():
        tr.set_param(kk, str(vv))
    tr.init_model()
    tr.init_trainer()
    assert tr.hp.big_table, tr.hp
    t0 = time.time()
    tr._pack_plus(pds)
    pack_s = time.time() - t0
    t0 = time.time()
    tr.update_rounds(pds, R)  # compile AT the timed round count + warm
    jax.block_until_ready(tr.state)
    warm = time.time() - t0
    best = 1e30
    for _ in range(2):
        t0 = time.time()
        tr.update_rounds(pds, R)
        jax.block_until_ready(tr.state)
        best = min(best, time.time() - t0)
    emit(
        probe=f"svdpp_big_G{G}_M{M}", pack_s=round(pack_s, 1),
        warm_s=round(warm, 1), ms_per_round=round(best / R * 1e3, 1),
        metric="examples_per_sec", value=round(R * EX / best),
        vs_baseline=round(R * EX / best / 887188, 2),  # GOLDEN.json bigSvdpp
    )
    del tr

emit(probe="done")
