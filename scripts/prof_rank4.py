"""Component breakdown of the multi-round pair path on the GPU:
skeleton build, batched sampling, offset transfer, pure K-round device
dispatch, and warm full runs.

Run from the repository root on a machine with a GPU:
  python scripts/prof_rank4.py
"""

import gzip
import json
import pathlib
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
FIX = REPO / "tests" / "fixtures"


def emit(**kw):
    print(json.dumps(kw), flush=True)


emit(device=jax.devices()[0].device_kind, platform=jax.devices()[0].platform)

from svdfeature_tpu.data.rank import PairSource  # noqa: E402
from svdfeature_tpu.data.registry import IteratorConfig  # noqa: E402
from svdfeature_tpu.data.text import load_plus_text  # noqa: E402
from svdfeature_tpu.params import SVDTypeParam  # noqa: E402
from svdfeature_tpu.solvers.svdpp import (  # noqa: E402
    SVDPPFeatureTrainer, _pair_multi_train,
)


def fx(name):
    with gzip.open(FIX / name, "rt") as f:
        return f.read()


train = load_plus_text(
    "x", "y",
    text=fx("ml100k.rank.base.feature.gz"),
    feedback_text=fx("ml100k.rank.base.feedback.gz"),
    scale_score=5,
)
PP = [
    ("learning_rate", "0.005"), ("wd_user", "0.004"),
    ("wd_item", "0.004"), ("num_user", "943"),
    ("num_item", "1682"), ("num_global", "0"),
    ("num_factor", "64"), ("active_type", "3"),
    ("num_ufeedback", "1682"), ("wd_ufeedback", "0.004"),
    ("no_user_bias", "1"),
]


def mk():
    tr = SVDPPFeatureTrainer(SVDTypeParam(format_type=1, active_type=3))
    for k, v in PP:
        tr.set_param(k, v)
    tr.init_model()
    tr.init_trainer()
    return tr


src = PairSource(train, IteratorConfig(), seed=10)
tr = mk()
tr._apply_pair_layout()

t0 = time.time()
ok = tr._pair_multi_ok(src)
emit(stage="skeleton_build", s=round(time.time() - t0, 3), ok=ok)

# warm up compile (one K=8 block)
t0 = time.time()
tr._train_pair_rounds_host(src, [0.005] * 8)
emit(stage="compile_k8", s=round(time.time() - t0, 1))

sk = tr._pair_sk
rng = np.random.default_rng(1)

for rep in range(3):
    t0 = time.time()
    opl, onl = src.sample_offsets(8, rng)
    t1 = time.time()
    opl_d, onl_d = jax.device_put((opl, onl))
    jax.block_until_ready((opl_d, onl_d))
    t2 = time.time()
    st = _pair_multi_train(
        tr.state, opl_d, onl_d,
        jnp.asarray([0.005] * 8, jnp.float32), tr.consts,
        sk["dev"], sk["geo"], sk["chunk_id"], sk["fb"], sk["overlap"],
        tr._fbh(), hp=tr.hp, M=sk["M"], T=sk["T"], GS=sk["GS"],
    )
    jax.block_until_ready(st)
    t3 = time.time()
    tr.state = st
    emit(rep=rep, sample_ms=round((t1 - t0) * 1e3, 1),
         put_ms=round((t2 - t1) * 1e3, 1),
         dispatch_ms=round((t3 - t2) * 1e3, 1),
         per_round_ms=round((t3 - t2) / 8 * 1e3, 1),
         bytes_off=opl.nbytes + onl.nbytes)

# warm full pipelined runs on the same trainer
n_pairs = PairSource(train, IteratorConfig()).epoch_dataset().rows.num_row
for rep in range(3):
    t0 = time.time()
    tr._train_pair_rounds_host(src, [0.005] * 40)
    jax.block_until_ready(tr.state)
    dt = time.time() - t0
    emit(stage="warm40", rep=rep, s=round(dt, 3),
         ex_per_s=round(40 * n_pairs / dt),
         vs_ref=round(40 * n_pairs / dt / 2891998, 2))
