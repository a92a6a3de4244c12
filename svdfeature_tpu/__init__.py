"""svdfeature_tpu: a JAX feature-based matrix-factorization framework.

A ground-up JAX/XLA re-design of the capabilities of SVDFeature
(APEX Lab SJTU): feature-based collaborative
filtering with three sparse feature groups (global / user / item), covering
plain MF, SVD++, neighborhood models, binary classification, and pairwise
ranking — re-expressed as batched, sharded, functional computation:

* the reference's per-example SGD inner loop (solvers/base-solver/
  apex_svd_base.h:456-462) becomes a fused, jit-compiled batched train step:
  gather -> weighted segment sums -> factor dot -> scatter-add update,
  scanned on-device over many batches per dispatch;
* the SSE kernel layer (apex-tensor/) becomes XLA fusions: row gathers,
  scatter-adds and sorted-dedup row writes on the embedding tables;
* scaling is via a (data, model) jax.sharding.Mesh with row-sharded
  embedding tables (no analogue exists in the single-process reference).

File-format compatibility: .conf config files, text feature files, binary
feature buffers, and binary model checkpoints are bit-compatible with the
reference so golden tests can compare the two systems directly.
"""

__version__ = "0.1.0"

from . import losses, params
from .config import ConfigReader, ConfigSaver
from .model import SVDModel
