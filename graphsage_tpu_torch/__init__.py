"""graphsage_tpu_torch — the PyTorch/CUDA port of graphsage_tpu.

Module names follow the JAX package so that each module's counterpart
is easy to find. The port imports torch and numpy only: nothing of JAX
and nothing of ``graphsage_tpu`` (it keeps its own copies of the
NumPy-only data layer).

Layout:
  data/      dataset contract loader, padded adjacency, node and edge
             batchers, random walks, synthetic fixtures
  nn/        initializers, dense, the mean, gcn, pooling and seq
             aggregators, the sampler, edge-prediction losses, negative
             sampling
  ops/       hand-written CUDA kernels and their plain PyTorch versions
  models/    the sample-and-aggregate pyramid, the supervised head and
             the unsupervised towers
  train/     flags, F1 metrics, torch checkpoints, the trainers
  params     the weight bridge to and from the JAX parameter pytree
  infer      serving: checkpoint -> class predictions or embeddings
  cli        ``python -m graphsage_tpu_torch
             supervised|predict|unsupervised|embed|walks ...``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
