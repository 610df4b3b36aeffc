"""Typed configuration mirroring the reference flag surface.

The fields are those the port's serving, supervised and unsupervised
paths read, with the JAX package's defaults. ``check_model_shards``
refuses the supervised flag combinations the JAX package refuses.
``feature_table`` places the feature table the flags select, for both
trainers and serving.
"""

from __future__ import annotations

import dataclasses
import os

import torch

# model names accepted by the reference dispatchers
SUPERVISED_MODELS = (
    "graphsage_mean", "gcn", "graphsage_seq", "graphsage_maxpool",
    "graphsage_meanpool",
)

UNSUPERVISED_MODELS = SUPERVISED_MODELS + ("n2v",)

# model name -> (aggregator, concat)
MODEL_AGGREGATORS = {
    "graphsage_mean": ("mean", True),
    "gcn": ("gcn", False),
    "graphsage_seq": ("seq", True),
    "graphsage_maxpool": ("maxpool", True),
    "graphsage_meanpool": ("meanpool", True),
}


@dataclasses.dataclass
class TrainFlags:
    model: str = "graphsage_mean"
    learning_rate: float = 0.01
    model_size: str = "small"
    train_prefix: str = ""
    epochs: int = 10
    dropout: float = 0.0
    weight_decay: float = 0.0
    max_degree: int = 128
    samples_1: int = 25
    samples_2: int = 10
    samples_3: int = 0          # 3rd layer, graphsage_mean only (supervised)
    dim_1: int = 128
    dim_2: int = 128
    random_context: bool = True  # unsupervised: walk pairs, else edges
    neg_sample_size: int = 20    # unsupervised only
    batch_size: int = 512
    sigmoid: bool = False
    identity_dim: int = 0
    save_embeddings: bool = True  # unsupervised only
    base_log_dir: str = "."
    validate_iter: int = 5000
    validate_batch_size: int = 256   # -1: the full val set
    print_every: int = 5
    max_total_steps: int = 10**10
    sampler_mode: str = "shared_perm"  # or "independent", "first_k"
    fused_gather: bool = True   # CUDA kernel for the innermost hop
    dedup_gather: bool = False  # K3: the fused mean loads distinct rows once
    rows_gather: bool = False   # K4 gathers the pooled/seq hop's rows
    graph_shards: int = 1       # row-shard the tables over N ranks (P2)
    data_shards: int = 1        # pure data parallelism over N ranks (P1)
    capacity_factor: float = 0.0  # the exchange's budget; 0 = auto-size
    shard_layout: str = "strided"  # row ownership: "strided" or "block"
    n_model_shards: int = 1     # feature-dim TP (supervised only)
    defer_features: bool = False  # read the feature table at training
                                  # time (node2vec never reads it)
    degree_relabel: bool = False  # internal ids by descending degree;
                                  # original ids round-trip everywhere
    feature_dtype: str = "float32"  # or "bfloat16"
    seed: int = 123
    checkpoint_dir: str = ""    # torch checkpoint root ("" = disabled)
    checkpoint_every: int = 0   # steps; 0 = only at the end
    resume: bool = False
    n2v_test_epochs: int = 1    # node2vec's retrain on the eval nodes
    profile_dir: str = ""       # torch.profiler Chrome trace output
    log_histograms: bool = False  # param and activation histograms

    def log_dir(self, task: str) -> str:
        """Reference layout: <base>/<sup|unsup>-<data>/<model>_<size>_<lr>/
        with the dataset name taken from the prefix's parent directory and
        the lr formatted 0.4f (sup) or 0.6f (unsup)."""
        parts = self.train_prefix.split("/")
        name = parts[-2] if len(parts) >= 2 else parts[-1]
        sub, lr_fmt = (
            ("sup", "{:0.4f}") if task == "supervised"
            else ("unsup", "{:0.6f}")
        )
        d = os.path.join(
            self.base_log_dir,
            f"{sub}-{name}",
            f"{self.model:s}_{self.model_size:s}_"
            + lr_fmt.format(self.learning_rate),
        )
        os.makedirs(d, exist_ok=True)
        return d


def check_model_shards(flags: TrainFlags) -> None:
    """The supervised trainer's refusals of ``--n_model_shards``: below
    1, and above 1 together with ``--graph_shards``, which the JAX
    package's trainer refuses in these words
    (``graphsage_tpu/train/supervised.py:147-155``). The other
    subcommands ignore the flag, as the JAX package's do."""
    if flags.n_model_shards < 1:
        raise ValueError(
            f"--n_model_shards must be >= 1, got {flags.n_model_shards}")
    if flags.graph_shards > 1 and flags.n_model_shards > 1:
        raise ValueError(
            "--n_model_shards (feature-dim TP over a pjit mesh) does "
            "not compose with --graph_shards (shard_map halo "
            "exchange); combine --graph_shards with --data_shards "
            "instead (2-D data x graph mesh)"
        )


def build_layer_infos(flags: TrainFlags, supervised: bool):
    """(aggregator, concat, layers) for the model-zoo dispatch.

    Supervised graphsage_mean supports a variable depth: ``samples_3 > 0``
    adds a third layer (dim_2 again); ``samples_2 == 0`` drops to one
    layer. gcn doubles dims with concat=False so that output widths
    match the concat models.
    """
    from graphsage_tpu_torch.models.graphsage import LayerInfo

    if flags.model not in MODEL_AGGREGATORS:
        raise ValueError(f"unknown model: {flags.model}")
    agg, concat = MODEL_AGGREGATORS[flags.model]
    mult = 1 if concat else 2
    layers = [LayerInfo(flags.samples_1, mult * flags.dim_1)]
    variable_depth = supervised and flags.model == "graphsage_mean"
    if flags.samples_2 > 0 or not variable_depth:
        layers.append(LayerInfo(flags.samples_2, mult * flags.dim_2))
    if variable_depth and flags.samples_3 > 0:
        layers.append(LayerInfo(flags.samples_3, mult * flags.dim_2))
    return agg, concat, tuple(layers)


FEATURE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def feature_table(graph, flags: TrainFlags, device):
    """The dummy-padded feature table on ``device`` in --feature_dtype,
    or None in featureless mode."""
    if flags.feature_dtype not in FEATURE_DTYPES:
        raise ValueError(
            f"feature_dtype must be one of {tuple(FEATURE_DTYPES)}"
        )
    feats_np = graph.padded_features()
    if feats_np is None:
        return None
    return torch.from_numpy(feats_np).to(
        device=device, dtype=FEATURE_DTYPES[flags.feature_dtype]
    )
