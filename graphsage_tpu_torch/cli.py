"""Command-line interface: ``python -m graphsage_tpu_torch
supervised|predict|unsupervised|embed|eval|walks ...``.

The subcommands take the JAX package's flag names and defaults for the
fields the port reads (``unsupervised`` and ``embed``: lr 1e-5, 1 epoch,
max_degree 100, print_every 50), plus ``--device`` (default ``cuda``).

``supervised``, ``predict``, ``unsupervised`` and ``embed`` run on
several devices with ``--graph_shards N`` (row-sharded tables, the
all-to-all exchange) and ``--data_shards M`` (data parallelism; both:
an M x N grid), and ``supervised`` with ``--n_model_shards K``
(feature-dim tensor parallelism; with ``--data_shards M``: an M x K
grid), one process per device (``parallel/launch.py``): on one
host this command starts the ranks itself (``cuda:0 ..``, or gloo ranks
with ``--device cpu``); ``torchrun --nproc_per_node N -m
graphsage_tpu_torch ...`` runs one rank per process; across hosts each
host runs this command with ``--coordinator_address host:port
--num_processes P --process_id i``. ``predict`` and ``embed`` run
``--data_shards`` alone on one device, and ``unsupervised --model n2v``
trains on one device whatever the shard flags say, as in the JAX
package. ``--n_model_shards`` is read by ``supervised`` alone (the other
subcommands ignore it, as the JAX package's do), which refuses it with
``--graph_shards`` as the JAX package's trainer does.

Every command line of the JAX package's CLI parses here: ``supervised``,
``unsupervised``, ``embed`` and ``predict`` take its one common flag set,
so ``predict`` and ``embed`` accept the training loop's flags and
``--[no-]random_context``, and read none of them, as the JAX package's
do. ``--gpu`` and ``--log_device_placement``, which the JAX package
keeps for the reference's command lines, are accepted and have no
effect; ``--device cuda:<i>`` picks the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from graphsage_tpu_torch.train.config import (
    SUPERVISED_MODELS,
    UNSUPERVISED_MODELS,
    TrainFlags,
)

UNSUP_DEFAULTS = TrainFlags(learning_rate=0.00001, epochs=1, max_degree=100,
                            print_every=50)


def _add_model_flags(p: argparse.ArgumentParser, d: TrainFlags,
                     models=SUPERVISED_MODELS, head: bool = True) -> None:
    """The flags that fix the dataset, the model and its log dir;
    ``head``: the supervised head's flags too."""
    p.add_argument("--train_prefix", required=True,
                   help="prefix of the dataset files")
    p.add_argument("--model", choices=models, default=d.model)
    p.add_argument("--model_size", choices=("small", "big"),
                   default=d.model_size)
    p.add_argument("--learning_rate", type=float, default=d.learning_rate)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--max_degree", type=int, default=d.max_degree)
    p.add_argument("--samples_1", type=int, default=d.samples_1)
    p.add_argument("--samples_2", type=int, default=d.samples_2)
    p.add_argument("--dim_1", type=int, default=d.dim_1)
    p.add_argument("--dim_2", type=int, default=d.dim_2)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--identity_dim", type=int, default=d.identity_dim)
    if head:
        p.add_argument("--samples_3", type=int, default=d.samples_3)
        p.add_argument("--sigmoid", action="store_true",
                       help="sigmoid (multilabel) head")
    p.add_argument("--base_log_dir", default=d.base_log_dir)
    p.add_argument("--sampler_mode",
                   choices=("shared_perm", "independent", "first_k"),
                   default=d.sampler_mode)
    p.add_argument("--fused_gather", action=argparse.BooleanOptionalAction,
                   default=d.fused_gather,
                   help="CUDA kernel for the innermost hop: gather-mean "
                   "(mean, gcn) or gather-MLP-pool (meanpool)")
    p.add_argument("--dedup_gather", action=argparse.BooleanOptionalAction,
                   default=d.dedup_gather,
                   help="the fused gather-mean loads each distinct sample "
                   "of a row once (K3; ignored under dropout)")
    p.add_argument("--rows_gather", action=argparse.BooleanOptionalAction,
                   default=d.rows_gather,
                   help="CUDA row-gather kernel (K4) for the innermost "
                   "hop's rows where no fused kernel reduces them "
                   "(maxpool, twomaxpool, seq)")
    p.add_argument("--feature_dtype", choices=("float32", "bfloat16"),
                   default=d.feature_dtype)
    p.add_argument("--graph_shards", type=int, default=d.graph_shards,
                   help="row-shard the feature/adjacency/identity tables "
                   "over N devices, frontier rows through an all-to-all "
                   "exchange")
    p.add_argument("--data_shards", type=int, default=d.data_shards,
                   help="data parallelism over N devices (whole tables, "
                   "the batch split, gradients summed); with "
                   "--graph_shards G an N x G grid")
    p.add_argument("--capacity_factor", type=float,
                   default=d.capacity_factor,
                   help="--graph_shards per-destination request budget as "
                   "a multiple of the balanced share; 0 sizes it from the "
                   "adjacency (overflowed requests are counted and warned)")
    p.add_argument("--shard_layout", choices=("strided", "block"),
                   default=d.shard_layout,
                   help="--graph_shards row ownership: 'strided' (id %% N) "
                   "spreads degree-ordered hubs; 'block' keeps contiguous "
                   "row ranges")
    p.add_argument("--n_model_shards", type=int, default=d.n_model_shards,
                   help="supervised: feature-dim tensor parallelism over N "
                   "devices (the feature table's columns and layer 0's "
                   "input rows split; with --data_shards M an M x N "
                   "grid); the other subcommands ignore it")
    p.add_argument("--coordinator_address", default=None,
                   help="multi-host: host:port of the rank-0 host's store")
    p.add_argument("--num_processes", type=int, default=None,
                   help="multi-host: the number of hosts (processes of "
                   "this command)")
    p.add_argument("--process_id", type=int, default=None,
                   help="multi-host: this host's index")
    p.add_argument("--defer_features", action=argparse.BooleanOptionalAction,
                   default=d.defer_features,
                   help="leave the feature table on disk at load time "
                   "(node2vec never reads it)")
    p.add_argument("--degree_relabel", action=argparse.BooleanOptionalAction,
                   default=d.degree_relabel,
                   help="renumber the nodes by descending degree (original "
                   "ids round-trip in every output)")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--checkpoint_dir", default=d.checkpoint_dir)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:<i> or cpu; "
                   "cuda:<i> picks the card (the reference's --gpu <i> is "
                   "accepted and has no effect)")
    # the reference's flags, kept by the JAX package's CLI: no effect
    p.add_argument("--gpu", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--log_device_placement", action="store_true",
                   help=argparse.SUPPRESS)


def _add_train_flags(p: argparse.ArgumentParser, d: TrainFlags) -> None:
    """The training loop's flags (``predict`` and ``embed`` accept them,
    as the JAX package's do, and read none)."""
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--validate_iter", type=int, default=d.validate_iter)
    p.add_argument("--validate_batch_size", type=int,
                   default=d.validate_batch_size)
    p.add_argument("--print_every", type=int, default=d.print_every)
    p.add_argument("--max_total_steps", type=int, default=d.max_total_steps)
    p.add_argument("--checkpoint_every", type=int,
                   default=d.checkpoint_every)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile_dir", default=d.profile_dir,
                   help="torch.profiler's Chrome trace of the training "
                   "loop, written into this directory")
    p.add_argument("--log_histograms", action="store_true",
                   help="histograms of the params and a probe batch's "
                   "activations at print steps (histograms.jsonl, and "
                   "TensorBoard where it imports)")
    p.add_argument("--random_context", action=argparse.BooleanOptionalAction,
                   default=d.random_context,
                   help="unsupervised: train on the walk pairs of "
                   "<prefix>-walks.txt (else on the graph's edges)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m graphsage_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    d = TrainFlags()
    du = UNSUP_DEFAULTS

    p = sub.add_parser("supervised", help="supervised node classification")
    _add_model_flags(p, d)
    _add_train_flags(p, d)

    p = sub.add_parser(
        "predict", help="checkpoint -> class predictions for any dataset")
    _add_model_flags(p, d)
    p.add_argument("--nodes", choices=("test", "val", "train", "all"),
                   default="test")
    _add_train_flags(p, d)
    p.add_argument("--num_classes", type=int, default=0,
                   help="required when the dataset has no class_map")
    p.add_argument("--out_dir", default=None)

    p = sub.add_parser("unsupervised",
                       help="unsupervised embedding training")
    _add_model_flags(p, du, UNSUPERVISED_MODELS, head=False)
    _add_train_flags(p, du)
    p.add_argument("--neg_sample_size", type=int, default=du.neg_sample_size)
    p.add_argument("--n2v_test_epochs", type=int, default=du.n2v_test_epochs,
                   help="epochs of node2vec's retrain on the val and test "
                   "nodes (with --save_embeddings)")
    p.add_argument("--save_embeddings",
                   action=argparse.BooleanOptionalAction,
                   default=du.save_embeddings,
                   help="write every node's embedding to val.npy/val.txt "
                   "in the log dir at the end")

    p = sub.add_parser(
        "embed", help="checkpoint -> every node's embedding for any dataset")
    _add_model_flags(p, du, SUPERVISED_MODELS, head=False)
    _add_train_flags(p, du)
    p.add_argument("--neg_sample_size", type=int, default=du.neg_sample_size,
                   help="accepted for the unsupervised command lines; "
                   "embedding draws no negatives")
    p.add_argument("--out_dir", default=None,
                   help="output dir (default: the unsupervised log dir)")

    p = sub.add_parser("eval", help="logistic-regression eval of saved "
                       "embeddings (the reference's eval scripts)")
    p.add_argument("train_prefix", help="dataset prefix")
    p.add_argument("embed_dir",
                   help="directory with val.npy/val.txt, or 'feat'")
    p.add_argument("setting", choices=("val", "test"))
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--sgd_max_iter", type=int, default=None,
                   help="fix the SGD epochs, with no tolerance stop (else "
                   "up to 1000, stopping at tol 1e-3)")
    p.add_argument("--label_tsvs", default=None,
                   help="comma-separated per-class TSV label files (the "
                   "reference's citation eval)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:<i> or cpu; "
                   "the fit steps once per sample, six kernel launches "
                   "a step on the card, so cpu fits faster")

    p = sub.add_parser("walks", help="random-walk pairs of the train-node "
                       "subgraph, as a walks file")
    p.add_argument("graph_file", help="<prefix>-G.json path")
    p.add_argument("out_file")
    p.add_argument("--num_walks", type=int, default=50)
    p.add_argument("--walk_len", type=int, default=5)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", default="cuda",
                   help="accepted as by every subcommand; the walker runs "
                   "on the host")
    return parser


def _walks(args) -> None:
    import numpy as np

    from graphsage_tpu_torch.data.io import load_data
    from graphsage_tpu_torch.data.walks import run_random_walks, write_walks

    graph = load_data(args.graph_file[: -len("-G.json")], normalize=False)
    # the reference walks the train-node subgraph
    is_train = graph.is_train
    sub_neighbors = [nbrs[is_train[nbrs]] if is_train[i] else nbrs[:0]
                     for i, nbrs in enumerate(graph.neighbors)]
    pairs = run_random_walks(sub_neighbors, np.flatnonzero(is_train),
                             num_walks=args.num_walks,
                             walk_len=args.walk_len,
                             rng=np.random.default_rng(args.seed))
    write_walks(args.out_file, pairs, graph.node_ids)
    print(f"Wrote {len(pairs)} walk pairs to {args.out_file}")


def flags_from_args(args) -> TrainFlags:
    """The ``TrainFlags`` of a parsed ``supervised``, ``predict``,
    ``unsupervised`` or ``embed`` command line: its subcommand's defaults
    with every parsed field put in, as the JAX package's
    ``_flags_from_args``."""
    unsup = args.command in ("unsupervised", "embed")
    defaults = UNSUP_DEFAULTS if unsup else TrainFlags()
    fields = {f.name for f in dataclasses.fields(TrainFlags)}
    return dataclasses.replace(
        defaults, **{k: v for k, v in vars(args).items() if k in fields})


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "walks":
        _walks(args)
        return 0
    if args.command == "eval":
        from graphsage_tpu_torch.evaluation import evaluate_embeddings

        evaluate_embeddings(
            args.train_prefix, args.embed_dir, args.setting, seed=args.seed,
            sgd_max_iter=args.sgd_max_iter,
            label_tsvs=(args.label_tsvs.split(",") if args.label_tsvs
                        else None),
            device=args.device)
        return 0
    multi_host = (args.coordinator_address is not None
                  or (args.num_processes or 1) > 1)
    flags = flags_from_args(args)
    if args.command == "unsupervised" and flags.model == "n2v":
        # node2vec trains on one device whatever the shard flags say, as
        # in the JAX package: no rank is started
        from graphsage_tpu_torch.train.unsupervised import train

        train(flags, device=args.device)
        return 0
    from graphsage_tpu_torch.parallel import launch

    grid = (flags.graph_shards, flags.data_shards)
    model_shards = 1
    if args.command == "supervised":
        from graphsage_tpu_torch.train.config import check_model_shards

        check_model_shards(flags)
        model_shards = flags.n_model_shards
        fn, fn_args = launch.supervised_rank, (flags,)
    elif args.command == "unsupervised":
        fn, fn_args = launch.unsupervised_rank, (flags,)
    elif args.command == "predict":
        fn, fn_args = launch.predict_rank, (
            flags, args.out_dir, args.nodes, args.num_classes)
    else:
        fn, fn_args = launch.embed_rank, (flags, args.out_dir)
    if args.command in ("predict", "embed") and flags.graph_shards == 1:
        grid = (1, 1)   # as the JAX package's predict and embed
    if grid[0] * grid[1] * model_shards > 1 or multi_host:
        launch.run_command(
            fn, fn_args, *grid, model_shards=model_shards, device=args.device,
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes,
            process_id=args.process_id)
    else:
        fn(args.device, *fn_args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
