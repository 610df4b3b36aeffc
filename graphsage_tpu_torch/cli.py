"""Command-line interface: ``python -m graphsage_tpu_torch supervised|predict
...``.

Both subcommands take the JAX package's flag names and defaults for the
fields the port reads, plus ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from graphsage_tpu_torch.train.config import SUPERVISED_MODELS, TrainFlags


def _add_model_flags(p: argparse.ArgumentParser, d: TrainFlags) -> None:
    """The flags that fix the dataset, the model and its log dir."""
    p.add_argument("--train_prefix", required=True,
                   help="prefix of the dataset files")
    p.add_argument("--model", choices=SUPERVISED_MODELS, default=d.model)
    p.add_argument("--model_size", choices=("small", "big"),
                   default=d.model_size)
    p.add_argument("--learning_rate", type=float, default=d.learning_rate)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--max_degree", type=int, default=d.max_degree)
    p.add_argument("--samples_1", type=int, default=d.samples_1)
    p.add_argument("--samples_2", type=int, default=d.samples_2)
    p.add_argument("--samples_3", type=int, default=d.samples_3)
    p.add_argument("--dim_1", type=int, default=d.dim_1)
    p.add_argument("--dim_2", type=int, default=d.dim_2)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--identity_dim", type=int, default=d.identity_dim)
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
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--checkpoint_dir", default=d.checkpoint_dir)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:<i> or cpu")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m graphsage_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    d = TrainFlags()

    p = sub.add_parser("supervised", help="supervised node classification")
    _add_model_flags(p, d)
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

    p = sub.add_parser(
        "predict", help="checkpoint -> class predictions for any dataset")
    _add_model_flags(p, d)
    p.add_argument("--nodes", choices=("test", "val", "train", "all"),
                   default="test")
    p.add_argument("--num_classes", type=int, default=0,
                   help="required when the dataset has no class_map")
    p.add_argument("--out_dir", default=None)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(TrainFlags)}
    flags = TrainFlags(**{k: v for k, v in vars(args).items()
                          if k in fields})
    if args.command == "supervised":
        from graphsage_tpu_torch.train.supervised import train

        train(flags, device=args.device)
    elif args.command == "predict":
        from graphsage_tpu_torch.infer import predict

        predict(flags, out_dir=args.out_dir, nodes=args.nodes,
                num_classes=args.num_classes, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
