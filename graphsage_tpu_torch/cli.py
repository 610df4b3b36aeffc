"""Command-line interface: ``python -m graphsage_tpu_torch predict ...``.

The ``predict`` subcommand takes the JAX package's flag names and
defaults, plus ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from graphsage_tpu_torch.train.config import SUPERVISED_MODELS, TrainFlags


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m graphsage_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    d = TrainFlags()
    p = sub.add_parser(
        "predict", help="checkpoint -> class predictions for any dataset")
    p.add_argument("--train_prefix", required=True,
                   help="prefix of the dataset files")
    p.add_argument("--checkpoint_dir", default=d.checkpoint_dir)
    p.add_argument("--model", choices=SUPERVISED_MODELS, default=d.model)
    p.add_argument("--model_size", choices=("small", "big"),
                   default=d.model_size)
    p.add_argument("--learning_rate", type=float, default=d.learning_rate,
                   help="the training run's rate (names the log dir)")
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
                   help="CUDA gather+mean kernel for the innermost hop")
    p.add_argument("--feature_dtype", choices=("float32", "bfloat16"),
                   default=d.feature_dtype)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--nodes", choices=("test", "val", "train", "all"),
                   default="test")
    p.add_argument("--num_classes", type=int, default=0,
                   help="required when the dataset has no class_map")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:<i> or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "predict":
        from graphsage_tpu_torch.infer import predict

        fields = {f.name for f in dataclasses.fields(TrainFlags)}
        flags = TrainFlags(**{k: v for k, v in vars(args).items()
                              if k in fields})
        predict(flags, out_dir=args.out_dir, nodes=args.nodes,
                num_classes=args.num_classes, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
