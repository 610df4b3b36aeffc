"""The system under test, behind the calls the modes make: the port's
entry points (``"port"``), or the plain reference put in their place in
TF32, the precision below the configuration's float32 (``"control"``),
which the output check has to refuse.

The port is reached through its own entry points only:
``train/supervised.py::build_supervised_config`` over
``train/config.py::TrainFlags`` (the CLI's flags), the chunk runner of
``parallel/dp.py`` with ``models/supervised.py::make_optimizer``, and
``train/supervised.py``'s ``make_eval_sweep`` and ``make_eval_step``;
``ops/build.py`` builds its CUDA libraries.
"""

from __future__ import annotations

import types

import torch

from port_bench.reference import sage


def port_config(cfg: dict):
    from graphsage_tpu_torch.train.config import TrainFlags
    from graphsage_tpu_torch.train.supervised import build_supervised_config

    flags = TrainFlags(
        model=cfg["model"], model_size=cfg["model_size"],
        learning_rate=cfg["learning_rate"], dropout=cfg["dropout"],
        weight_decay=cfg["weight_decay"], max_degree=cfg["max_degree"],
        samples_1=cfg["samples_1"], samples_2=cfg["samples_2"],
        dim_1=cfg["dim_1"], dim_2=cfg["dim_2"], sigmoid=cfg["sigmoid"],
        sampler_mode=cfg["sampler_mode"], fused_gather=cfg["fused_gather"],
        feature_dtype=cfg["feature_dtype"])
    graph = types.SimpleNamespace(feature_dim=cfg["feature_dim"],
                                  num_nodes=cfg["num_nodes"],
                                  num_classes=cfg["num_classes"])
    return build_supervised_config(flags, graph)


def build_kernels(cfg: dict) -> str:
    """Build the port's CUDA libraries the configuration's path launches
    (nothing when they are current) -> nvcc's output."""
    from graphsage_tpu_torch.ops import build

    names = ["gather_mean"]
    if cfg["aggregator"] in ("meanpool", "maxpool"):
        names.append("gather_mlp_pool")
    return "".join(build.build(n)[1] for n in names)


# ------------------------------------------------------------ the port

class PortTrainer:
    def __init__(self, cfg: dict, batch: int):
        from graphsage_tpu_torch.models.supervised import make_optimizer
        from graphsage_tpu_torch.parallel.dp import (
            make_supervised_chunk_runner,
        )

        self.optimizer = make_optimizer(cfg["learning_rate"], cfg["clip"])
        self.runner = make_supervised_chunk_runner(port_config(cfg),
                                                   self.optimizer, batch)

    def init(self, params: dict):
        return self.optimizer.init(params)

    def run(self, params, state, gen, graph, ids_perm, start: int, n: int,
            observe=None):
        """Steps start .. start + n - 1 -> the last step's loss (on the
        device). ``observe(i, loss)``, where given, is called as step i's
        loss is made: the parameters and the optimizer's state are then
        those after step i - 1 (the runner's loss function is wrapped for
        the call, nothing else changes)."""
        args = (params, state, gen, graph.features, graph.adj, ids_perm,
                graph.labels_table, start, n)
        if observe is None:
            return self.runner(*args)[2]
        from graphsage_tpu_torch.parallel import dp

        loss_fn, steps = dp.supervised_loss, iter(range(start, start + n))

        def watched(*a, **kw):
            value, logits = loss_fn(*a, **kw)
            observe(next(steps), value.detach())
            return value, logits
        dp.supervised_loss = watched
        try:
            return self.runner(*args)[2]
        finally:
            dp.supervised_loss = loss_fn

    def first_grads(self, state, params: dict) -> dict:
        """The gradient Adam took at step 1, from its first moment after
        that step: m = (1 - b1) g (zero where Adam holds no state)."""
        return {k: (state.state[p]["exp_avg"] / (1 - self.optimizer.b1)
                    if state.state.get(p) else torch.zeros_like(p))
                for k, p in params.items()}


class PortEval:
    def __init__(self, cfg: dict, batch: int):
        from graphsage_tpu_torch.train.supervised import (
            make_eval_step,
            make_eval_sweep,
        )

        config = port_config(cfg)
        self.num_nodes = cfg["num_nodes"]
        self._sweep = make_eval_sweep(config, batch, cfg["num_nodes"])
        self._step = make_eval_step(config)

    def sweep(self, params, graph, ids_all, gen):
        """(per-batch losses, [n_b * B, C] predictions) on the device."""
        return self._sweep(params, graph.features, graph.adj, ids_all,
                           graph.labels_table, gen)

    def request(self, params, graph, ids, mask, gen):
        labels = graph.labels_table.index_select(0, ids)
        return self._step(params, graph.features, graph.adj, ids, labels,
                          mask, gen)


# ------------------------------------------- the reference as control

class ControlTrainer:
    """The reference's step in TF32, drawing its permutations from the
    generator the run hands the program."""

    def __init__(self, cfg: dict, batch: int):
        self.cfg, self.batch = cfg, batch

    def init(self, params: dict):
        return sage.Adam(params, self.cfg["learning_rate"], self.cfg["clip"])

    def run(self, params, state, gen, graph, ids_perm, start: int, n: int,
            observe=None):
        b = self.batch
        with sage.precision(tf32=True):
            for i in range(start, start + n):
                perms = [torch.randperm(self.cfg["max_degree"], generator=gen,
                                        device=graph.adj.device)
                         for _ in range(2)]
                value, grads = sage.loss_and_grads(
                    self.cfg, params, graph.features, graph.adj,
                    ids_perm[i * b:(i + 1) * b], graph.labels_table, perms,
                    graph.num_nodes)
                if observe is not None:
                    observe(i, value)
                state.step(params, grads)
        return value

    def first_grads(self, state, params: dict) -> dict:
        return {k: state.m[k] / (1 - state.b1) for k in params}


class ControlEval:
    def __init__(self, cfg: dict, batch: int):
        self.cfg, self.batch = cfg, batch

    def _predict(self, params, graph, ids, gen):
        perms = [torch.randperm(self.cfg["max_degree"], generator=gen,
                                device=graph.adj.device) for _ in range(2)]
        with sage.precision(tf32=True):
            return torch.exp(sage.log_predictions(
                self.cfg, params, graph.features, graph.adj, ids, perms))

    def sweep(self, params, graph, ids_all, gen):
        b = self.batch
        preds = torch.cat([self._predict(params, graph, ids_all[i:i + b], gen)
                           for i in range(0, ids_all.shape[0], b)])
        return torch.zeros(ids_all.shape[0] // b, device=preds.device), preds

    def request(self, params, graph, ids, mask, gen):
        return torch.zeros((), device=ids.device), self._predict(
            params, graph, ids, gen)


PROGRAMS = {"port": (PortTrainer, PortEval),
            "control": (ControlTrainer, ControlEval)}


def trainer(kind: str, cfg: dict, batch: int):
    return PROGRAMS[kind][0](cfg, batch)


def evaluator(kind: str, cfg: dict, batch: int):
    return PROGRAMS[kind][1](cfg, batch)
