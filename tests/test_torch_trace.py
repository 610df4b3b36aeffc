"""The port's spans (``graphsage_tpu_torch/trace.py``): off they read no
clock and enter no profiler range; on they keep their tree, units and
intervals, lie inside their profiler ranges on the Chrome trace's clock,
and leave every result of the runner, the evaluation step and the sweep
bit for bit as it was; ``snapshot`` reads the kernels' launch
counters."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graphsage_tpu_torch import trace
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.synthetic import make_synthetic_graph
from graphsage_tpu_torch.models.graphsage import LayerInfo, SAGEConfig
from graphsage_tpu_torch.models.supervised import (
    SupervisedConfig,
    init_supervised_params,
    make_optimizer,
)
from graphsage_tpu_torch.ops.gather import fused_gather_mean, fused_gather_rows
from graphsage_tpu_torch.ops.pool import (
    fused_gather_mlp_pool,
    gather_mlp_pool_train,
    route_pool_grad,
)
from graphsage_tpu_torch.parallel import launch
from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner
from graphsage_tpu_torch.train.supervised import make_eval_step, make_eval_sweep

B = 8
STEPS = 3


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with the spans off and none kept."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _refuse(*args, **kwargs):
    raise AssertionError("called with the spans off")


def test_off_reads_no_clock_and_enters_no_range(monkeypatch):
    monkeypatch.setattr(trace.time, "time_ns", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    assert not trace.enabled()
    first = trace.span("train.step")
    assert trace.span("sample") is first
    with trace.span("train.step"):
        with trace.span("sample"):
            pass
    assert trace.drain() == []


def test_on_keeps_parents_units_and_intervals():
    trace.enable(record=True)
    assert trace.enabled()
    with trace.span("train.chunk"):
        for _ in range(2):
            with trace.span("train.step"):
                with trace.span("sample"):
                    pass
                with trace.span("backward"):
                    pass
    with trace.span("eval.step"):
        with trace.span("head"):
            pass
    trace.disable()
    spans = trace.drain()
    assert [(s.name, s.parent, s.unit) for s in spans] == [
        ("train.chunk", -1, -1),
        ("train.step", 0, 1), ("sample", 1, 1), ("backward", 1, 1),
        ("train.step", 0, 2), ("sample", 4, 2), ("backward", 4, 2),
        ("eval.step", -1, 3), ("head", 7, 3)]
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert s.thread == spans[0].thread
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert trace.drain() == []
    with trace.span("sample"):      # off again: nothing kept
        pass
    assert trace.drain() == []


def test_each_thread_keeps_its_own_stack():
    trace.enable(record=True)
    with trace.span("train.step"):
        worker = threading.Thread(target=lambda: trace.span("sample")
                                  .__enter__().__exit__(None, None, None))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with trace.span("sample"):
            pass
    spans = trace.drain()
    assert [(s.name, s.parent, s.unit) for s in spans] == [
        ("train.step", -1, 1), ("sample", -1, -1), ("sample", 0, 1)]
    assert spans[0].thread == spans[2].thread == threading.get_native_id()
    assert spans[1].thread != spans[0].thread


def test_enable_restarts_the_units():
    for _ in range(2):
        trace.enable(record=True)
        with trace.span("eval.step"):
            pass
        trace.disable()
        assert [s.unit for s in trace.drain()] == [1]


def test_a_drain_inside_a_span_keeps_the_rest_consistent():
    trace.enable(record=True)
    with trace.span("train.step"):
        trace.drain()
        with trace.span("sample"):
            pass
    assert [(s.name, s.parent, s.unit) for s in trace.drain()] == [
        ("sample", -1, 1)]


def test_annotated_ranges_enclose_the_spans_on_the_trace_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.enable(record=True, annotate=True)
        for _ in range(20):
            with trace.span("train.step"):
                with trace.span("sample"):
                    torch.ones(64).sum()
                with trace.span("optimizer"):
                    torch.ones(64).mul_(2.0)
        trace.disable()
    spans = trace.drain()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fp:
        doc = json.load(fp)
    base = doc["baseTimeNanoseconds"]
    ranges = sorted((e for e in doc["traceEvents"]
                     if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"])
    assert len(ranges) == len(spans) == 60
    for s, r in zip(sorted(spans, key=lambda s: s.start_ns), ranges):
        assert r["name"] == s.name
        assert r["tid"] == s.thread
        lo = r["ts"] * 1e3 + base
        hi = (r["ts"] + r["dur"]) * 1e3 + base
        assert lo <= s.start_ns and s.end_ns <= hi


def _toy(aggregator: str, dropout: float):
    g = make_synthetic_graph(num_nodes=60, num_classes=3, feat_dim=8, seed=4)
    _, _, adj = build_both_adjs(g, 6, seed=1)
    sage = SAGEConfig(layers=(LayerInfo(3, 6), LayerInfo(2, 6)),
                      feature_dim=8, aggregator=aggregator,
                      num_nodes=g.num_nodes, dropout=dropout,
                      fused_gather=True)
    cfg = SupervisedConfig(sage=sage, num_classes=3, weight_decay=1e-3)
    labels = np.zeros((g.num_nodes + 1, 3), dtype=np.float32)
    labels[:g.num_nodes] = g.labels
    ids = np.full((STEPS * B,), g.num_nodes, dtype=np.int32)
    ids[:STEPS * B - 3] = np.random.default_rng(2).permutation(
        g.num_nodes)[:STEPS * B - 3]
    return (cfg, torch.from_numpy(g.padded_features()), torch.from_numpy(adj),
            torch.from_numpy(ids), torch.from_numpy(labels))


def _run(aggregator: str, dropout: float):
    """The chunk runner's STEPS steps, one evaluation step and a sweep
    over the same ids -> every result, on the CPU."""
    cfg, feats, adj, ids, labels = _toy(aggregator, dropout)
    params = init_supervised_params(torch.Generator().manual_seed(0), cfg)
    optimizer = make_optimizer(0.01)
    state = optimizer.init(params)
    gen = torch.Generator().manual_seed(7)
    run = make_supervised_chunk_runner(cfg, optimizer, B)
    _, _, loss, logits, _ = run(params, state, gen, feats, adj, ids, labels,
                                0, STEPS, drop_seed=11)
    mask = (ids[:B] != cfg.sage.num_nodes).float()
    step = make_eval_step(cfg)(params, feats, adj, ids[:B],
                               labels.index_select(0, ids[:B]), mask, gen)
    sweep = make_eval_sweep(cfg, B, cfg.sage.num_nodes)(
        params, feats, adj, ids, labels, gen)
    return [loss, logits, *step, *sweep, *params.values()]


@pytest.mark.parametrize("aggregator,dropout", [("mean", 0.0),
                                                ("meanpool", 0.5)])
def test_spans_leave_the_results_bit_for_bit(aggregator, dropout):
    off = _run(aggregator, dropout)
    trace.enable(record=True, annotate=True)
    on = _run(aggregator, dropout)
    trace.disable()
    assert trace.drain()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_the_span_tree_of_training_and_evaluation():
    trace.enable(record=True)
    _run("meanpool", 0.0)
    trace.disable()
    spans = trace.drain()
    names = [s.name for s in spans]
    top = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [names[i] for i in top] == ["train.chunk", "eval.step",
                                       "eval.sweep"]
    steps = [i for i, s in enumerate(spans) if s.name == "train.step"]
    assert len(steps) == STEPS
    assert all(spans[i].parent == top[0] for i in steps)
    for i in steps:
        children = [s.name for s in spans if s.parent == i]
        assert children == ["sample", "gather", "aggregate", "head",
                            "backward", "optimizer"]
    batches = [i for i, s in enumerate(spans)
               if s.name == "eval.step" and s.parent == top[2]]
    assert len(batches) == STEPS
    for i in [top[1]] + batches:
        assert [s.name for s in spans if s.parent == i] == [
            "sample", "gather", "aggregate", "head", "head"]
    # one unit a step or batch, every span inside it carrying its number
    units = [spans[i].unit for i in steps + [top[1]] + batches]
    assert units == list(range(1, 2 * STEPS + 2))
    for s in spans:
        if s.parent >= 0 and spans[s.parent].unit > 0:
            assert s.unit == spans[s.parent].unit
    assert spans[top[0]].unit == spans[top[2]].unit == -1


def test_snapshot_reads_the_kernels_counters(monkeypatch):
    for fn, attr, value in [
            (fused_gather_mean, "launches", 3),
            (fused_gather_mean, "dropout_launches", 5),
            (fused_gather_mean, "dedup_launches", 7),
            (fused_gather_rows, "launches", 11),
            (fused_gather_mlp_pool, "launches", 13),
            (fused_gather_mlp_pool, "train_launches", 17),
            (route_pool_grad, "mask_backwards", 19),
            (route_pool_grad, "recomputes", 23)]:
        monkeypatch.setattr(fn, attr, value)
    assert trace.snapshot() == {"K1": 3, "K2": 5, "K3": 7, "K4": 11,
                                "K5": 13, "K6": 17, "pool_grad_mask": 19,
                                "pool_grad_recompute": 23}
    assert launch.gather_launches() == {"K1": 3, "K2": 5, "K3": 7, "K4": 11}


def test_snapshot_counts_the_pool_backwards_by_route():
    """Every meanpool training step's backward takes relu' from the
    forward's mask; a max pool's backward recomputes z."""
    cfg, feats, adj, ids, labels = _toy("meanpool", 0.0)
    params = init_supervised_params(torch.Generator().manual_seed(0), cfg)
    optimizer = make_optimizer(0.01)
    run = make_supervised_chunk_runner(cfg, optimizer, B)
    before = trace.snapshot()
    run(params, optimizer.init(params), torch.Generator().manual_seed(7),
        feats, adj, ids, labels, 0, STEPS)
    after = trace.snapshot()
    assert after["pool_grad_mask"] - before["pool_grad_mask"] == STEPS
    assert after["pool_grad_recompute"] == before["pool_grad_recompute"]

    w = torch.randn(8, 6, requires_grad=True)
    b = torch.zeros(6, requires_grad=True)
    idx = torch.randint(0, 60, (4, 3), dtype=torch.int32)
    gather_mlp_pool_train(feats, idx, w, b, "max").sum().backward()
    last = trace.snapshot()
    assert last["pool_grad_recompute"] - after["pool_grad_recompute"] == 1
    assert last["pool_grad_mask"] == after["pool_grad_mask"]
