"""The yardstick's counts against hand counts, the inputs drawn from the
seed, and the trace's reduction on a synthetic trace."""

from __future__ import annotations

import pytest
import torch

from port_bench import counts, inputs, spec, trace
from port_bench.reference import sage
from port_bench.tests.conftest import CELLS, TOY_CONFIG


def test_edges_a_step():
    assert counts.supports((25, 10)) == [1, 10, 250]
    assert counts.edges_per_batch((25, 10), 512) == 133_120


def test_model_flops_by_hand():
    cfg = dict(feature_dim=3, dim_1=2, dim_2=2, samples_1=2, samples_2=3,
               num_classes=4, aggregator="mean")
    # layer 0: hop 0 (1 row, 3 samples) 12 + 9 + 12, hop 1 (3 rows, 2
    # samples) 36 + 18 + 36; layer 1 (input 4): 16 + 12 + 16; head 32
    assert counts.model_flops(cfg, 1, training=False) == 199
    # weight gradients of every product (96 in layer 0, 32 in layer 1,
    # 32 the head), the activations' of layer 1 and the head (32 + 32)
    # and layer 1's mean (12)
    assert counts.model_flops(cfg, 1, training=True) == 199 + 236


def test_meanpool_flops_at_the_published_widths():
    cfg = spec.cell("meanpool-reddit-train").config
    # the innermost hop's MLP: 2 * 5120 * 25 * 602 * 512 = 78.9 GFLOP
    fwd = counts.model_flops(cfg, 512, training=False)
    assert 84e9 < fwd < 86e9
    assert 170e9 < counts.model_flops(cfg, 512, training=True) < 175e9


def test_kernel_bytes_by_hand():
    idx = torch.tensor([[0, 1], [1, 2]], dtype=torch.int32)
    assert counts.gather_mean_bytes(idx, 3) == 36 + 24 + 16
    idx = torch.tensor([[0, 0], [1, 2]], dtype=torch.int32)
    assert counts.gather_pool_bytes(idx, 3, 5, residual=False) == (
        36 + 60 + 20 + 16 + 40)
    assert counts.gather_pool_bytes(idx, 3, 5, residual=True) == (
        36 + 60 + 20 + 16 + 40 + 48)
    assert counts.gather_pool_flops(idx, 3, 5) == 2 * 4 * 3 * 5
    assert counts.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert counts.least_seconds(0.0, 990e12) == pytest.approx(2.0)


def _cfg(name):
    cfg = dict(spec.cell(name).config)
    cfg.update(TOY_CONFIG)
    return cfg


@pytest.mark.parametrize("name", CELLS)
def test_inputs_are_the_seeds(name):
    cfg = _cfg(name)
    a, b = (inputs.make_graph(cfg, 2**33 + 5, "cpu") for _ in range(2))
    c = inputs.make_graph(cfg, 2**33 + 6, "cpu")
    n = cfg["num_nodes"]
    assert torch.equal(a.adj, b.adj) and torch.equal(a.features, b.features)
    assert not torch.equal(a.adj, c.adj)
    assert a.adj.dtype == torch.int32 and a.adj.shape == (n + 1, 16)
    assert int(a.adj[:n].min()) >= 0 and int(a.adj[:n].max()) < n
    assert bool((a.adj[n] == n).all()) and not a.features[n].any()
    assert torch.equal(a.labels_table.sum(1)[:n], torch.ones(n))
    counts_ = torch.bincount(a.adj[:n].reshape(-1).long(), minlength=n)
    assert int(counts_.argmax()) == 0     # id 0 is the hub
    p1 = inputs.make_params(cfg, 7, "cpu")
    assert all(torch.equal(v, inputs.make_params(cfg, 7, "cpu")[k])
               for k, v in p1.items())


@pytest.mark.parametrize("name", CELLS)
def test_param_shapes_are_the_ports(name):
    from graphsage_tpu_torch.models.supervised import init_supervised_params

    from port_bench import program

    cfg = spec.cell(name).config      # the published widths
    port = init_supervised_params(torch.Generator().manual_seed(0),
                                  program.port_config(cfg))
    ours = inputs.make_params(cfg, 1, "cpu")
    assert list(ours) == list(port)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in port.items()}
    for k, shape in sage.param_shapes(cfg).items():
        if k.endswith(".b"):
            assert not ours[k].any()
        else:
            assert float(ours[k].abs().max()) <= sage.glorot_limit(shape)


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN, "ts": 100,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 90, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 105, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 150,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 250, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 110,
         "dur": 60},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 120, "dur": 5},
    ]
    # the breakdown span: its length from the range, its idle gaps
    window_s, busy_s, gaps = trace.idle_gaps(ev, 0.0)
    assert window_s == pytest.approx(100e-6)
    # busy: [100, 115) and [150, 160)
    assert busy_s == pytest.approx(25e-6)
    gaps = dict(gaps)
    # [115, 150) under aten::mm (at 132.5), [160, 200) with no host op
    assert gaps["aten::mm"] == pytest.approx(35e-6)
    assert gaps["host: no traced op"] == pytest.approx(40e-6)
    # the metrics span: every device operation, from one synchronise to
    # the next; its length is the host's
    ops, busy_s = trace.device_busy(ev)
    assert [o.name for o in ops] == ["a", "b", "copy", "late"]
    # busy: [90, 115), [150, 160) and [250, 255)
    assert busy_s == pytest.approx(40e-6)
    view = trace.View(ops, 160e-6, busy_s, 2, {})
    assert len(view.kernels) == 3
    share = spec.reader("idle_share.train")(view)
    assert share == pytest.approx(75.0)
