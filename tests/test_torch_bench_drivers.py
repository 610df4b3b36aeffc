"""The port's measurement drivers (``graphsage_tpu_torch/benchmarks/``:
bench, agg_sweep, serving_bench, step_profile, sampler_probe,
scaling_probe, halo_probe) against the JAX package's drivers on the CPU.

The workloads draw the same tables, labels and ids from the same numpy
generators, bit for bit; the halo probe's least zero-drop
capacity factors equal the JAX probe's at a toy shape (2 gloo ranks
against 2 of the virtual CPU devices); each driver's entry point prints
the JAX script's keys at a toy size with ``--device cpu``, and raises
without a card otherwise.
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

import bench as jbench
import benchmarks.agg_sweep as jagg
from graphsage_tpu_torch.benchmarks import (
    agg_sweep,
    bench,
    halo_probe,
    sampler_probe,
    scaling_probe,
    serving_bench,
    step_profile,
)

torch.set_num_threads(2)

# a toy of bench.py's shape for the entry points
TOY = dict(NUM_NODES=300, FEAT_DIM=12, NUM_CLASSES=5, MAX_DEGREE=8,
           BATCH=16, FANOUTS=(4, 3), DIMS=(8, 8))
# the halo probe's toy: the innermost frontier (64 * 10 * 25 rows) is
# past the exact-capacity limit (4096), so the capacity factor matters
HALO_TOY = dict(NUM_NODES=600, FEAT_DIM=8, MAX_DEGREE=32, BATCH=64)

# the JAX scripts' printed keys
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "baseline_provenance", "baseline_edges_per_sec",
              "vs_reenactment", "graph_dist", "sec_per_step",
              "sec_per_step_dispatch", "roofline_frac",
              "secondary"}                               # bench.py:390-421
SECONDARY_KEYS = {f"{n}_edges_per_sec" for n in bench.SECONDARY_CONFIGS} | {
    "serving_embed_nodes_per_sec"}                       # bench.py:247, 282
AGG_KEYS = {"config", "aggregator", "model_size", "fused_gather", "dist",
            "identity_dim", "unsupervised", "dropout", "ms_per_step",
            "edges_per_step", "edges_per_sec", "iters_per_chunk", "trials",
            "wall_s", "recorded_utc"}                    # agg_sweep.py:288-305
# benchmarks/serving_bench.py:134-146
SERVING_KEYS = {"metric", "value", "unit", "edges_per_sec", "sweep_s",
                "n_nodes", "batch_size", "graph_dist", "reference"}
# benchmarks/scaling_probe.py:197-206
SCALING_KEYS = {"metric", "devices", "data_shards", "platform", "value",
                "unit", "scaling_efficiency_vs_smallest", "icinote"}
# benchmarks/step_profile.py:131-137
STEP_CASES = ("full_step(fwd+bwd+adam)", "forward_loss_only",
              "sage_embed_only", "sample+gathers_only",
              "sample+inner_gather")
# benchmarks/sampler_probe.py:140-144
SAMPLER_CASES = [f"[{m}] {c}" for m in ("independent", "shared_perm",
                                        "first_k")
                 for c in ("sampling_only", "sample+inner_gather",
                           "full_step")]


@pytest.fixture
def toy(monkeypatch):
    """bench's and agg_sweep's shapes cut to TOY, the counts to 1-2."""
    for mod in (bench, agg_sweep):
        for k, v in TOY.items():
            monkeypatch.setattr(mod, k, v)
    for mod, counts in ((bench, dict(WARMUP=1, ITERS=2)),
                        (agg_sweep, dict(ITERS=2, TRIALS=1)),
                        (serving_bench, dict(TRIALS=1)),
                        (step_profile, dict(INNER=2, ITERS=1)),
                        (sampler_probe, dict(INNER=2, ITERS=1)),
                        (scaling_probe, dict(CHUNK=2, TIMED_CHUNKS=1)),
                        (halo_probe, dict(ITERS=2, **HALO_TOY))):
        for k, v in counts.items():
            monkeypatch.setattr(mod, k, v)


def _printed(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def _rates_positive(values) -> None:
    for v in values:
        assert np.isfinite(v) and v > 0, values


# ----------------------------------------------------------- workloads

def test_zipf_adjacency_bit_equal_full_size():
    got = bench.zipf_adjacency(np.random.default_rng(0))
    want = jbench.zipf_adjacency(np.random.default_rng(0))
    assert got.shape == (100_001, 128) and got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dist", ["zipf", "uniform"])
def test_build_matches_bench(dist):
    """Features (JAX's first 602 of 640 padded columns), adjacency,
    labels and ids of bench.py's ``build``, at full size."""
    got = bench.build(dist=dist)
    (_, _, _, features, adj, ids, labels, mask,
     config) = jbench.build(dist=dist)
    F = bench.FEAT_DIM
    assert np.array_equal(got["features"].numpy(),
                          np.asarray(features)[:, :F])
    assert not np.asarray(features)[:, F:].any()
    assert np.array_equal(got["adj"].numpy(), np.asarray(adj))
    assert np.array_equal(got["labels"].numpy(), np.asarray(labels))
    assert np.array_equal(got["ids"].numpy(), np.asarray(ids))
    assert np.array_equal(got["mask"].numpy(), np.asarray(mask))
    sage, jsage = got["config"].sage, config.sage
    assert (sage.fanouts, sage.dims[1:], sage.aggregator, sage.concat,
            sage.fused_gather, sage.num_nodes, sage.sampler_mode) == (
        jsage.fanouts, jsage.dims[1:], jsage.aggregator, jsage.concat,
        jsage.fused_gather, jsage.num_nodes, jsage.sampler_mode)


@pytest.mark.parametrize("dist", ["zipf", "zipf_scattered", "uniform",
                                  "zipf:bf16"])
def test_agg_sweep_build_graph_matches(dist, monkeypatch):
    """agg_sweep's tables, bit for bit (bf16 compared as f32), at a cut
    N (both modules alike; the draws do not depend on it)."""
    for mod in (agg_sweep, jagg):
        monkeypatch.setattr(mod, "NUM_NODES", 20_000)
    features, adj = agg_sweep.build_graph(dist)
    jfeatures, jadj = jagg.build_graph(dist)
    want = np.asarray(jfeatures.astype(np.float32))[:, :agg_sweep.FEAT_DIM]
    assert features.dtype == (torch.bfloat16 if dist.endswith("bf16")
                              else torch.float32)
    assert np.array_equal(features.float().numpy(), want)
    assert np.array_equal(adj.numpy(), np.asarray(jadj))


def test_agg_sweep_configs_and_edges():
    assert agg_sweep.CONFIGS == jagg.CONFIGS
    assert len(agg_sweep.CONFIGS) == 27
    assert agg_sweep.edges_per_step(False) == 133_120
    assert agg_sweep.edges_per_step(True) == 271_440


def test_halo_min_capacity_matches_jax(monkeypatch):
    """The least zero-drop capacity factor of both schedules under both
    row layouts: the port's 2 gloo ranks against the JAX probe on 2
    virtual CPU devices, at HALO_TOY."""
    import benchmarks.halo_probe as jhalo

    for mod in (halo_probe, jhalo):
        for k, v in HALO_TOY.items():
            monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(halo_probe, "ITERS", 1)
    monkeypatch.setattr(jhalo, "D", 2)
    got = halo_probe.probe(2, torch.device("cpu"))["min_capacity"]
    want = {f"{h}/{lay}": jhalo.min_capacity_zero_drops(h, lay)
            for h in ("blocking", "overlap") for lay in ("strided", "block")}
    assert got == want
    assert len(set(want.values())) > 1   # the layouts differ here


# -------------------------------------------------------- entry points

def test_bench_main_keys(toy):
    (line,) = _printed(bench.main, ["--device", "cpu"])
    row = json.loads(line)
    assert set(row) == BENCH_KEYS | {"card"}
    assert set(row["secondary"]) == SECONDARY_KEYS
    assert row["card"] == "cpu" and row["graph_dist"] == "zipf"
    _rates_positive([row["value"], row["sec_per_step"],
                     row["sec_per_step_dispatch"],
                     *row["secondary"].values()])
    assert row["roofline_frac"] >= 0.0   # rounds to 0 at the toy size


def test_agg_sweep_main_keys(toy, tmp_path):
    out = tmp_path / "rows.jsonl"
    names = ["mean", "mean_drop", "meanpool_fused_drop", "unsup_mean",
             "seq", "maxpool_bf16"]
    lines = _printed(agg_sweep.main,
                     names + ["--device", "cpu", "--out", str(out)])
    rows = [json.loads(x) for x in lines]
    assert [json.loads(x) for x in out.read_text().splitlines()] == rows
    assert [r["config"] for r in rows] == names
    for r in rows:
        assert set(r) == AGG_KEYS | {"card"}
        _rates_positive([r["ms_per_step"], r["edges_per_sec"]])
    assert rows[3]["edges_per_step"] == agg_sweep.edges_per_step(True)


def test_agg_sweep_refuses_unknown_and_empty():
    assert agg_sweep.main(["--device", "cpu"]) == 2
    with pytest.raises(SystemExit):
        agg_sweep.main(["no_such_config", "--device", "cpu"])


@pytest.mark.parametrize("predict", [False, True])
def test_serving_bench_main_keys(toy, predict):
    argv = ["--device", "cpu"] + (["--predict"] if predict else [])
    (line,) = _printed(serving_bench.main, argv)
    row = json.loads(line)
    assert set(row) == SERVING_KEYS | {"card"}
    assert row["metric"] == ("serving_predict_nodes_per_sec" if predict
                             else "serving_embed_nodes_per_sec")
    _rates_positive([row["value"], row["edges_per_sec"], row["sweep_s"]])


def _case_ms(lines, cases) -> dict:
    got = {}
    for line in lines[1:]:
        m = re.fullmatch(r"(.+?)\s+([0-9.]+) ms", line)
        got[m.group(1)] = float(m.group(2))
    assert list(got) == list(cases)
    _rates_positive(got.values())
    return got


def test_step_profile_main_cases(toy):
    lines = _printed(step_profile.main, ["--device", "cpu"])
    assert lines[0].startswith("# cpu")
    _case_ms(lines, STEP_CASES)


def test_step_profile_failure_raises(toy, monkeypatch):
    """A failing case is not printed as FAILED and passed over: it raises
    out of main, so ``python -m`` exits non-zero."""
    def broken(*args, **kwargs):
        raise RuntimeError("gather failed")

    monkeypatch.setattr(step_profile, "fused_gather_mean", broken)
    with pytest.raises(RuntimeError, match="gather failed"):
        step_profile.main(["--device", "cpu"])


def test_sampler_probe_main_cases(toy):
    lines = _printed(sampler_probe.main, ["--device", "cpu"])
    _case_ms(lines, SAMPLER_CASES)


def test_scaling_probe_main_keys(toy):
    lines = _printed(scaling_probe.main,
                     ["--device", "cpu", "--devices", "1,2"])
    rows = [json.loads(x) for x in lines]
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert SCALING_KEYS <= set(r) and r["platform"] == "cpu"
        assert r["dropped"] == 0 and len(r["launches"]) == r["devices"]
        _rates_positive([r["value"], r["scaling_efficiency_vs_smallest"]])
    assert rows[0]["scaling_efficiency_vs_smallest"] == 1.0


def test_scaling_probe_refuses_too_many():
    with pytest.raises(RuntimeError, match="than the 8 CPU ranks"):
        scaling_probe.measure([16], 1, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="than the 8 CPU ranks"):
        scaling_probe.measure([1, 8], 2, torch.device("cpu"))


def test_halo_probe_main_lines(toy):
    lines = _printed(halo_probe.main, ["--device", "cpu", "--shards", "2"])
    assert lines[0].startswith("# cpu; 2 ranks")
    assert [x.split(":")[0].strip() for x in lines[1:3]] == [
        "blocking", "overlap"]
    for line in lines[1:3]:
        assert re.search(r"[0-9.]+ ms/fwd   all-to-all ops: +\d+   operand "
                         r"MB: +[0-9.]+   min zero-drop capacity_factor: "
                         r"[0-9.]+$", line), line
    assert lines[3].startswith("overlap vs blocking: ")
    assert [x.split(":")[0] for x in lines[4:]] == ["layout=strided",
                                                    "layout=block  "]


@pytest.mark.parametrize("main", [
    bench.main, lambda argv: agg_sweep.main(["mean"] + argv),
    serving_bench.main, step_profile.main, sampler_probe.main,
    scaling_probe.main, halo_probe.main])
def test_drivers_need_a_card_by_default(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
