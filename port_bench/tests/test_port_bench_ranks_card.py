"""On four cards (marked ``cuda``; skipped below four), through the
command in a checkout that adds a four-card cell as files: ogbn-papers100M's
graph row-sharded over four ranks, each rank's 28.4 GB shard made on its
own card; rank 0 makes again 1M random rows that the other ranks hold
and compares them bit for bit with the rows they send it; a traced run
gathers every rank's span; a rank killed in its window ends the run with
no result, and no rank is left.

    python -m pytest port_bench/tests/test_port_bench_ranks_card.py -q -s

Each rank's join and set-up seconds (by step) and peak memory (in
set-up, and in the window) are printed.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import pytest
import torch

from port_bench.tests.test_port_bench_ranks import (
    CELL,
    checkout,
    rank_processes,
)

# ogbn-papers100M (Hu et al., OGB, arXiv:2005.00687) under GraphSAGE-mean
PAPERS100M = dict(num_nodes=111_059_956, feature_dim=128, num_classes=172,
                  max_degree=128, graph_shards=4, shard_layout="strided")
# ~1.0M of the probed rows are held by ranks 1-3
PROBE = dict(probe_rows=1_333_333, trace_after_s=0.0, trace_rounds=20)
SEEDS = (3_200_000_001, 3_200_000_002, 3_200_000_003)
KILLED_LIMIT_S = 300.0


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")


def _command(root, seed: int, trace: int, capsys):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", CELL,
         "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
        cwd=root, capture_output=True, text=True, timeout=1200)
    took = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("#")]
    lines += [ln for ln in proc.stderr.splitlines() if re.search(
        r"joined|set-up|memory peak|probed rows|ranks:", ln)]
    with capsys.disabled():
        print(f"\n== seed {seed}, trace {trace}: exit {proc.returncode} "
              f"in {took:.1f} s")
        print("\n".join(lines))
    return proc, took


@pytest.mark.cuda
def test_papers100m_shards_on_four_cards(four_cards, tmp_path, capsys):
    root = checkout(tmp_path, PROBE, PAPERS100M, chips=4)
    for seed, trace in zip(SEEDS, (0, 0, 1)):   # the first builds
        proc, _ = _command(root, seed, trace, capsys)
        assert proc.returncode == 0, proc.stderr[-4000:]
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        assert r["correct"] is True, r["checks"]
        assert r["checks"]["rows_differ"]["value"] == 0
        assert r["device"]["count"] == 4
        if trace:
            assert r["metrics"]["ranks_traced.toy"]["value"] == 4.0
            assert r["device"]["busy_s"] > 0
        with capsys.disabled():
            print(json.dumps({k: r[k] for k in ("metrics", "device")}))
    assert rank_processes(0) == []


@pytest.mark.cuda
def test_a_killed_rank_ends_the_run_on_four_cards(four_cards, tmp_path,
                                                  capsys):
    root = checkout(tmp_path, dict(PROBE, fail={"rank": 2, "how": "kill"}),
                    PAPERS100M, chips=4)
    proc, took = _command(root, SEEDS[0], 0, capsys)
    assert proc.returncode == 1 and took < KILLED_LIMIT_S
    assert '"correct"' not in proc.stdout
    assert "rank 2 exited with -9" in proc.stderr
    assert rank_processes(0) == []
