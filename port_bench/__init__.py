"""The benchmark of the PyTorch/H100 port (``graphsage_tpu_torch``).

One cell of ``BENCHMARK.json`` is a model configuration
(``configs/<name>.json``) under a traffic mix (``traffic/<name>.json``),
with the limits of its output check (``workloads/<cell>.json``); a
per-layer metric is a reader in ``metrics/<name>.py``. Each is found by
its name, so a new cell, configuration or metric is a new file and a new
entry in ``BENCHMARK.json``.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell on several cards runs one process a card (``ranks.py``), each
with its shard of the graph where the configuration shards it.

The yardstick lives here and nowhere in the port: the inputs drawn from
the seed (``inputs.py``), the counts of edges, bytes and operations and
the card's peaks (``counts.py``), the reduction of the profiler's trace
(``trace.py``) and the plain reference that decides ``correct``
(``reference/``). Nothing here imports JAX or the JAX package.
"""
