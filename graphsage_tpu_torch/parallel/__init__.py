"""Training steps and chunk runners, on one device and on several:
process groups and start-up (``distributed.py``, ``launch.py``), data
parallelism (``dp.py``) and graph sharding (``graph_sharded.py``)."""
