"""Probes of the port on the card (``gather_probe``: the gather-mean
designs of the JAX package's ``benchmarks/gather_probe.py``)."""
