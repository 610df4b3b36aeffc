"""Traffic drivers, one module a ``mode`` of ``traffic/<name>.json``.

Each has ``setup(ctx)``, ``window(ctx, state, seconds)``,
``end_to_end(ctx, rec)``, ``check(ctx, rec)``, ``hop_ids(ctx, rec)``
and ``unit_flops(ctx)``; ``rec`` carries ``attempted`` and ``failed``,
and whatever the mode read of the port for the per-layer readers, which
see it as ``view.info["record"]``. Each also states ``TOY``, its toy
size's traffic keys, and ``FAULTS``, the faults its cells can have
(names in ``faults.py``, or ``module:name``). ``spec.py`` says which of
the functions run on every rank of a cell over several cards, and what
each constant is for.
"""
