"""Traffic drivers, one module a ``mode`` of ``traffic/<name>.json``.

Each has ``setup(ctx)``, ``window(ctx, state, seconds)``,
``end_to_end(ctx, rec)``, ``check(ctx, rec)``, ``hop_ids(ctx, rec)``
and ``unit_flops(ctx)``; ``rec`` carries ``attempted`` and ``failed``.
``spec.py`` says which of them run on every rank of a cell over several
cards.
"""
