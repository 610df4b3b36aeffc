"""Traffic drivers, one module a ``mode`` of ``traffic/<name>.json``.

Each has ``setup(ctx)``, ``window(ctx, state, seconds)``,
``end_to_end(ctx, rec)``, ``check(ctx, rec)`` and ``hop_ids(ctx,
rec)``; ``rec`` carries ``attempted`` and ``failed``.
"""
