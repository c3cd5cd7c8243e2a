"""The benchmark's plain reference: the port's plain PyTorch renderer,
frozen into the benchmark so that no change to the program moves the
yardstick.

Every module here but ``render.py`` is a verbatim copy, taken at commit
f2c28681, of the port's module of the same name (``camera``, ``color``,
``constants``, ``scene``, ``vec``; ``ops/brdf``, ``ops/intersect``,
``ops/nee``, ``ops/shade``; ``samplers/hash``, ``samplers/patterns``,
``samplers/warps``), with only its relative imports made flat.
``render.py`` is ``render.render_block`` taken per pixel instead of per
band of rows. Nothing here imports the program, ``jax`` or ``flux_tpu``.
"""
