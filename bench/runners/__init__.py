"""One module a configuration kind (``"kind"`` in the configuration's
file; absent means ``gnn``), found by name by ``bench/loader.py``: its
``run(args, cell, device)`` makes the inputs from the seed, sets up, runs the
measured window and the traced segment, judges the outputs against the plain
reference and returns ``(exit code, ctx)`` for ``bench/harness.py``."""
