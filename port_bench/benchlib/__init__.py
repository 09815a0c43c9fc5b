"""The port's benchmark harness: one run of one cell of
``BENCHMARK.json`` (``run.py``), with everything that belongs to one
configuration, traffic mix or metric in files of its own."""
