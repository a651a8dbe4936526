"""annbench: the benchmark of ``hannoy_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``harness.py`` loads the
cell's files, traces and judges; ``configs/``, ``generators/``,
``distances/``, ``mixes/``, ``drivers/``, ``limits/``, ``end_to_end/`` and
``metrics/`` hold what belongs to one configuration, data generator, metric
of distance, traffic mix, kind of traffic, cell, end-to-end or per-layer
metric, each found by its name; ``reference.py`` is the plain reference
that decides ``correct``; ``yardstick/`` holds the frozen arithmetic;
``controls.py`` reads the control and the planted faults that the limits are
set from; ``spreads.py`` works out the spreads that the bounds are set from.
"""
