"""The benchmark's frozen yardstick: what later changes to the program may not alter.

* ``data``: the vectors and queries, made on the device from the run's seed;
* ``recall``: the tie-aware recall@k arithmetic;
* ``stats``: percentiles, window rates, and the quartile spread that the
  bounds are set from (``spreads.py``);
* ``trace``: the reduction of a ``torch.profiler`` trace to busy time, the
  time of the kernels inside a call, top device operations and idle gaps
  by what the host was doing;
* ``plain_search``: a plain HNSW search that counts the rows a search reads,
  the byte count behind ``kernel_roofline``;
* ``layers``: the per-layer readings that ``metrics/`` share;
* ``peaks``: the card's published peaks and its power limit.

Nothing here imports JAX, the JAX package or the program under test.
"""
