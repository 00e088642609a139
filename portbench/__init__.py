"""The port's benchmark: long-prompt prefill through ``repro_torch``'s
``Model.forward`` on one card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line last.  Everything that belongs to one configuration, traffic
mix, per-layer metric or cell is a file of its own, found by its name:

* ``configs/<config>.json``: the model as it is run (published keys);
* ``traffic/<traffic>.json``: the parameters of one traffic mix;
* ``metrics/<metric>.py``: a reader with ``read(ctx)`` for one per-layer
  metric;
* ``limits/<cell>.json``: the limits of the cell's output comparison.
"""
