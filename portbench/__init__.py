"""portbench: the benchmark of ``yolo_v3_tpu_torch`` on NVIDIA H100 cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name:

* ``configs/<config>.json``: the model's sizes and precision;
* ``traffic/<mix>.json``: the parameters of a mix, read by the generator it
  names (``generators/<generator>.py``);
* ``workloads/<cell>.json``: the limits of the cell's output checks;
* ``metrics/<metric>.py``: a reader of one per-layer metric.

The yardstick lives here too: the seeded weights and scenes, the operation
and byte counts with the card's peaks (``counts.py``), the reading of the
profiler's trace (``trace.py``) and the plain references
(``reference/``), which import nothing of the package they judge.
"""
