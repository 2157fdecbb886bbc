"""The benchmark of ``repro_torch``'s online index on NVIDIA H100s.

``python3 ann_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
metric is a file found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``, and the code that
runs a configuration's kind of deployment, ``deployments/<name>.py``.
``data/`` makes the inputs from the seed and ``reference/`` judges the
answers; neither imports the program.
"""
