"""figbench: the benchmark of the PyTorch/CUDA port of FiGaRo (`repro_torch`).

One run is one cell of ``BENCHMARK.json`` (a configuration under a traffic
mix) run once::

    python3 figbench/run.py --workload favorita.serve_qr --seed 7 --seconds 30 --trace 0

Everything a cell is made of is a file found by its name:

- ``configs/<config>.json``: the deployment (schema, sizes, session options);
- ``workloads/<traffic>.json``: the traffic mix, read by ``drivers/<driver>.py``;
- ``limits/<cell>.json``: the limit of each number the correctness check compares;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

The yardstick lives here and nowhere in the program: the data generator
(``data/``), the plain reference (``reference/``), the trace arithmetic
(``trace.py``) and the operation counts and peaks (``roofline.py``). From the
port the benchmark takes only its public surface (`repro_torch.figaro`) and
its counters. Nothing here imports JAX or the JAX package.
"""
