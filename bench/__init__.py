"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints one
JSON line.  Everything a cell needs is found by name: its configuration
(``configs/<config>.json``), its traffic and limits
(``workloads/<cell>.json``), its traffic loop (``drivers/<driver>.py``)
and each metric's reader (``metrics/<metric>.py``).
"""
