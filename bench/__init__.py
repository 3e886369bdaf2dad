"""The benchmark of the PyTorch/CUDA port (`repro_torch`).

`python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` on one card and prints one JSON line.
Everything a cell needs is found by name: `workloads/<cell>.json` (the
comparison's sample and limits), the configuration file that
`BENCHMARK.json` names, `traffic/<mix>.json` (the loop, its load and the
requests' sizes), and one reader `metrics/<metric>.py` per metric.
`reference/` is the plain PyTorch / NumPy model of what the port
computes; it imports nothing of the port.
"""
