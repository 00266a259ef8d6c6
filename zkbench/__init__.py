"""The benchmark of halo2_zkcert_tpu_torch, the PyTorch/CUDA prover.

`python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once and prints one JSON line.  Everything
that belongs to one cell, configuration or metric is a file of its own,
found by the name BENCHMARK.json gives it: workloads/<cell>.json,
configs/<config>.json, drivers/<circuit>.py, traffic/<circuit>.py,
reference/<circuit>.py, metrics/<metric>.py, counts/<config>.json.
reference/ decides whether the proofs are correct and imports nothing of
the program.
"""
