"""portbench: the benchmark of gpmpc_tpu_torch on one NVIDIA H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once (README.md). Each configuration, cell,
per-layer metric and work count is a file of its own, found by name.
"""
