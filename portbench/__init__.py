"""The benchmark of ble_tpu_torch, the PyTorch and CUDA port, on NVIDIA
GPUs.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json (at the repository's root)
and prints one JSON line. Cells, configurations, traffic mixes, check
limits and per-layer metrics are data files found by name:
configs/<config>.json, traffic/<traffic>.json, limits/<cell>.json and
metrics/<metric>.py. The plain reference that decides `correct` lives in
reference/ and imports nothing of the port.
"""
