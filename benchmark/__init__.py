"""The benchmark of gaussianeditor_tpu_torch (the PyTorch and CUDA port).

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once and prints one JSON line. Cells,
configurations, traffic mixes and metrics are JSON files under
`benchmark/`, found by name, and a configuration's own drivers, metric
kinds and kernel counts are modules of `benchmark/ext/` (see `run.py`).
"""
