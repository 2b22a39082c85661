"""The benchmark of ``scintools_tpu_torch``, the PyTorch/CUDA port.

One command runs one cell once (``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``); ``BENCHMARK.json`` at
the repository root names the cells, their configurations and traffic
mixes, and the metrics. See ``portbench/README.md``.
"""
