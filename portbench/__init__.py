"""The benchmark of the PyTorch and CUDA port (``videollamb_torch``): one run of
one cell is ``python3 portbench/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>``; the cells, metrics and bounds are in ``BENCHMARK.json``."""
