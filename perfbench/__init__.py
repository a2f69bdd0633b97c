"""The benchmark of the PyTorch and CUDA port (``odise_torch``) on one
NVIDIA H100: ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root. Its manifest is
``BENCHMARK.json`` at the root."""
