"""The benchmark of the PyTorch and CUDA port (``epsilon_tpu_torch``).

Run one cell once with ``python3 -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; ``BENCHMARK.json`` at the root of the repo
names the cells.  Importing this package loads neither torch nor the
program.
"""
