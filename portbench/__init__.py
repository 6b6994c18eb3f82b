"""The benchmark of the PyTorch and CUDA port (``dstack_tpu_torch``).

Run one cell once: ``python3 -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See README.md.
"""
