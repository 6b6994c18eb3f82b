"""PyTorch/CUDA port of the dstack_tpu workloads (see README, "PyTorch/CUDA port")."""
