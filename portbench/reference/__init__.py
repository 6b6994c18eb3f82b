"""Plain fp32 PyTorch references. They import nothing of the benchmarked
program and nothing of JAX."""
