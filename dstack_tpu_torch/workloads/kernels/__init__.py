"""Hand-written CUDA kernels (csrc/), their build, and their plain versions."""
