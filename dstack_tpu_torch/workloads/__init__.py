"""Workloads ported to PyTorch: config, model, attention, the serving engine."""
