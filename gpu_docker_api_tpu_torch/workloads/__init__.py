"""Workloads the control plane schedules, PyTorch/CUDA port."""
