"""PyTorch/CUDA port of the gpu_docker_api_tpu workload runtime.

A package of its own beside the JAX one: it imports torch and numpy, never
jax and nothing of gpu_docker_api_tpu. Its kernels are hand-written CUDA
for Hopper (csrc/), built with nvcc at first use (_build.py). Entry points
run on the card unless the caller asks for the CPU.
"""
