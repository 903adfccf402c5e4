"""The benchmark of the PyTorch port on one NVIDIA H100: see README.md
and run.py. Nothing here imports JAX or the JAX package, and the plain
reference under reference/ imports nothing of the port."""
