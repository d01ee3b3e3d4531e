"""Hand-written CUDA kernels (csrc/), their plain PyTorch versions (ref.py)
and the device dispatch (ops.py)."""
