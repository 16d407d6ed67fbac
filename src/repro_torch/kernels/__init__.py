# Hand-written CUDA kernels for Hopper (csrc/), each with a plain PyTorch
# version beside it (ref.py), its ctypes wrapper (kernel.py) and the
# public op that picks between them (ops.py).
