"""Hand-written Hopper kernels of the port, one folder each.

Each ``ops.py`` holds the kernel's wrapper, its plain PyTorch version (the
wrapper's path for CPU tensors only), and a launch counter.
"""
