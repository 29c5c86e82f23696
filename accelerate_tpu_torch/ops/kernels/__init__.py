"""Hand-written CUDA kernels for Hopper and their ctypes wrappers.

Sources live in ``accelerate_tpu_torch/csrc/``; ``_build.py`` compiles them
at first use. Importing this package builds and loads nothing.
"""
