"""Kernels of the port: the fused sweep kernel (CUDA C++ in ``csrc``) and
its plain torch version, double-float arithmetic and tiny dense solves."""
