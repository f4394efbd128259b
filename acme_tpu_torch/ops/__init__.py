"""Kernels of the port: the fused sweep kernel and the float64 scan engine
(CUDA C++ in ``csrc``), each with its plain torch version, double-float
arithmetic and the small dense solves."""
