"""Kernel layer: hand CUDA kernels (csrc/), their plain versions (ref), and
the device-dispatching wrappers (ops)."""
