"""PyTorch + CUDA port of the MeMemo reproduction (``src/repro``).

The package mirrors ``repro``'s layout module for module. Plain tensor
code is PyTorch; every kernel the reference wrote in Pallas is a CUDA C++
kernel for Hopper under ``kernels/csrc``, built at first use. Entry
points run on the card (``device="cuda"``) unless the caller asks for the
CPU, where every kernel wrapper takes its plain PyTorch version.
"""
