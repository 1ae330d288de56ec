"""ProServe on PyTorch and CUDA: the port of the ``repro`` JAX package.

The JAX package is the reference; this package mirrors its module names
(``configs``, ``core``, ``models``, ``kernels``, ``serving``, ``launch``)
so every counterpart can be found by path.  It imports ``torch``, numpy
and the standard library only.  The attention kernels on the serving
path are hand-written CUDA C++ for Hopper (``csrc/``), built on first
use by ``kernels.build``; a CPU tensor takes each kernel's plain PyTorch
version instead, which is what the CPU tests exercise.

Importing this package loads nothing heavy: subpackages are imported by
the caller (``from repro_torch.serving import Engine``).
"""
