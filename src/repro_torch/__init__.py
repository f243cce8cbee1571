"""AQUA on PyTorch and CUDA: the GPU port of the JAX/Pallas package.

Same module layout as ``repro`` (configs, core, kernels, models, serving),
written in plain PyTorch; the Pallas TPU kernels on the serving path are
hand-written CUDA C++ kernels for Hopper under ``kernels/csrc``. The
package imports neither JAX nor anything of ``repro``.
"""
