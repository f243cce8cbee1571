"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the ops around them. Sources in ``csrc/``; built at first use
(``_build``)."""
