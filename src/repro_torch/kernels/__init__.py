"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions (``ref``), the build (``build``) and the dispatching wrappers
(``ops``)."""
