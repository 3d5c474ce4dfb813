"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref``) and the device-dispatching ops in the model layouts (``ops``).
Kernels are built with ``nvcc`` at first CUDA use (``_build``)."""
