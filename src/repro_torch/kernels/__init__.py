"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
the wrappers that launch them (``ops``)."""
