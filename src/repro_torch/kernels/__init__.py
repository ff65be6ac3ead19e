"""1D FFT engines of the port: the radix-2 CUDA kernel, its plain PyTorch
version, and the backend-dispatching wrappers of :mod:`.ops`."""
