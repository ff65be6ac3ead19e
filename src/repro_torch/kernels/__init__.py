"""1D FFT engines of the port: the radix-2 and four-step CUDA kernels, their
plain PyTorch versions, and the backend-dispatching wrappers of :mod:`.ops`."""
