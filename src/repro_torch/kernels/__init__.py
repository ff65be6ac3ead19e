"""Kernels of the port: the radix-2 and four-step FFT CUDA kernels, the
ring kernels of the NIC engine (:mod:`.ring_rdma`), the flash-attention
kernel of the LM prefill (:mod:`.attention`), their plain PyTorch
versions, and the backend-dispatching wrappers of :mod:`.ops`."""
