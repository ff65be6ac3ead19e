"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

A second package beside the JAX reference, following its layout module by
module (``core``, ``kernels``, ``solvers``, ``configs``, ``models``,
``launch``).  It imports ``torch`` and numpy only.  Entry points take an
explicit ``device`` and run on ``cuda`` unless the caller asks for
``"cpu"``.  The FFT engines of a plan are
hand-written CUDA kernels (backend names as in the reference's plan
configs): the radix-2 engine, ``"pallas"``, is ``csrc/fft_radix2.cu``; the
four-step FFT on the FP64 tensor cores, ``"mxu"``, is ``csrc/fft_mxu.cu``.

The solver step runs on a ``Pu × Pv`` pencil grid, one process per rank
(:mod:`repro_torch.dist`).  On the card the ring engines' exchanges, with
the paper's NIC offload, are ``csrc/ring_rdma.cu``.

LM serving (``launch.serve``: batched prefill, then greedy decode over a
KV cache) runs the dense uniform decoders of ``configs`` (``models``);
the prefill's attention is the flash-attention kernel,
``csrc/flash_attention.cu``, the seventh TPU kernel of the JAX package.
"""
