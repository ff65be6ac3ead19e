"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

A second package beside the JAX reference, following its layout module by
module (``core``, ``kernels``, ``solvers``).  It imports ``torch`` and
numpy only.  Entry points take an explicit ``device`` and run on ``cuda``
unless the caller asks for ``"cpu"``; the radix-2 FFT engine (backend
``"pallas"`` in a plan config, for parity with the reference's names) is a
hand-written CUDA kernel, ``csrc/fft_radix2.cu``.

This slice covers the single-rank solver step: a 1×1 pencil grid, where
every fold is a local permute.
"""
