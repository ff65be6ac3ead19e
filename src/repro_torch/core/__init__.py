"""Geometry, transposes, engines, the single-rank 3D FFT and the spectral
operators of the port."""
