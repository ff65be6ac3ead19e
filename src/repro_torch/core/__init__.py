"""Geometry, transposes, engines, the 3D FFT and the spectral operators of
the port."""
