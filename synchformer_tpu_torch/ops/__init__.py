"""Numerics helpers, front ends, audio DSP and kernels of the port."""
