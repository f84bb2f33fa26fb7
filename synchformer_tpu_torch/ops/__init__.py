"""Numerics helpers, front ends and kernels of the port."""
