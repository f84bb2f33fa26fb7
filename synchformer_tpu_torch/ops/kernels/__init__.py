"""Wrappers of the hand-written CUDA kernels (K1-K4), each beside its plain
PyTorch version. A CUDA tensor goes to the kernel or raises; a CPU tensor
takes the plain version."""
