"""Plain PyTorch ops and the hand-written CUDA kernels (csrc/) that replace
the Pallas TPU kernels, each wrapper beside its plain version."""
