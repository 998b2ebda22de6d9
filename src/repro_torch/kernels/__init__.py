"""Phase-1 and phase-2 device kernels: hand-written CUDA for sm_90a
(``csrc/``), each beside its plain PyTorch version."""
