"""Device kernels of the port: hand-written CUDA (``csrc/``) and their plain PyTorch versions."""
