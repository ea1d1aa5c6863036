"""Circuit engine of the port: static tables, the plain PyTorch engines and
the CUDA block-chain kernel's wrapper."""
