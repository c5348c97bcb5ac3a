"""The plain PyTorch reference the benchmark holds the port to."""
