"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it; ``runtime`` builds, loads and counts them."""
