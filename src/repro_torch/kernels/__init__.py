"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (used for CPU tensors and as the reference the card is held to)."""
