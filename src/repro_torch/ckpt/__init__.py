"""The port's checkpoints (the JAX package's `repro.ckpt`)."""
