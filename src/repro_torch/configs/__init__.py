"""Architecture configs of the port: the dense models whose serving path
is ported, copied from the JAX package's `configs/`."""
