"""Optimizers of the port: AdamW, Adafactor, the schedule and the gradient
compression hooks (the JAX package's `repro.optim`)."""
