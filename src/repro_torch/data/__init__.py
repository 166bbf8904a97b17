"""The port's data pipeline (the JAX package's `repro.data`)."""
