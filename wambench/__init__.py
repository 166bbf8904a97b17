"""The benchmark of the PyTorch/CUDA port (`repro_torch`): cells of the
sender on datacenter fabrics, run on one card by `wambench.run`.  It
imports neither JAX nor the JAX package."""
