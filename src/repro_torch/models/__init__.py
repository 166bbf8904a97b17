"""The model zoo's dense serving path: layers, the layer stack and the
model API (prefill and decode with a KV cache)."""
