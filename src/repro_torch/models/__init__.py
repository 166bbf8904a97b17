"""The model zoo's serving path for all ten archs: layers, MoE, the
recurrent blocks, the layer stack and the model API (prefill and decode
with KV caches and recurrent states)."""
