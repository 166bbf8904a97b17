"""The fabrics and the sender engine of the port."""
