"""Step builders of the port (serving steps only, for now)."""
