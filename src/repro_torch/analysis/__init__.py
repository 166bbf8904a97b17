"""Analytic models of the port (no device code)."""
