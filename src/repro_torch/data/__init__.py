"""Synthetic data of the port (numpy, shared logic with the reference)."""
