"""Offline serving launcher of the port."""
