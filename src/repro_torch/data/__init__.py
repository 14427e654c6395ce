"""Deterministic synthetic data for the port (numpy only)."""
