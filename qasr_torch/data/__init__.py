"""Datasets and batching for the port (numpy only)."""
