"""Decoding and scoring for the port."""
