"""Synthetic corpora."""
