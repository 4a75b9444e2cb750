"""Utilities: checkpoint bundles."""
