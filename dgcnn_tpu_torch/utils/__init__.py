"""Utilities: checkpoint bundles and measurement helpers (profiling)."""
