"""Parity tooling: weight transfer between the JAX reference and the port."""
