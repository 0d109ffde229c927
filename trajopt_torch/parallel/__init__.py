"""Batched solvers of the port."""
