"""Solver machinery of the port."""
