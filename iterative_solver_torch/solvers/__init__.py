"""Solvers of the port."""
