"""Operators of the port."""
