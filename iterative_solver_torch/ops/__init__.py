"""Operators of the port."""

from . import dense

__all__ = ["dense"]
