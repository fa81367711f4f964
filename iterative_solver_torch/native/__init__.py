"""Native host code of the port (the file-backed vector store). Importing
it builds nothing: the library is compiled at the first ``VecStore``."""

from .vecstore import VecStore, build_native

__all__ = ["VecStore", "build_native"]
