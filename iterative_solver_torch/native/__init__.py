"""Native host code of the port (the file-backed vector store)."""
