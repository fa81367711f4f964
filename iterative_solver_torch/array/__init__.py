"""Block-vector operations of the port (the ArrayHandler layer)."""
