"""Host-side utilities of the port: the key-tree and device resolution."""
