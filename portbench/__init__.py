"""The port's benchmark harness (see portbench/README.md)."""
