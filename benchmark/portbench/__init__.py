"""The harness of the port's benchmark (see ../README.md)."""
