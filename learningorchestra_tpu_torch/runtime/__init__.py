"""Runtime pieces of the port (named locks)."""
