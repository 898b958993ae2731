"""Training runtime of the port (replicated data parallelism)."""
