"""Command-line drivers of the port (counterpart of the JAX ``cli/``)."""
