"""Data pipelines of the port (counterpart of the JAX ``data/``)."""
