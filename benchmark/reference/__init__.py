"""Plain-PyTorch references of the benchmark's configurations: they import
neither JAX nor anything of the port."""
