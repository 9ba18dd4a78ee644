"""Plain PyTorch and NumPy reference of the ISEE-3 receive chain, for
the benchmark's correctness comparison.  It imports neither JAX nor the
JAX package nor the PyTorch port."""
