"""Host data generation, encoding and the dataset cache (NumPy and SciPy)."""
