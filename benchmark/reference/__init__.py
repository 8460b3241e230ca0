"""Plain references of the benchmark: plain PyTorch and NumPy, nothing of
the program."""
