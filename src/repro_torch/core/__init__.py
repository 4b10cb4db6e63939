"""Core of the port: the paper's index and query path (see the package
docstring for which stages are NumPy and which are torch)."""
