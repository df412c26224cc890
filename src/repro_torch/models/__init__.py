"""Models of the port: the paper's two-layer swish network."""
