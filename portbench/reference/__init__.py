"""Plain PyTorch references the benchmark judges the port's outputs by."""
