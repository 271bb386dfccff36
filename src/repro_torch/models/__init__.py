"""The model zoo's serving path (dense family) in PyTorch."""
