"""The dynamic-SCC engine and its streaming service, in PyTorch."""
