"""Neural-network kernels of the port (nn-base)."""
