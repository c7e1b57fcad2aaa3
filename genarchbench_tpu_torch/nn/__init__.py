"""Neural-network kernels of the port: nn-base (basecall.py) and
nn-variant (variant.py, with its SSW realigner ssw.py)."""
