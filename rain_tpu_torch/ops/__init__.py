"""Preprocess, tile binning, the compositor kernels and image assembly."""
