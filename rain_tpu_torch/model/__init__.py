"""The fixed-capacity Gaussian state."""
