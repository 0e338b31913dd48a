"""The SIBR live-viewer bridge."""
