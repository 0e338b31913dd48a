"""Camera math, image files, COLMAP parsing, PLY interchange, the scene
loaders."""
