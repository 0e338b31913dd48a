"""Camera math and PLY interchange."""
