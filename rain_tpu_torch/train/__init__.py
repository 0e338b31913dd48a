"""Evaluation render and PLY snapshots."""
