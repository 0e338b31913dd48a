"""The command-line entry points: train, render, metrics."""
