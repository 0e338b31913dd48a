"""The command-line entry points: train, render, metrics; the 30k
production run; the scale and profiling tools (probe_scale,
sustained_growth, knn_deviation, trainer_sustained, composite_micro,
summarize_run)."""
