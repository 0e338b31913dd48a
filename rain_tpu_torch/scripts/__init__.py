"""The command-line entry points: train, render, metrics; the 30k
production run; the long end-to-end run from a sparse init (e2e_long);
the scale and profiling tools (probe_scale, sustained_growth,
knn_deviation, trainer_sustained, composite_micro, summarize_run)."""
