"""Training over several devices: one process per device (SPMD)."""
