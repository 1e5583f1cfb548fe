"""Data parallelism across GPUs: one process per device."""
