"""Evaluation: video metrics, FVD extractors, the trainer's quality panel,
the parity digest and run comparison."""
