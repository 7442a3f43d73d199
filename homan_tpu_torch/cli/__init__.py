"""Command-line drivers (homan_tpu/cli/)."""
