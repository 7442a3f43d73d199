"""Evaluation metrics (homan_tpu/eval/)."""
