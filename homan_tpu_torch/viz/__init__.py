"""Visualization: overlay renders, top-down views, video and report
writers (homan_tpu/viz/)."""
