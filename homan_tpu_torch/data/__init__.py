"""Datasets: clip sampling and HO-3D (homan_tpu/data/)."""
