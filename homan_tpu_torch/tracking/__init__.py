"""Host-side box tracking: Kalman filtering, RTS smoothing, sequence tracks
(homan_tpu/tracking/)."""
