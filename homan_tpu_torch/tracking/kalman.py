"""Kalman filtering and Rauch-Tung-Striebel smoothing of box tracks
(homan_tpu/tracking/kalman.py), in place of the reference's motpy and
filterpy: a constant-position (order 0) or constant-velocity (order 1)
filter over each box coordinate, run forward, smoothed backward, a missing
observation handled by prediction alone. Host numpy, the JAX package's
arithmetic in the same order.
"""
from __future__ import annotations

import numpy as np


def _kf_matrices(order: int, dt: float = 1.0, q: float = 1.0, r: float = 1.0):
    if order == 0:
        F = np.array([[1.0]])
        H = np.array([[1.0]])
        Q = np.array([[q]])
    elif order == 1:
        F = np.array([[1.0, dt], [0.0, 1.0]])
        H = np.array([[1.0, 0.0]])
        Q = q * np.array([[dt**4 / 4, dt**3 / 2], [dt**3 / 2, dt**2]])
    else:
        raise ValueError(f"order {order} not supported")
    R = np.array([[r]])
    return F, H, Q, R


def kalman_rts_1d(obs: np.ndarray, order: int = 0, q: float = 1.0,
                  r: float = 1.0) -> np.ndarray:
    """Filter+smooth one scalar series; NaN = missing observation.

    Returns the RTS-smoothed positions (T,).
    """
    obs = np.asarray(obs, np.float64)
    T = obs.shape[0]
    F, H, Q, R = _kf_matrices(order, q=q, r=r)
    dim = F.shape[0]

    first = np.flatnonzero(~np.isnan(obs))
    if first.size == 0:
        return obs.copy()
    x = np.zeros(dim)
    x[0] = obs[first[0]]
    P = np.eye(dim) * 10.0

    xs_f = np.zeros((T, dim))
    Ps_f = np.zeros((T, dim, dim))
    xs_p = np.zeros((T, dim))
    Ps_p = np.zeros((T, dim, dim))
    for t in range(T):
        # Predict
        x_p = F @ x
        P_p = F @ P @ F.T + Q
        xs_p[t] = x_p
        Ps_p[t] = P_p
        # Update (skip when missing)
        if not np.isnan(obs[t]):
            y = obs[t] - H @ x_p
            S = H @ P_p @ H.T + R
            K = P_p @ H.T @ np.linalg.inv(S)
            x = x_p + (K * y).ravel()
            P = (np.eye(dim) - K @ H) @ P_p
        else:
            x, P = x_p, P_p
        xs_f[t] = x
        Ps_f[t] = P

    # RTS backward pass
    xs_s = xs_f.copy()
    Ps_s = Ps_f.copy()
    for t in range(T - 2, -1, -1):
        C = Ps_f[t] @ F.T @ np.linalg.inv(Ps_p[t + 1])
        xs_s[t] = xs_f[t] + C @ (xs_s[t + 1] - xs_p[t + 1])
        Ps_s[t] = Ps_f[t] + C @ (Ps_s[t + 1] - Ps_p[t + 1]) @ C.T
    return xs_s[:, 0]


def rtsmooth(series: np.ndarray, order: int = 0, q: float = 1.0,
             r: float = 1.0) -> np.ndarray:
    """Column-wise KF+RTS smoothing of (T, D) series with NaN gaps
    (homan/tracking/rtsmooth.py:13-31)."""
    series = np.asarray(series, np.float64)
    out = np.stack([kalman_rts_1d(series[:, d], order, q, r)
                    for d in range(series.shape[1])], axis=1)
    return out


def track_boxes(boxes: np.ndarray, order: int = 0) -> np.ndarray:
    """Smooth a (T, 4) xyxy box track containing NaN rows for missed frames
    (homan/tracking/trackboxes.py:9-38)."""
    return rtsmooth(np.asarray(boxes, np.float64), order=order)


def track_sequence_boxes(boxes: np.ndarray) -> np.ndarray:
    """Forward + backward smoothing averaged
    (homan/tracking/trackseq.py:82-91)."""
    fwd = track_boxes(boxes)
    bwd = track_boxes(np.asarray(boxes)[::-1])[::-1]
    return (fwd + bwd) / 2


def interpolate_missing(boxes: np.ndarray) -> np.ndarray:
    """Linear interpolation of NaN rows (EPIC track gap filling,
    homan/tracking/trackhoa.py:87-182)."""
    boxes = np.asarray(boxes, np.float64).copy()
    T, D = boxes.shape
    t = np.arange(T)
    for d in range(D):
        col = boxes[:, d]
        ok = ~np.isnan(col)
        if ok.sum() == 0:
            continue
        boxes[:, d] = np.interp(t, t[ok], col[ok])
    return boxes


def check_setup(detections: dict, setup: dict) -> bool:
    """Detection-count validation (homan/datasets/verify.py:5-21):
    each entity required by the dataset `setup` must be detected."""
    for key, count in setup.items():
        if key == "objects":
            continue
        got = detections.get(key)
        if got is None:
            return False
        if isinstance(got, (list, tuple)) and len(got) < count:
            return False
    return True
