"""Sequence-level box tracking (homan_tpu/tracking/sequences.py).

The hand-object detector is a callable the caller injects, as the evidence
providers are (frontend/evidence.py): detector(image) -> {"left_hand": (4,)
xyxy or None, "right_hand": ..., "objects": ...}.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from homan_tpu_torch.tracking import kalman


def get_image(image, image_size: int):
    """Aspect-preserving resize onto a square canvas
    (homan/tracking/preprocess.py:8-25)."""
    from PIL import Image as PILImage
    if isinstance(image, np.ndarray):
        pil = PILImage.fromarray(image)
    else:
        pil = image
    scale = image_size / max(pil.size)
    new_size = (int(pil.size[0] * scale), int(pil.size[1] * scale))
    resized = pil.resize(new_size)
    canvas = PILImage.new("RGB", (image_size, image_size))
    canvas.paste(resized, (0, 0))
    return np.asarray(canvas)


def track_sequence(images: Sequence[np.ndarray],
                   detector: Callable[[np.ndarray], Dict],
                   setup: Dict[str, int],
                   image_size: int = 640) -> Dict[str, np.ndarray]:
    """Detect per frame, validate against `setup`, Kalman-track fwd+bwd and
    average (homan/tracking/trackseq.py:19-91).

    Returns entity -> (T, 4) smoothed boxes (NaN-free).
    """
    entities = [k for k in setup if k != "objects"] + (
        ["objects"] if "objects" in setup else [])
    raw = {k: np.full((len(images), 4), np.nan) for k in entities}
    for t, image in enumerate(images):
        dets = detector(get_image(image, image_size))
        if not kalman.check_setup(
                {k: ([v] if v is not None else []) for k, v in dets.items()},
                setup):
            continue
        for k in entities:
            box = dets.get(k)
            if box is not None:
                raw[k][t] = np.asarray(box, np.float64)
    # An entity with ZERO detections in the whole clip would smooth to
    # all-NaN boxes that poison every downstream crop silently — fail loudly
    # instead (the reference's verify.check_setup would have rejected these
    # frames one by one, homan/tracking/trackseq.py:38-59).
    for k, v in raw.items():
        if np.isnan(v).all():
            raise ValueError(
                f"track_sequence: entity '{k}' was never detected in the "
                f"clip ({len(images)} frames) — cannot produce boxes")
    return {k: kalman.track_sequence_boxes(kalman.interpolate_missing(v))
            for k, v in raw.items()}
