"""Video chunk sampling and collation (homan_tpu/data/chunking.py), numpy
only, the JAX package's code verbatim."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def chunk_vid_index(vid_index, chunk_size: int = 10, chunk_step: int = 2,
                    chunk_spacing: int = 200, frame_nb_key: str = "frame_nb"):
    """Sample chunks of `chunk_size` frames spaced `chunk_step` apart, one
    chunk every `chunk_spacing` frames, always adding an end-of-video chunk.

    Args:
      vid_index: sequence of dict-like rows each with `frame_nb` (total frame
        count) — or a pandas DataFrame.
    Returns:
      list of dicts: the original row fields + "frame_idxs" (chunk frame ids).
    """
    try:
        import pandas as pd
        if isinstance(vid_index, pd.DataFrame):
            vid_index = vid_index.to_dict("records")
    except ImportError:
        pass

    chunks = []
    span = chunk_size * chunk_step
    for row in vid_index:
        frame_nb = int(row[frame_nb_key])
        # Exact reference schedule (chunkvids.py:29-37): regular starts every
        # chunk_spacing, plus an end-of-video chunk whose LAST frame is
        # frame_nb-1 (start = frame_nb - span + step - 1).
        starts = list(range(0, max(frame_nb - span, 0), chunk_spacing))
        end_start = frame_nb - span + chunk_step - 1
        if end_start >= 0 and end_start not in starts:
            starts.append(end_start)
        emitted = False
        for start in starts:
            idxs = [start + i * chunk_step for i in range(chunk_size)]
            if idxs[-1] >= frame_nb:
                continue
            chunk = dict(row)
            chunk["frame_idxs"] = idxs
            chunks.append(chunk)
            emitted = True
        if not emitted:
            # Video shorter than the chunk span — the reference would emit
            # NEGATIVE frame ids here (chunkvids.py:33). Cover it with the
            # largest step that fits; skip (loudly) only when there are
            # fewer than chunk_size frames.
            if frame_nb >= chunk_size:
                fit_step = max((frame_nb - 1) // max(chunk_size - 1, 1), 1)
                chunk = dict(row)
                chunk["frame_idxs"] = [i * fit_step
                                       for i in range(chunk_size)]
                chunks.append(chunk)
            else:
                import logging
                logging.getLogger(__name__).warning(
                    "video with %d frames < chunk_size %d: no chunk emitted",
                    frame_nb, chunk_size)
    return chunks


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack list-of-dicts along time for array values, keep lists otherwise
    (homan/datasets/collate.py:7-16)."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(first, (int, float)):
            out[key] = np.asarray(vals)
        elif isinstance(first, dict):
            out[key] = collate(vals)
        else:
            out[key] = vals
    return out
