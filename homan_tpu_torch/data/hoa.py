"""EPIC-Kitchens hand-object-annotation (HOA) detections
(homan_tpu/data/hoa.py): the dataclasses of the HOA release's types.proto,
its reader (pickled protobufs, or pickled dataclasses) and the flattening of
detections into a DataFrame.

The dataclasses are the port's own: a pickle of them names this module, so
files written by the JAX package's classes are read there, and files
written here are read here. pandas is imported only by
detections_to_dataframe.
"""
from __future__ import annotations

import dataclasses
import pickle
from enum import IntEnum
from typing import List, Optional


class HandSide(IntEnum):
    LEFT = 0
    RIGHT = 1


class HandState(IntEnum):
    NO_CONTACT = 0
    SELF_CONTACT = 1
    ANOTHER_PERSON = 2
    PORTABLE_OBJECT = 3
    STATIONARY_OBJECT = 4


@dataclasses.dataclass
class FloatVector:
    x: float = 0.0
    y: float = 0.0

    def scale(self, width_factor: float = 1.0, height_factor: float = 1.0):
        return FloatVector(self.x * width_factor, self.y * height_factor)


@dataclasses.dataclass
class BBox:
    left: float
    top: float
    right: float
    bottom: float

    @property
    def center(self):
        return ((self.left + self.right) / 2, (self.top + self.bottom) / 2)

    @property
    def width(self):
        return self.right - self.left

    @property
    def height(self):
        return self.bottom - self.top

    def scale(self, width_factor: float = 1.0, height_factor: float = 1.0):
        return BBox(self.left * width_factor, self.top * height_factor,
                    self.right * width_factor, self.bottom * height_factor)


@dataclasses.dataclass
class HandDetection:
    bbox: BBox
    score: float
    state: HandState
    side: HandSide
    object_offset: FloatVector


@dataclasses.dataclass
class ObjectDetection:
    bbox: BBox
    score: float


@dataclasses.dataclass
class FrameDetections:
    video_id: str
    frame_number: int
    hands: List[HandDetection] = dataclasses.field(default_factory=list)
    objects: List[ObjectDetection] = dataclasses.field(default_factory=list)

    def scale(self, width_factor: float = 1.0, height_factor: float = 1.0):
        return FrameDetections(
            video_id=self.video_id,
            frame_number=self.frame_number,
            hands=[HandDetection(h.bbox.scale(width_factor, height_factor),
                                 h.score, h.state, h.side,
                                 h.object_offset.scale(width_factor,
                                                       height_factor))
                   for h in self.hands],
            objects=[ObjectDetection(o.bbox.scale(width_factor, height_factor),
                                     o.score) for o in self.objects],
        )


def _from_protobuf(pb) -> FrameDetections:
    return FrameDetections(
        video_id=pb.video_id,
        frame_number=pb.frame_number,
        hands=[HandDetection(
            bbox=BBox(h.bbox.left, h.bbox.top, h.bbox.right, h.bbox.bottom),
            score=h.score, state=HandState(h.state), side=HandSide(h.side),
            object_offset=FloatVector(h.object_offset.x, h.object_offset.y))
            for h in pb.hands],
        objects=[ObjectDetection(
            bbox=BBox(o.bbox.left, o.bbox.top, o.bbox.right, o.bbox.bottom),
            score=o.score) for o in pb.objects],
    )


def load_video_hoa(path: str, pb2_module=None) -> List[FrameDetections]:
    """Read a video's detections pickle (homan/datasets/hoaio.py:14-26).

    The public release pickles serialized protobuf bytes; plain pickled
    FrameDetections lists are accepted too.
    """
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload and isinstance(payload[0], FrameDetections):
        return payload
    if payload and isinstance(payload[0], (bytes, bytearray)):
        if pb2_module is None:
            raise ValueError(
                "serialized protobufs need the generated pb2 module "
                "(protoc over the HOA types.proto)")
        out = []
        for raw in payload:
            pb = pb2_module.Detections()
            pb.ParseFromString(raw)
            out.append(_from_protobuf(pb))
        return out
    # Already-deserialized protobuf objects
    return [_from_protobuf(pb) for pb in payload]


def detections_to_dataframe(detections: List[FrameDetections],
                            video_height: int = 1080,
                            video_width: int = 1920):
    """Flatten to the row format of homan/datasets/epichoa.py:16-72:
    one row per hand/object detection with pixel-space boxes."""
    import pandas as pd
    rows = []
    for det in detections:
        for h in det.hands:
            b = h.bbox.scale(video_width, video_height)
            rows.append({
                "video_id": det.video_id, "frame": det.frame_number,
                "det_type": "hand",
                "side": "left" if h.side == HandSide.LEFT else "right",
                "state": int(h.state), "score": h.score,
                "left": b.left, "top": b.top,
                "right": b.right, "bottom": b.bottom,
                "obj_offx": h.object_offset.x, "obj_offy": h.object_offset.y,
            })
        for o in det.objects:
            b = o.bbox.scale(video_width, video_height)
            rows.append({
                "video_id": det.video_id, "frame": det.frame_number,
                "det_type": "object", "side": "", "state": -1,
                "score": o.score,
                "left": b.left, "top": b.top,
                "right": b.right, "bottom": b.bottom,
                "obj_offx": 0.0, "obj_offy": 0.0,
            })
    return pd.DataFrame(rows)
