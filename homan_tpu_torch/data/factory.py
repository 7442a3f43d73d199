"""Dataset factory (homan_tpu/data/factory.py): name -> (dataset,
image_size)."""
from __future__ import annotations


def get_dataset(name: str, split: str = "val", frame_nb: int = 10,
                box_mode: str = "gt", chunk_step: int = 4, **kwargs):
    """HO-3D only; `kwargs` go to the dataset (root, mano_root, device...).
    CORe50 and EPIC-Kitchens are not ported yet (ROADMAP.md Queue 1 item
    20)."""
    if name == "ho3d":
        from homan_tpu_torch.data.ho3d import HO3D
        ds = HO3D(split=split, frame_nb=frame_nb, box_mode=box_mode,
                  chunk_step=chunk_step, **kwargs)
        return ds, 640
    if name in ("core50", "epic"):
        raise NotImplementedError(
            f"the {name} dataset is not ported yet (ROADMAP.md Queue 1 item "
            "20); the port reads ho3d")
    raise ValueError(f"unknown dataset {name}; choose ho3d|core50|epic")
