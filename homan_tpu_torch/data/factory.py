"""Dataset factory (homan_tpu/data/factory.py): name -> (dataset,
image_size)."""
from __future__ import annotations


def get_dataset(name: str, split: str = "val", frame_nb: int = 10,
                box_mode: str = "gt", chunk_step: int = 4,
                mano_root: str | None = None, device=None, **kwargs):
    """`kwargs` go to the dataset. `mano_root` and `device` (the driver
    passes both) go to HO-3D alone, the one dataset that runs MANO: the
    CORe50 and EPIC constructors take neither (the JAX factory passes them
    on, and those two raise TypeError there)."""
    if name == "ho3d":
        from homan_tpu_torch.data.ho3d import HO3D
        if mano_root is not None:
            kwargs["mano_root"] = mano_root
        ds = HO3D(split=split, frame_nb=frame_nb, box_mode=box_mode,
                  chunk_step=chunk_step, device=device, **kwargs)
        return ds, 640
    if name == "core50":
        from homan_tpu_torch.data.core50 import Core50
        ds = Core50(split=split, frame_nb=frame_nb, chunk_step=chunk_step,
                    **kwargs)
        return ds, 350
    if name == "epic":
        from homan_tpu_torch.data.epic import Epic
        ds = Epic(frame_nb=frame_nb, **kwargs)
        return ds, 640
    raise ValueError(f"unknown dataset {name}; choose ho3d|core50|epic")
