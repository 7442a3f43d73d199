"""Many clips and long clips (homan_tpu/parallel/): batched independent
clips in one set of launches a step (clips.py), one clip's frames split
over devices (frames.py), and the multi-process glue (multihost.py)."""
