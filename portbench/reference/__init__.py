"""Plain PyTorch and NumPy reference of the joint hand-object fit.

The straightforward mathematics of the recipe, written for a batch of clips
with the clip axis explicit: MANO (`mano`), rigid placement and projection
(`geometry`), the soft silhouette computed per pixel over every contour edge
with no tiles and no edge slots (`silhouette`), the interior-SDF grids and
their sampling (`voxel`), each loss term (`losses`) and the Adam loop
(`fit`). It imports neither jax nor homan_tpu nor homan_tpu_torch, and it
takes nothing the program made: mesh topology, contour edges, grids and
packs are all worked out here again from the raw inputs.
"""
