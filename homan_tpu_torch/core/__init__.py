"""Core math: rotations, cameras, the MANO hand model, meshes."""
