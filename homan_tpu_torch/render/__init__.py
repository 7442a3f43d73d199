"""Differentiable soft-silhouette rendering on hand-written CUDA kernels."""

from homan_tpu_torch.render.rasterizer import (  # noqa: F401
    MeshTopology,
    RasterSettings,
    project_ndc,
    rasterize_soft,
)
