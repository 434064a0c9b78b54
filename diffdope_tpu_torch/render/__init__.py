"""Rendering for the port: planar setup and binning, the pack (K1/K2), the
bin-table rasters (K3/K4, K7), the fused loss (K5/K6), the render and the
fused refinement loss; and the nvdiffrast-style API ops ``rasterize`` (K8),
``interpolate``, ``texture`` and ``antialias``."""

from diffdope_tpu_torch.render.antialias import antialias
from diffdope_tpu_torch.render.interpolate import interpolate
from diffdope_tpu_torch.render.pipeline import render_batch
from diffdope_tpu_torch.render.rasterize import rasterize
from diffdope_tpu_torch.render.texture import texture
