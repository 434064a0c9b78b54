"""Rendering for the port: planar setup and binning, the compact raster
(K3/K4), the fused loss (K5/K6) and the fused refinement loss."""
