"""Raster and sampling ops (port of funky_tpu/ops/)."""

from .raster import RasterConfig, rasterize  # noqa: F401
