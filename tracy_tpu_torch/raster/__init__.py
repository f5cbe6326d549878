from tracy_tpu_torch.raster.rasterizer import render_raster

__all__ = ["render_raster"]
