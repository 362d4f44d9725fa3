from levelsetfusion_tpu_torch.ops import derivatives, interpolation, sobolev, terms, tsdf

__all__ = ["derivatives", "interpolation", "sobolev", "terms", "tsdf"]
