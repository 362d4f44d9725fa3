from levelsetfusion_tpu_torch.ops import derivatives, interpolation, pyramid, sobolev, terms, tsdf

__all__ = ["derivatives", "interpolation", "pyramid", "sobolev", "terms", "tsdf"]
