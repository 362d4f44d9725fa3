from levelsetfusion_tpu_torch.io import synthetic

__all__ = ["synthetic"]
