from levelsetfusion_tpu_torch.io import datasets, synthetic

__all__ = ["datasets", "synthetic"]
