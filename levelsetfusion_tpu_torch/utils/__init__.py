from levelsetfusion_tpu_torch.utils import config, telemetry

__all__ = ["config", "telemetry"]
