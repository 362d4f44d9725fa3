from levelsetfusion_tpu_torch.utils import checkpoint, config, telemetry

__all__ = ["checkpoint", "config", "telemetry"]
