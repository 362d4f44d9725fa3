from levelsetfusion_tpu_torch.core.grid import GridSpec, voxel_center_coordinates
from levelsetfusion_tpu_torch.core.camera import PinholeCamera, Camera2d

__all__ = ["GridSpec", "voxel_center_coordinates", "PinholeCamera", "Camera2d"]
