from ray_tpu_torch.dashboard.head import DashboardHead

__all__ = ["DashboardHead"]
