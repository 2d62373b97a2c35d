from repro_torch.data.pipeline import DataConfig, image_batch

__all__ = ["DataConfig", "image_batch"]
