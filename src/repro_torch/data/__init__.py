from repro_torch.data.pipeline import (DataConfig, frames_batch, image_batch,
                                       lm_batch)

__all__ = ["DataConfig", "lm_batch", "frames_batch", "image_batch"]
