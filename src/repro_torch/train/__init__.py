"""Step builders of the LM path (serving half: prefill and decode)."""
from repro_torch.train.step import make_prefill_step, make_decode_step

__all__ = ["make_prefill_step", "make_decode_step"]
