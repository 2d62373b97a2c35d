"""Distributed utilities of the LM path (the activation-sharding hook)."""
from repro_torch.parallel.act_sharding import constrain, current_mesh

__all__ = ["constrain", "current_mesh"]
