"""Distributed utilities of the LM path: activation sharding over a mesh
(``DTensor``s at block boundaries) and the expert-parallel MoE."""
from repro_torch.parallel.act_sharding import (activation_sharding,
                                               constrain, current_mesh)

__all__ = ["activation_sharding", "constrain", "current_mesh"]
