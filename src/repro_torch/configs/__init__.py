"""Model configurations served by the port: the paper's conv table."""
from repro_torch.configs.paper_convs import TABLE1, BATCH_SIZES, ConvLayer

__all__ = ["TABLE1", "BATCH_SIZES", "ConvLayer"]
