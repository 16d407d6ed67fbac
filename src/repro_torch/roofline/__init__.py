from .analysis import (HBM_BW, ICI_BW_EFF, PEAK_FLOPS, Roofline, analyse,
                       summarise)
from .counter import Counter

__all__ = ["HBM_BW", "ICI_BW_EFF", "PEAK_FLOPS", "Roofline", "analyse",
           "summarise", "Counter"]
