"""Analysis of the port's programs.

  roofline    modelled HBM bytes and flops of pass programs, Bluestein
              programs and convolutions; the tuner's roofline pruning
"""

from repro_torch.analysis import roofline

__all__ = ["roofline"]
