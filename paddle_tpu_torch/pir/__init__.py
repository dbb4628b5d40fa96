"""PIR. reference: paddle_tpu/pir/.

Only the serving engine's pricer is ported (`analysis.py`: `OpCost`,
`ProgramCost`, `DEFAULT_ROOFLINE` and `price`). The reference's program
IR, its passes, the full `CostModel` and `to_static` wait for the PIR
slice (ROADMAP.md, slice 6).
"""

from .analysis import DEFAULT_ROOFLINE, OpCost, ProgramCost, price

__all__ = ["OpCost", "ProgramCost", "DEFAULT_ROOFLINE", "price"]
