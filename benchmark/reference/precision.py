"""The precision of the reference's products, and the control's rounding.

The reference computes in fp32 with TF32 off.  ``round_to`` rounds a
product's operands one precision lower, as the control does (the reference
put in the program's place one precision below the configuration's).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp32_products() -> None:
    """True fp32 products on the card: TF32 would keep ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """Operands rounded to ``dtype`` and back to fp32 (products of rounded
    operands summed in fp32, as a tensor core of that type does).  The
    rounding passes gradients through unchanged: a cast's own backward
    would round them to ``dtype`` as well, and fp8 has no range for them."""
    return lambda t: t + (t.to(dtype).float() - t).detach()
