"""Automatic mixed precision (counterpart of paddle_tpu/amp): ``auto_cast``
applies the reference's per-op dtype plan to torch calls, ``decorate``
casts a model's parameters for O2, ``GradScaler`` scales the loss."""
from .auto_cast import (BLACK_LIST, WHITE_LIST, amp_guard,  # noqa: F401
                        amp_state, auto_cast, decorate)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401
