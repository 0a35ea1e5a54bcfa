"""The high-level Model API (counterpart of paddle_tpu/hapi): ``Model``'s
prepare / fit / evaluate / predict / save / load, and the callbacks."""
from . import callbacks  # noqa: F401
from .callbacks import (Callback, EarlyStopping, LRScheduler,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger)
from .model import Model  # noqa: F401
