"""The ``callbacks`` namespace (counterpart of paddle_tpu/callbacks.py): the
hapi callback classes."""
from .hapi.callbacks import *  # noqa: F401,F403
from .hapi.callbacks import __all__  # noqa: F401
