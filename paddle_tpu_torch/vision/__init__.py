"""Vision (counterpart of paddle_tpu/vision): the model zoo in ``models``,
host-side preprocessing in ``transforms`` and local-file datasets in
``datasets``. The detection ops of the reference's ``vision/ops.py`` are
not ported yet (ROADMAP queue 1, item 12b)."""
from . import datasets, models, transforms  # noqa: F401
from .models import *  # noqa: F401,F403
