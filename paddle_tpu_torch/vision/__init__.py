"""Vision (counterpart of paddle_tpu/vision): the model zoo in ``models``,
host-side preprocessing in ``transforms``, local-file datasets in
``datasets`` and the detection operators in ``ops`` (NMS, box coding, the
YOLOv3 head, prior boxes, the RoI poolings, FPN levels, RPN proposals,
deformable convolution)."""
from . import datasets, models, ops, transforms  # noqa: F401
from .models import *  # noqa: F401,F403
