"""``python -m paddle_tpu_torch.distributed.launch``: the multi-process
launcher (counterpart of paddle_tpu/distributed/launch, the reference's
``python/paddle/distributed/launch/``). ``main`` holds the ``Pod`` of
trainer processes, its supervision (restart with backoff and budget,
shrink and grow, lease expiry, hang detection), the rendezvous over the
port's ``TCPStore`` and the ``launch()`` command line."""
from .main import Pod, launch  # noqa: F401
