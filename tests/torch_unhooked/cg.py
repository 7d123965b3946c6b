"""The host-read schedule the copied loops import (``ops/cg.py``)."""
from muse_tpu_torch.ops.cg import _CHECK_EVERY  # noqa: F401
