"""Model classes with tpudet's public API: SSD300, SSD512 and RetinaNet,
trained and served."""

from tpudet_torch.models.retinanet import RetinaNet  # noqa: F401
from tpudet_torch.models.ssd import SSD300, SSD512  # noqa: F401
