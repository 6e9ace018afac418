"""Model classes with tpudet's public API: SSD300, SSD512, RetinaNet,
RefineDet320 (alias RefineDet), PFPNetR, YOLOv2, YOLOv3, FCOS, CenterNet and
LHRCNN, trained and served."""

from tpudet_torch.models.centernet import CenterNet  # noqa: F401
from tpudet_torch.models.fcos import FCOS  # noqa: F401
from tpudet_torch.models.lhrcnn import LHRCNN  # noqa: F401
from tpudet_torch.models.refinedet import PFPNetR, RefineDet, RefineDet320  # noqa: F401
from tpudet_torch.models.retinanet import RetinaNet  # noqa: F401
from tpudet_torch.models.ssd import SSD300, SSD512  # noqa: F401
from tpudet_torch.models.yolo import YOLOv2, YOLOv3  # noqa: F401
