"""Model classes with tpudet's public API (the SSD slice, trained and served: SSD300, SSD512)."""

from tpudet_torch.models.ssd import SSD300, SSD512  # noqa: F401
