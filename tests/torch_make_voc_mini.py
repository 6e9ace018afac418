"""Write the mini VOC set under ``tests/torch_data/voc_mini/``.

Eight VOC-size JPEG images (two each of 500x375, 375x500, 500x333 and 353x500,
width by height), each holding 1-5 objects drawn as ``scripts/synthvoc.py``'s
shapes (class = shape * 5 + colour) on a smooth background with light noise,
and one Pascal-VOC annotation each. JPEG quality 75 at 4:2:0 subsampling.
Everything is drawn from one seed; the files are committed, so this runs only
when the set is to change:

    python tests/torch_make_voc_mini.py

It needs PIL. The port's data tests and ``chip_smoke.py`` read the set.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = Path(__file__).resolve().parent / "torch_data" / "voc_mini"
SIZES = ((500, 375), (375, 500), (500, 333), (353, 500))  # (width, height)
SEED = 2009


def _background(rng, h, w):
    """A smooth two-colour gradient plus light noise, float32 HWC."""
    a, b = rng.uniform(60, 190, (2, 3))
    angle = rng.uniform(0, np.pi)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t = (np.cos(angle) * yy / h + np.sin(angle) * xx / w + 1.0) / 2.0
    img = a + (b - a) * t[..., None]
    return (img + rng.normal(0, 2.0, (h, w, 3))).astype(np.float32)


def _annotation(name, w, h, objects, classes):
    rows = []
    for cid, y1, x1, y2, x2 in objects:
        rows.append(
            "  <object>\n"
            f"    <name>{classes[cid]}</name>\n"
            "    <pose>Unspecified</pose>\n"
            "    <truncated>0</truncated>\n"
            "    <difficult>0</difficult>\n"
            "    <bndbox>\n"
            f"      <xmin>{x1 + 1}</xmin>\n      <ymin>{y1 + 1}</ymin>\n"
            f"      <xmax>{x2}</xmax>\n      <ymax>{y2}</ymax>\n"
            "    </bndbox>\n"
            "  </object>\n")
    return ("<annotation>\n"
            "  <folder>VOC2007</folder>\n"
            f"  <filename>{name}.jpg</filename>\n"
            f"  <size>\n    <width>{w}</width>\n    <height>{h}</height>\n"
            "    <depth>3</depth>\n  </size>\n"
            "  <segmented>0</segmented>\n"
            + "".join(rows) + "</annotation>\n")


def main():
    from PIL import Image

    sys.path.insert(0, str(REPO / "scripts"))
    sys.path.insert(0, str(REPO))
    from synthvoc import _render_object

    from tpudet_torch.data.classes import VOC_CLASSES

    rng = np.random.default_rng(SEED)
    (OUT / "Annotations").mkdir(parents=True, exist_ok=True)
    (OUT / "JPEGImages").mkdir(parents=True, exist_ok=True)
    for i in range(8):
        w, h = SIZES[i % len(SIZES)]
        name = f"{i + 1:06d}"
        img = _background(rng, h, w)
        objects = []
        for _ in range(int(rng.integers(1, 6))):
            cid = int(rng.integers(0, 20))
            bh, bw = int(rng.uniform(0.16, 0.45) * h), int(rng.uniform(0.16, 0.45) * w)
            y1, x1 = int(rng.integers(1, h - bh - 1)), int(rng.integers(1, w - bw - 1))
            _render_object(img, cid, y1, x1, y1 + bh, x1 + bw)
            objects.append((cid, y1, x1, y1 + bh, x1 + bw))
        pixels = np.clip(np.round(img), 0, 255).astype(np.uint8)
        Image.fromarray(pixels).save(OUT / "JPEGImages" / f"{name}.jpg", quality=75,
                                     subsampling=2)
        (OUT / "Annotations" / f"{name}.xml").write_text(
            _annotation(name, w, h, objects, VOC_CLASSES))
    total = sum(os.path.getsize(p) for p in OUT.rglob("*") if p.is_file())
    print(f"wrote 8 images and annotations to {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
