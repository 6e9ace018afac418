"""Class-name encoders (counterpart of ``tpudet/data/classes.py``; the reference's
utils/voc_classname_encoder.py and imagenet_classname_encoder.py).

VOC: the canonical 20 Pascal-VOC classes in alphabetical order (ids 0..19; background
is id ``num_classes`` where a model needs one). ImageNet: the reference ships a
hard-coded 1000-entry wnid->id dict; here the mapping is derived from the sorted class
subdirectories of the dataset (identical for a standard ImageNet layout) via
``imagenet_classname_to_ids``.
"""

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair",
    "cow", "diningtable", "dog", "horse", "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
)

classname_to_ids = {name: i for i, name in enumerate(VOC_CLASSES)}
ids_to_classname = {i: name for i, name in enumerate(VOC_CLASSES)}


def imagenet_classname_to_ids(img_dir: str):
    """wnid -> id from the sorted class subdirectories of an ImageNet train dir."""
    import os

    names = sorted(
        d for d in os.listdir(img_dir) if os.path.isdir(os.path.join(img_dir, d))
    )
    return {name: i for i, name in enumerate(names)}
