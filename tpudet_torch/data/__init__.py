"""Data subsystem (counterpart of ``tpudet/data``): TFRecord IO without
TensorFlow, VOC/ImageNet dataset authoring, the image augmentor, and the
host-side input pipeline feeding the device. NumPy and the standard library
only; ``cv2`` and ``PIL`` are imported inside the functions that decode JPEG."""
