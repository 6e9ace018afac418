"""Detection ops: anchors, box geometry, greedy NMS and the CUDA kernels."""
