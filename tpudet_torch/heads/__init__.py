"""Detection heads: anchors, prediction layers, decode."""
