"""Layers and backbones (NCHW)."""
