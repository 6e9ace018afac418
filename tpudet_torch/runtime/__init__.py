"""Config validation, weight transfer, checkpoints, pretrained weights."""
