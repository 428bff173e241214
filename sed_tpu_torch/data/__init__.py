"""Training data: label rasterization, splits, preprocessing, datasets and the device pipeline."""
