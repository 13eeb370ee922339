"""Raster and model-state input/output (numpy and PyTorch)."""
