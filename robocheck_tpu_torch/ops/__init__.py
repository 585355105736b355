"""Geometry ops in PyTorch: pose transform, AABBs, narrow phase."""
