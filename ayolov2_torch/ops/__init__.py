"""Ops: the fused early-network kernel and fixed-shape decode + NMS."""
