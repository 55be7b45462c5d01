"""Validation loops, meters and metric primitives."""
