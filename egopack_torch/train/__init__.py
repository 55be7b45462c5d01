"""Optimizer and the phase-1 multi-task system."""
