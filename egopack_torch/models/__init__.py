"""Backbone, pooling, layers and task heads."""
