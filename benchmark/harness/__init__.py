"""The benchmark's general machinery: it finds a cell's configuration,
traffic mix, limits and per-layer metrics by name, drives the program, and
judges what it produced."""
