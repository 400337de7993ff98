"""Tree, memory-accounting and device helpers."""
