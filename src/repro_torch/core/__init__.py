"""Core AQUA math, caches and attention of the port."""
