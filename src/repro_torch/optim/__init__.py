"""Optimizer and learning-rate schedule of the port's trainer."""
