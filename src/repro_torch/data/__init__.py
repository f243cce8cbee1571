"""Calibration corpus reader of the port."""
