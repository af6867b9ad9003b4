"""Timing, profiling and device helpers."""
