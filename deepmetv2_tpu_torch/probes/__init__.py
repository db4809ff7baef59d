"""Measurement probes: entry points that time a kernel variant against the
one the main path runs."""
