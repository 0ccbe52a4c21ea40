"""Ops of the port: host features, recurrences, and the wrappers of the hand-written kernels."""
