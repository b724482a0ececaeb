"""Compute primitives of the port: framing, FFTs, extraction, detection,
and the wrappers of the hand-written kernels."""
