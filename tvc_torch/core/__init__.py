"""Consistency math and the hand-written kernels of the port."""
