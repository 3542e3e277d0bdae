"""Consistency math and the hand-written kernels of the port."""

from tvc_torch.core import consistency, similarity  # noqa: F401
