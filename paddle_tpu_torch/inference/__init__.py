"""Serving of the port (slice 1: synchronous greedy paged serving)."""

from .serving import BlockPool, Request, ServingEngine  # noqa: F401
