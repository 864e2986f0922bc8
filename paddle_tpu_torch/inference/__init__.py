"""Serving of the port: synchronous greedy paged serving, with a float or
int8 KV cache and float or int8/int4 weights."""

from .serving import BlockPool, Request, ServingEngine  # noqa: F401
