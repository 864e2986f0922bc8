"""Serving of the port: synchronous greedy paged serving, with a float or
int8 KV cache, float or int8/int4 weights and greedy speculative decoding
(n-gram and draft-model drafters)."""

from .serving import BlockPool, Request, ServingEngine  # noqa: F401
from .speculative import (Drafter, ModelDrafter, NGramDrafter,  # noqa: F401
                          accept_drafts, build_spec_verify)
