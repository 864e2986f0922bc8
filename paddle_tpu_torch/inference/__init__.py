"""Serving of the port: synchronous greedy paged serving, with a float or
int8 KV cache, float or int8/int4 weights, greedy speculative decoding
(n-gram and draft-model drafters), preemption to a host-RAM tier, a
bounded queue, cancellation and the tiered radix prefix cache."""

from .prefixcache import HostTier, RadixPrefixCache  # noqa: F401
from .serving import (TERMINAL_STATES, AdmissionError,  # noqa: F401
                      BlockPool, Request, ServingEngine)
from .speculative import (Drafter, ModelDrafter, NGramDrafter,  # noqa: F401
                          accept_drafts, build_spec_verify)
