"""Serving of the port: continuous-batching paged serving, greedy or with
per-request sampling and token-mask constrained decoding, with a float or
int8 KV cache, float or int8/int4 weights, speculative decoding (n-gram
and draft-model drafters, greedy or sampled), preemption to a host-RAM
tier, a bounded queue, cancellation and the tiered radix prefix cache,
instrumented by the metrics registry, the flight recorder and spans, and
driven under adversarial schedules by the fault injector; and the dense
serving session ``LLMPredictor`` (greedy, sampled or beam search, with its
save/load artifact), its programs captured as CUDA graphs on the card."""

from .faultinject import FaultInjector  # noqa: F401
from .llm import LLMPredictor  # noqa: F401
from .prefixcache import HostTier, RadixPrefixCache  # noqa: F401
from .sampling import (DfaTokenMask, SamplingParams,  # noqa: F401
                       TokenMaskProcessor)
from .serving import (TERMINAL_STATES, AdmissionError,  # noqa: F401
                      BlockPool, EngineStalledError, PoisonedDispatchError,
                      ReplicaKilledError, Request, ServingEngine)
from .speculative import (Drafter, ModelDrafter, NGramDrafter,  # noqa: F401
                          accept_drafts, accept_drafts_sampled,
                          build_spec_verify)
