"""Serving of the port: continuous-batching paged serving, greedy or with
per-request sampling and token-mask constrained decoding, with a float or
int8 KV cache, float or int8/int4 weights, speculative decoding (n-gram
and draft-model drafters, greedy or sampled), preemption to a host-RAM
tier, a bounded queue, cancellation and the tiered radix prefix cache,
instrumented by the metrics registry, the flight recorder and spans, and
driven under adversarial schedules by the fault injector; and the dense
serving session ``LLMPredictor`` (greedy, sampled or beam search, with its
save/load artifact), its programs captured as CUDA graphs on the card;
and the fleet layer above the engine: token streaming (``TokenStream``),
the ``Router`` over N replicas with affinity, failover and prefill/decode
disaggregation, the framed wire transport (``LoopbackTransport``,
``SocketTransport``, ``RemoteReplica``) and process replicas
(``EngineHost``, ``EngineProcess``, ``TCPStoreLite``); and multi-tenant
batched LoRA serving (``AdapterStore``, ``LoraAdapter``) with fair-share
admission over tenants."""

from .faultinject import FaultInjector  # noqa: F401
from .llm import LLMPredictor  # noqa: F401
from .lora import AdapterStore, LoraAdapter  # noqa: F401
from .prefixcache import HostTier, RadixPrefixCache  # noqa: F401
from .sampling import (DfaTokenMask, SamplingParams,  # noqa: F401
                       TokenMaskProcessor)
from .serving import (ENGINE_ROLES, HANDOFF_REASONS,  # noqa: F401
                      TERMINAL_STATES, AdmissionError, BlockPool,
                      EngineStalledError, PoisonedDispatchError,
                      ReplicaKilledError, Request, ServingEngine,
                      TokenStream)
from .speculative import (Drafter, ModelDrafter, NGramDrafter,  # noqa: F401
                          accept_drafts, accept_drafts_sampled,
                          build_spec_verify)
from .router import (HEALTH_STATES, ROUTER_POLICIES,  # noqa: F401
                     RoutedRequest, Router)
from .transport import (FRAME_KINDS, LoopbackTransport,  # noqa: F401
                        RemoteReplica, SocketTransport,
                        TransportDeadError, TransportError,
                        WIRE_VERSION)
from .procserve import (EngineHost, EngineProcess,  # noqa: F401
                        TCPStoreLite)
