"""Models of the port: Llama for paged serving, generate() (greedy,
sampled, beam) and pretraining."""

from .convert import (llama_state_from_jax,  # noqa: F401
                      optimizer_state_from_jax, optimizer_state_to_jax)
from .generation import GenerationConfig, GenerationMixin  # noqa: F401
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    LlamaPretrainingCriterion, llama_3_8b_config,
                    tiny_llama_config)
