"""Models of the port: Llama for paged serving and for pretraining."""

from .convert import llama_state_from_jax  # noqa: F401
from .generation import GenerationConfig  # noqa: F401
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    LlamaPretrainingCriterion, llama_3_8b_config,
                    tiny_llama_config)
