"""Models of the port: Llama (paged serving, generate() and
pretraining), GPT (the same serving surfaces and pretraining), the
ERNIE/BERT encoders with their fine-tune and pretraining heads, and the
PP-OCR detector and recognizer (``ocr``); the vision zoo is
``paddle_tpu_torch.vision.models``."""

from .convert import (ernie_state_from_jax, gpt_state_from_jax,  # noqa: F401
                      layer_state_from_jax, linear_weight_names,
                      llama_state_from_jax, ocr_state_from_jax, optimizer_state_from_jax,
                      optimizer_state_to_jax, vision_state_from_jax)
from .ernie import (BertConfig, BertForPretraining,  # noqa: F401
                    BertForQuestionAnswering, BertForSequenceClassification,
                    BertForTokenClassification, BertModel, ErnieConfig,
                    ErnieForPretraining, ErnieForQuestionAnswering,
                    ErnieForSequenceClassification,
                    ErnieForTokenClassification, ErnieModel,
                    ErniePretrainingCriterion, ernie_base_config,
                    tiny_ernie_config)
from .generation import GenerationConfig, GenerationMixin  # noqa: F401
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTPretrainingCriterion, gpt2_small_config,
                  gpt3_13b_config, tiny_gpt_config)
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    LlamaPretrainingCriterion, llama_3_8b_config,
                    llama_3_70b_config, tiny_llama_config)
from .ocr import (CRNN, DBFPN, PPOCRSystem, CRNNConfig,  # noqa: F401
                  CTCHeadLoss, DBHead, DBLoss, DBNet, DBNetConfig,
                  ctc_greedy_decode, db_postprocess)
