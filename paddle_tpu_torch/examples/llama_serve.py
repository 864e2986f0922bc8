"""Cached-KV Llama serving end to end: the twin of ``examples/llama_serve.py``.

    python -m paddle_tpu_torch.examples.llama_serve
    python -m paddle_tpu_torch.examples.llama_serve --device cpu

The four steps of the JAX package's example on the tiny Llama (random
weights from seed 0, prompts from ``np.random.default_rng(0)``): (1)
greedy ``generate()``, one captured CUDA graph of prefill and every
decode step on the card; (2) an ``LLMPredictor`` session, prefilled once
and decoded in blocks of 4 steps; (3) the serving artifact
(``.ptpu_torch_llm``) saved into a temporary directory and loaded
without the model object, which must reproduce the session's tokens; (4)
weight-only int8: ``weight_only_quantize`` converts a copy of the model
(every projection a ``QuantizedLinearInfer``, ``lm_head`` kept float)
and a session of the converted copy generates.  ``--device`` picks the
torch device (the CUDA card unless ``cpu`` is asked for).
"""

import argparse
import tempfile

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def int8_session(net, prompt):
    """Step 4: ``weight_only_quantize`` a copy of ``net`` (``lm_head``
    kept float) and generate 12 tokens of ``prompt`` [2, 8] through a
    session of the copy; ``net`` is left as it was."""
    from paddle_tpu_torch.inference.llm import LLMPredictor
    from paddle_tpu_torch.quantization import weight_only_quantize

    qnet = weight_only_quantize(net, inplace=False,
                                skip=lambda name, l: name == "lm_head")
    qpred = LLMPredictor(qnet, batch=2, prompt_len=8, max_cache_len=32,
                         steps_per_call=4)
    return qpred.generate(prompt, max_new_tokens=12)


def main(argv=None):
    """Run the four steps; returns ``{"generate", "session", "artifact",
    "int8"}``, the int32 token arrays each step printed."""
    args = parse_args(argv)

    from paddle_tpu_torch.inference.llm import LLMPredictor
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config

    cfg = tiny_llama_config()
    net = LlamaForCausalLM(cfg, device=args.device, seed=0)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, 8))

    # 1) model.generate: one program, static KV cache
    toks = net.generate(prompt, max_new_tokens=12,
                        eos_token_id=None).cpu().numpy()
    print("generate:", toks[0])

    # 2) serving session: prefill once, then decode incrementally in
    #    blocks (each block = one program call)
    pred = LLMPredictor(net, batch=2, prompt_len=8, max_cache_len=32,
                        steps_per_call=4)
    first = pred.start(prompt)
    more = pred.decode(11)
    session = np.concatenate([first[:, None], more], axis=1)
    print("session :", session[0])

    # 3) the artifact round trip (config + weights; loads without the
    #    model object)
    with tempfile.TemporaryDirectory() as td:
        pred.save(td + "/llama_serve")
        loaded = LLMPredictor.load(td + "/llama_serve",
                                   device=pred.device)
        again = loaded.generate(prompt, max_new_tokens=12)
    if not np.array_equal(again, session):
        raise AssertionError(f"the artifact must reproduce the session: "
                             f"{again} != {session}")
    print("artifact:", again[0], "(deterministic)")

    # 4) weight-only int8: halve the weight stream (decode is
    #    weight-streaming bound)
    int8 = int8_session(net, prompt)
    print("int8    :", int8[0])
    return {"generate": toks, "session": session, "artifact": again,
            "int8": int8}


if __name__ == "__main__":
    main()
