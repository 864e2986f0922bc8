#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --decode-window [--root TREE]
    python3 chip_smoke.py --quant-window [--root TREE]
    python3 chip_smoke.py --norm-window [--root TREE]
    python3 chip_smoke.py --facade-window [--root TREE]

The second form measures only the decode attention kernels, alone and
in the serving step (``phase_decode_window``), the third the quantized
matmul and the int8 decode, alone and in the quantized serving step
(``phase_quant_window``), the fourth RoPE and RMSNorm, alone, in a train
step and in the serving decode step, and the host cost of the kernels'
dispatcher ops (``phase_norm_window``), the fifth the host cost of the
tensor ops that the port's models call through ``nn.functional``
(``phase_facade_window``), of this
checkout or of the port in another tree (a parent commit unpacked beside
it); none prints a result line.

Phases, each of which raises (nonzero exit, no result line) on failure:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the build of every CUDA kernel of the port from
   ``paddle_tpu_torch/csrc/`` (one nvcc per source, all in parallel);
2. each kernel against its plain PyTorch version on the card at the
   shapes its paths give it, GPT's too (``phase_gpt_kernels``: the paged,
   int8, K-wide and dense decode at G = 1 with 40 heads of D = 128 and
   12 of D = 64, the quantized matmul with bias at GPT-3 13B's four
   projections for M = 1, 8, 40 and 256, flash forward and backward at
   GPT-2 small's B=8 S=1024 H=12 D=64) (serving: paged decode over a float and an
   int8 cache, each row bit-equal alone and beside an all-trash row,
   RMSNorm (below), the
   int8/int4 quantized matmul at the 8B projections at M = 1, 8, 40
   (decode, verify) and 256 (a prefill chunk), a row bit-equal at every
   M with and without bias and act; speculative decoding: the K-wide verify attention
   over a float and an int8 cache at B=8, C=5, timed there and at B=1,
   each row bit-equal to itself alone, beside an all-trash row and in a
   ragged pair, and the dense decode of the draft model's ``generate()``
   at S = max_context + max_draft, a row bit-equal at B=1 and B=3;
   training: flash-attention forward and backward (one-pass, and the
   two-pass dQ and dK/dV kernels, whose dQ must be bit-identical over two
   launches) at the training shape, and beyond it the forward at the 8B
   drafter's prefill (B=1 S=512 D=128), at a ragged causal length
   (S=1000, D=128) and non-causal with Sq != Sk, and both backward
   routes at the ragged length with G = 4 and G = 1 (the one-pass also
   non-causal at D=64); RoPE forward and backward, bit-identical to the
   plain version, at q and k of the training step, at the 8B drafter's
   prefill and on the element route; RMSNorm at one decode step's rows,
   a prefill chunk's and the training step's, each row's bits equal
   alone and inside batches of 8 and 256 rows, against ``F.rms_norm`` in
   turns beside the launch floor (``torch.cuda._sleep(0)``), both beside
   torch's copy of the same bytes (``_copy_floor``); and the
   fused AdamW update, bit-identical to its
   plain version for every parameter and moment dtype, with and without
   stochastic rounding), bfloat16 and float32, with
   CUDA-event timings of the kernel, the plain version and one PyTorch
   library call that computes the same function where there is one (a
   yardstick the port never calls), beside the least time the card could
   take (``bound_ms``); and the sampler (``phase_sampler``): threefry
   bits and uniforms of 8 keys over ``[8, 128256]`` bit-equal card vs
   CPU, ``categorical_rows`` over 65536 draws of one 16-token row against
   its softmax by a chi-square test at the 0.999 quantile, and
   ``sample_rows`` alone timed in the greedy, sampled and sampled +
   filtered buckets, eagerly and as a captured graph;
3a. the decode block as a CUDA graph at full Llama-3-8B width (32
   layers, bfloat16, random weights from ``--seed``): the engine's
   captured program against the eager ``paged_decode_block`` at B=8
   (every slot live at a ragged length) for 1 and 2 scanned steps, in
   bf16 and with an int8 KV cache and int8 weights, on the same inputs
   and copies of the same arenas: tokens, carries and arenas bit-equal,
   and one replay counting exactly the launches of one eager block; then
   the sampled block (all four sampling flags: a greedy/sampled mix with
   top-k, top-p, penalties, a presence plane and a mask bias), n = 1 and
   2: tokens, carries, ``pos``, ``presence`` and arenas bit-equal, the
   same launches;
3. serving at the same width: 8 requests through an 8-slot
   ``ServingEngine`` at its defaults (dispatch-ahead at depth 1, the
   decode block a captured CUDA graph, the radix prefix cache with its
   host tier, preemption on), two of them sharing a 256-token prefix so
   the prefix cache hits, in three arms in turns, twice each: the
   lockstep arm (``async_dispatch=False``), the default and
   ``async_depth=2``; every request must finish with in-vocabulary
   tokens, the arms' tokens must be equal, and the kernels' launch
   counters must rise by exactly their per-step counts (a graph replay
   counts the launches its capture recorded); each run logs tokens/s,
   TTFT, the forced syncs by reason, overlap seconds, the graphs and
   peak memory, and each arm's first run a decode window's unprofiled
   wall, device busy time and idle share (the union of the device
   intervals against the window's wall); the first default run also runs 8 steady-state decode
   steps under ``torch.cuda.set_sync_debug_mode("error")`` (no hidden
   host sync, every harvest deferred);
3b. quantized serving: the same model and trace through two engines with
   an int8 KV cache, one with int8 and one with int4 weights, under the
   same checks (the quantized matmul launches 7 per layer per forward,
   the int8 paged decode once per layer per decode step, the float one
   never), with tokens/s, TTFT, decode step, peak memory and a profiled
   decode window;
3c. speculative serving: the same model through three 8-slot engines
   with spec_decode=4 and a ``ModelDrafter``: (a) over the target itself,
   (b) the same with an int8 KV cache and int8 weights, (c) over a
   2-layer model of the same width from another seed, on a trace with
   shorter outputs (the draft model is cut to 2 layers so that rejection
   and rollback run at full width in little time); exact launch counts
   (the K-wide verify kernel once per layer per verify, the dense decode
   once per draft layer per drafter decode step, the flash forward once
   per draft layer per drafter prefill), acceptance above 0 in (a) and
   (b) and below 1 in (c), tokens/s, TTFT, verify step, peak memory and
   one profiled speculative step (the drafter's ``generate()`` replays
   one captured CUDA graph per draft model);
3d. preemption at the same width: a 4-slot engine over a 160-block pool
   serves three priority-0 requests (512-token prompts, 200 new tokens,
   45 blocks each); once all three decode, a priority-1 arrival (36
   blocks, 25 free) swaps one out to host RAM, and it resumes when
   blocks retire; preemptions and resumes counted, blocks and bytes
   out == in (bytes = blocks x the arena block size), resumed rows
   bit-equal to the host stacks, phase 3's launch formula; then with an
   int8 KV cache; each swap's ms and GB/s (through pinned host memory);
3e. the radix host tier at the same width: a 40-block pool, a finished
   request's 16 oldest cached prompt blocks demoted to host RAM by the
   next allocation and promoted back for a request sharing its first
   256 tokens, bit-equal to the demoted parcels; demote (a lazy gather
   reconciled at the next harvest point) and promote times;
3f. sampled serving at the same width: 8 requests (2 greedy, 2 seeded at
   T=0.8, top_k=50 top_p=0.9, repetition_penalty=1.2, a DFA token mask
   over a token subset, a seedless top_p=0.95) through phase 3's three
   arms in turns, twice each: tokens equal across the six runs, greedy
   rows equal an all-greedy engine's, tokens in the vocabulary, the mask
   row legal under its DFA, phase 3's launch formula, no sync in the
   lockstep arm and the same syncs by reason (mask and penalty among
   them) in both runs of an arm; a profiled decode window of the mix and
   of its deferrable rows against phase 3's greedy one (sampler kernels
   by group), and the sync-debug window on a sampled mix; then the mix
   with an int8 KV cache and int8 weights, and a sampled spec trace
   (spec_decode=4, a ModelDrafter over the target, T=0.8) with its
   acceptance and residual resamples;
3g. observability at the same width, on phase 3's model and trace: a
   private enabled ``MetricsRegistry`` with an enabled ``FlightRecorder``
   against both disabled, in turns (enabled, disabled, disabled,
   enabled), in the default engine and in lockstep: tokens equal phase
   3's in every run, the enabled runs hold phase 3's launch formula and
   the disabled ones launch the same; each run's steady decode window
   (wall per step, the means per step of its dispatch, overlap and host
   seconds; device busy time and idle share in each arm's first run)
   and the enabled-vs-disabled overhead of the step wall per mode; each
   enabled run's goodput ledger conserves exactly and ``stats()`` equals
   its registry key for key; the two enabled runs of a mode give equal
   flight records modulo wall; a profiled warm decode window's torch
   chrome trace merged with the flight-recorder lanes
   (``merge_chrome_traces``) holds one ``serving.decode_block`` range per
   block dispatch and the paged decode and RMSNorm kernels; and a fault
   trace modelled on phase 3d (4 slots over 160 blocks: an allocation
   failure, a forced swap with a 50 ms stall, a tier eviction, then a
   poisoned harvest raising ``PoisonedDispatchError``), the stall charged
   to ``serving.fault.stall_seconds`` and not to the step's host seconds,
   the survivors finished, the pool audit clean; after phase 4d, (f)
   phase 4d's trace (a) on the card and on the CPU gives equal flight
   records modulo wall, ledgers and counters;
3h. the dense generation programs at the same width: (a) ``generate()``
   as one captured CUDA graph against the eager ``generate_program`` on
   the same inputs, greedy at B=1 and at B=4 with ragged lengths (prompt
   512, 64 new tokens), sampled (T=0.8, top_k=50, top_p=0.9, a seed) and
   beam search (K=4, B=2, length penalty 1.0, an EOS): tokens bit-equal
   and each replay counting exactly the eager call's launches, with the
   capture ms, the replay wall against device busy and tokens/s; (b)
   ``LLMPredictor`` sessions of 8 rows (prompt 512, max_cache_len 1024,
   16 steps a block), greedy, sampled and with int8 weights: the
   prefill and block graphs against the eager session programs bit for
   bit with the eager block's launches per replay, the greedy and
   sampled sessions equal to ``generate()``, ``decode(5) + decode(11) ==
   decode(16)``, block wall against busy, tokens/s and peak memory; then
   a beam session (K=4, B=2) equal to ``generate()``; (c) the artifact
   round trip on the card (``save()``, then ``load()`` without the model
   object, a 1-layer model at the same width), equal on two calls;
3i. the fleet layer at the same width, on phase 3's model: (a) phase
   3's trace with every request streamed (``submit(stream=True)``):
   each stream's flushes concatenate to the unstreamed outputs, land
   only on steps with a harvest point, and add no forced sync; (b) a
   ``Router`` over two engines sharing the model, shared-prefix traffic:
   prefix-affinity routing, every request's tokens equal to it alone on
   a fresh 1-slot engine, a 1-replica router's flight record equal to
   the bare engine's; (c) the same trace with one replica killed by the
   fault injector while it holds a swapped and an in-flight request:
   tokens equal, the migrated bytes the parcel's; (d) a prefill-role
   and a decode-role engine, bf16 and int8 KV: every handoff parcel's
   prompt rows byte-equal to the monolithic engine's arena rows, tokens
   equal; (e) an ``EngineProcess`` child on the card (2 layers at the
   same width) behind ``SocketTransport``, force-swapped and killed by
   its own fault schedule: tokens equal an unfaulted in-process run's
   and two runs move identical frames; every arm with the fleet launch
   formula, tokens/s and TTFT;
3j. LoRA serving and fair share at the same width, on phase 3's model,
   geometry and trace (``phase_lora``): an ``AdapterStore(slots=2,
   max_rank=16)`` with three adapters of ranks 8, 16 and 16 over the
   four attention projections, the 8 requests on the base model (the
   two that share a prefix) and two on each adapter, in two tenants
   weighted 2:1; the LoRA engine and phase 3's depth-1 engine in turns,
   twice each: (a) base rows equal phase 3's tokens, (b) adapter rows
   equal a fresh 1-slot engine over ``merged_adapter`` weights up to the
   first non-decisive position, (c) phase 3's launch formula, (d)
   ``serving.lora.gathers`` equals the dispatches that carried an adapter
   row, (e) a clean store audit and byte-equal slot rows after a
   demotion and swap-in, (f) the admission order of a CPU replay of the
   trace; tokens/s, TTFT, the decode step against busy and the idle
   share, the delta's device ms per step by group, the lora-on graph's
   capture ms, each swap-in's ms and GB/s, peak memory; then one engine
   with int8 KV, int8 weights, ``async_depth=2`` and a ``ModelDrafter``
   holding a greedy spec adapter row and a sampled adapter row;
3l. quantization at the same width, on phase 3's model after its last
   use (``phase_quantization``): an ``LLMPredictor(weight_dtype="int8")``
   session (8 rows, prompt 512, 64 new tokens), then
   ``weight_only_quantize`` in place (``lm_head`` kept bf16: 224
   ``QuantizedLinearInfer`` layers) and the converted model's session
   with ``FLAGS_use_int8_matmul_kernel`` off (dequantize + cuBLAS, no
   kernel launch) and on (the quantized matmul, 224 a forward): tokens
   against the int8-plan session and each other (flag off within
   ``QUANT_ROUTE_ULPS`` bf16 ulps of flag on, teacher-forced), tokens/s,
   the block step against busy and the idle share, each arm's kernel
   split, the flag-off dequantize's and GEMMs' rates, peak memory, the
   memory the conversion freed;
3k. GPT-3 13B at full width, 6 of its 40 layers (hidden 5120, 40 heads
   of D = 128, ffn 20480, vocab 50304; bf16 random weights from
   ``--seed``; the depth cut for the smoke's time, ROADMAP.md),
   after the 8B model is freed, through phase 3's engine geometry and
   trace (``phase_gpt_serving``): (a) the lockstep and the default arm
   in turns, twice each, equal tokens, the paged decode exactly L a
   decode step and no other kernel; (b) int8 KV with int8, then int4,
   weights, the quantized matmul (its bias epilogue) exactly 4L a
   forward and the int8 decode L a step; (c) ``spec_decode=4`` with a
   ``ModelDrafter`` over a 2-layer GPT of the same width, the K-wide
   verify L a verify, the dense decode and the flash forward 2 a
   drafter step and prefill; (d) greedy ``generate()`` at B=8 and an
   8-row ``LLMPredictor`` as captured graphs, bit-equal to their eager
   programs; tokens/s, TTFT, decode step, busy, idle share, verify
   step, acceptance, capture ms and peak memory;
4. exactness: a 4-layer float32 model at the same width serves a mixed
   trace through a 2-slot engine, and every request must be token-exact
   against the same trace through the lockstep arm and against the same
   request alone on a fresh 1-slot engine; then the same with an int8 KV
   cache and int8 weights;
4b. quantized card-vs-CPU agreement: a 1-layer float32 model at the same
   width with an int8 KV cache and int4 weights, on the card and on the
   CPU from the same state dict: identical weight plans, and the logits
   of every teacher-forced step and the greedy tokens agree within
   stated bounds;
4c. speculative exactness: the 4-layer float32 model of phase 4 through
   2-slot spec engines, a ``ModelDrafter`` over the target and over a
   2-layer model, float and int8 KV cache: tokens equal to the non-spec
   engine's up to each request's first position whose teacher-forced
   top-2 margin is <= 0.01, 1-slot and 2-slot spec engines equal there,
   greedy ``generate()`` equal to a 1-slot engine there, acceptance 1.0
   with the target as drafter where every position is decisive, and no
   block in use after the drain;
4d. preemption exactness: the 4-layer float32 model of phase 4, token
   for token: a 2-slot trace whose priority-1 arrival preempts, against
   each request alone; ``_preempt`` forced mid-prefill and mid-decode
   against the uninterrupted run; a radix engine that demotes and
   promotes against ``prefix_cache_mode="none"``; the first and third
   with an int8 KV cache; a ``ModelDrafter`` spec row preempted and
   resumed against the uninterrupted run; each with its kernels
   launched;
4f. sampled exactness: a 1-layer float32 model at 8B width serves a
   sampled mix on the card and, from the same state dict, on the CPU:
   tokens equal up to each request's first position whose CPU top-two
   decisive margin is <= 0.01; then ``generate(do_sample=True)`` on the
   card against the CPU under the same rule;
4h. dense exactness: phase 4's 4-layer float32 model on the card and,
   from the same state dict, on the CPU: greedy ``generate()`` and an
   ``LLMPredictor`` session equal up to each row's first position whose
   CPU teacher-forced top-two margin is <= 0.01; beam ``generate()`` (K=4,
   B=8) equal on every row whose CPU run keeps each K-th / (K+1)-th
   candidate gap and its pick's best-vs-second gap above
   ``BEAM_MARGIN`` (1e-3), at least one row such;
4j. LoRA exactness: phase 4's model (at ``EXACT_CPU_LAYERS``, 1 layer)
   on the card and, from the same
   state dict, on the CPU serves the CPU test's LoRA trace (two
   concurrent adapters, a base row in the same dispatches, a demotion and
   swap-in, slot reuse with a changed adapter, a spec row): tokens equal
   up to each row's first position whose CPU teacher-forced top-2
   margin is <= 0.01, the ``stats()`` LoRA and tenant keys, the swap-ins
   and every arena row equal;
4k. GPT exactness (``phase_gpt_exactness``): a 4-layer float32 GPT
   (hidden 512, 8 heads of D = 64, vocab 1024) on the card and, from the
   same state dict, on the CPU: a 2-slot mixed trace equal to each
   request alone on a 1-slot engine in float32 and with int8 KV + int8
   weights; a spec engine and the CPU's engine equal to the card's
   non-spec tokens up to each request's first non-decisive position;
4l. quantization exactness (``phase_quant_exactness_layers``): (a) a
   2-layer float32 model at 8B width after ``weight_only_quantize`` on
   the card and on the CPU: codes bit-equal, the card's 16 greedy
   ``generate()`` tokens against the CPU's teacher-forced logits under
   both values of ``FLAGS_use_int8_matmul_kernel``, and one session
   toggled between them equal to ``generate()``; (b)
   ``Sequential(Linear, GELU, Linear, ReLU, Linear)`` at 4096/16384
   widths, M=256, after
   ``fuse_act_into_quant_linear``: the kernel's bias+act epilogues
   against their plain versions in bf16 and float32; (c) a small conv
   net through PTQ and QAT: the converted layers card against CPU;
5. training at the full width of ``examples/llama_pretrain.py`` ("1.1B":
   16 layers, hidden 2048, 32/8 heads, vocab 32000, bfloat16 parameters,
   full recompute): ``TrainStep`` with AdamW (fp32 moments) and
   global-norm clipping, batch 8 x 2048 tokens, 1 warm-up step and 5
   timed steps on the same batch; losses finite and falling, parameters
   finite, launch counters up by exactly their per-step counts; step
   time, tokens/s, MFU and peak memory, then one profiled step;
5b. training with the flag-selected routes: the same model with
   ``FLAGS_flash_onepass_bwd=False`` (the two-pass backward) and
   ``FLAGS_use_fused_adamw_kernel=True``, AdamW with bf16 moments by
   stochastic rounding (``multi_precision=False``) under a linear
   warm-up over cosine decay, and gradient merge over 2 calls: 6 calls
   (3 updates) with exact launch counts per call (the fused update once
   per parameter tensor on a firing call, never on a holding one),
   losses finite and falling, parameters finite, call times, tokens/s,
   MFU, peak memory and one profiled firing call;
5c. remat policies and the fused loss: the model of phase 5 under
   ``full``, ``save_attn``, ``save_attn_mlp`` on every second layer
   (``save_attn`` on the rest), ``dots``, the fused linear loss, and
   ``full`` again, each from the same state dict, 1 warm-up and 3 timed
   steps with exact launch counts (the flash forward once a layer under
   a policy that keeps its outputs, twice otherwise); the policy arms'
   first loss bit-equal to full's, later losses within one bf16 ulp,
   the fused loss's within 1e-2; step time, tokens/s, MFU and peak
   memory per arm;
5d. the twin of ``examples/llama_pretrain.py`` at its defaults with
   ``--steps 2``, then eager loops (``loss.backward(); opt.step();
   opt.clear_grad()``) at the same width: bf16 with
   AdamW(multi_precision=True), fp32 under ``auto_cast("O1")`` with a
   ``GradScaler`` plus one injected inf step that must skip the update
   and halve the scale, and O2 through ``decorate``; 3 steps each with
   exact launch counts, losses finite and falling;
6. training exactness: a 2-layer float32 model at the same width takes 2
   train steps on the card and, from the same state dict, on the CPU
   (plain versions); losses and parameters agree within stated bounds;
6b. the same under the routes of 5b, with Adam (the unfused update) and
   then AdamW under a schedule (the fused kernel on the card, its plain
   version on the CPU), at 1 layer (``TRAIN_EXACT_CUT_LAYERS``);
6c. phase 6's model under each remat policy of 5c on the card against
   phase 6's CPU run (a policy changes no value on the CPU), the fused
   loss against its own CPU run at 1 layer; every eager optimizer over a
   layer's parameter shapes, AMP O1's loss and gradients at 1 layer, and
   dropout masks
   (``F.dropout``, the SDPA probabilities' mask: bit-equal), card
   against CPU;
5k. GPT-2 small pretraining at full width (``phase_gpt_training``; 12
   layers, 12 heads of D = 64, vocab 50304, bf16, batch 8 x 1024, AdamW
   under ``TrainStep``, 1 + 3 steps an arm): attention dropout 0, the
   flash forward and one-pass backward exactly 12 a step each; the
   published dropouts, no flash launch (the masked math with threefry
   masks); step time, tokens/s, MFU and peak memory;
5e. ERNIE-base fine-tuning at full width (``phase_ernie_finetune``;
   2-class head, batch 32 x 128 with pad tails, AdamW at 5e-5 under
   ``amp.auto_cast`` O1 bf16, 1 + 3 steps): finite losses, no kernel
   launched (the pad mask keeps attention on the math path);
6k. 5k (no attention dropout) and 5e at 2 layers, float32, 3 steps on
   the card against the CPU (``phase_zoo_train_exactness``);
7a. ResNet-50 training (BASELINE config 1 at ``bench.py``'s shape:
   ``resnet50(num_classes=1000)`` in bf16, buffers too, Momentum 0.1 /
   0.9 under ``TrainStep``, B=128 of 3x224x224 from ``--seed``), NCHW
   and NHWC arms in turns (``phase_vision_training``): step ms,
   images/s, peak memory, conv MFU (3 x the forward's conv and matmul
   FLOPs from the layer shapes, at 989 TFLOP/s), device busy and idle
   share and busy time by kernel group from one profiled step, the
   Momentum update profiled alone, and the eval forward's images/s;
   losses finite, the batch-norm buffers moved and finite;
7b. PP-OCR inference (BASELINE config 4: ``PPOCRSystem(DBNet(),
   CRNN())`` at their default configs, bf16, eval;
   ``phase_ocr_inference``): detection on 8x3x640x640 and
   ``db_postprocess`` on the host, recognition on ``bench.py``'s
   512x3x32x320 and ``ctc_greedy_decode``: ms and images/s per stage,
   each stage's parts timed alone (backbone, neck, head; convolutions,
   LSTM, classifier), device busy and idle share;
7c. OCR training (``phase_ocr_training``): CRNN + ``CTCHeadLoss`` on
   64x3x32x320 and DBNet + ``DBLoss`` on 4x3x640x640 with synthetic
   maps, bf16, Adam under ``TrainStep`` on a repeated batch, 1 + 4 steps
   each: step ms; losses finite and falling; no port kernel launched
   (Adam takes the unfused update);
7d. vision card against CPU, float32 (``phase_vision_exactness``):
   ResNet-18 and ResNet-50 at 2x3x64x64 in NCHW and NHWC (eval and
   train forwards, the buffers after them), DBNet at scale 0.25 / 32
   FPN channels, CRNN with 12 classes / hidden 16 (its CTC loss and
   gradients), 2 ``TrainStep`` calls of ResNet-18 with Momentum; cuDNN's
   TF32 left on for the caller, so the port's own scoping of float32
   convolutions and LSTMs is what holds the tolerances.
7e. the hapi surface, BASELINE config 1's user surface
   (``phase_hapi``): (a) ``examples.resnet_cifar`` with ``--arch
   resnet50 --epochs 1 --batch-size 128`` on its synthetic data; (b)
   ``Model.fit`` of ResNet-50 (10 classes) float32 with Adam over
   ``Cifar10(size=10000)`` (10000 of CIFAR-10's 50000 training images,
   cut for the smoke's time, ROADMAP.md), B=128, one epoch without
   shuffling, and ``evaluate`` on ``size=10000``: ms a step and
   images/s unprofiled, the host split of a step (loader wait,
   ``train_batch``, the metric update and its read, ``float(loss)``),
   peak memory, eval images/s, device busy, idle share and launches a
   step from a profiled 10-step ``fit``, and ``fit``'s cost over a bare
   ``TrainStep`` loop on the same batches (six pairs of 15-step runs,
   the order alternating; resolved only where every pair agrees on the
   sign); (c) 20 iterations under O1;
   (d) 20 with ``num_workers=2`` (thread mode: CUDA is live); (e) a
   float32 LeNet ``fit`` on synthetic MNIST, card against CPU from one
   state (per-step losses within 1e-4 of the largest); (f) ``save`` /
   ``load`` bit-equal; (g) O2's ``TypeError`` on a float32 batch; no port
   kernel launched (``launches_by_path["hapi"]``, asserted);
7f. the vision ops and ``F.rms_norm``, card against CPU
   (``phase_vision_ops``): ``roi_align``/``roi_pool`` (64 RoIs on
   2x256x50x68), ``deform_conv2d`` v1 and v2 (2x64x32x32, 64 filters),
   ``box_coder`` both ways, values and input gradients within 1e-4 of
   the largest entry; ``prior_box``, ``nms`` and ``matrix_nms`` equal;
   ``F.rms_norm`` with a weight (the kernel, against ``rms_norm_plain``)
   and without, float32 within 1e-5 of the largest entry, bf16 within
   one bf16 ulp of each entry: its launches are the calls made
   with a weight (``launches_by_path["functional"]``, asserted).
8a. jit and the Predictor (``phase_jit``), the deployment path
   ``jit.save`` -> ``inference.Config``/``create_predictor`` ->
   ``Predictor.run`` (one captured CUDA graph per input signature): (a) 4
   of Llama-3-8B's 32 layers at full width (cut for the smoke's time,
   ROADMAP.md), bf16, saved at ``InputSpec([4,
   512], int64)``, run through the handles, the list form and a clone
   (weights shared): logits bit-equal to the eager forward on the card,
   launches a run RMSNorm 2L+1, RoPE 2L, flash forward L; export, write
   and load times, bytes, the first run (capture), replay ms against the
   eager forward's, peak memory; (b) the same model converted in place by
   ``weight_only_quantize`` (``lm_head`` float) and saved under
   ``FLAGS_use_int8_matmul_kernel``: bit-equal to the eager converted
   forward, 7L quantized-matmul launches a run; (c) a 2-layer model at 8B
   width exported on the CPU and served on the card through the kernels,
   and two clones under ``enable_memory_optim`` staging different feeds
   before either runs, each with its own feed's logits;
   (d) ``examples.resnet_cifar --arch resnet50 --epochs 0 --batch-size
   128 --export``, its Predictor at B=128 3x32x32 float32 against
   ``Model.predict_batch`` within 1e-5 of the largest entry with TF32 on
   for the caller, no port kernel launched; (e) ``to_static`` forward and
   backward of an MLP, a converted tensor ``while`` exported
   (``while_loop``) and run on the card, and a static ``Program`` trained
   3 steps with ``SGD.minimize`` on the card, then a step each by a CPU
   Executor and the card's on the same host parameters (which stay on the
   host), against 5 CPU steps within 1e-5; each
   artifact is deleted after it is loaded (``launches_by_path["jit"]``:
   the Predictor runs of (a)-(c)).
8b. a decoder written against the reference API (``phase_nn_api``,
   ``api_decoder_class``): an ``nn.Layer`` of ``create_parameter``
   weights (``ParamAttr(initializer=Normal(0, 0.02))``) over
   ``fused_rms_norm``, ``fused_linear``, ``fused_rotary_position_embedding``
   (rotate-half, base 500000), ``memory_efficient_attention`` and
   ``swiglu``, decoding one token through ``masked_multihead_attention``
   with the 8 kv heads repeated to 32, at Llama-3-8B width, 2 layers,
   bf16: (a) built under ``LazyGuard`` (every parameter in host RAM, the
   card's ``memory_allocated()`` unchanged), placed on the card by its
   first forward; (b) prefill B=2 S=512: logits finite, RMSNorm 2L+1 and
   flash forward L launches a prefill; (c) ``flash_attn_unpadded`` over
   layer 0's q/k/v packed in lengths (512, 384, 200, 1, 0), each
   sequence's rows against the flash kernel alone (bf16, 2^-5 of the row
   RMS), float32 card vs CPU within 1e-5; (d) ``BeamSearchDecoder(
   beam_size=4)`` and ``dynamic_decode(max_step_num=31)`` from the
   prefill's caches (max_seq 1024): ms a step, RMSNorm 2L+1 a step,
   ``beam_size=1`` equal to a greedy argmax loop, and
   ``masked_multihead_attention`` alone against its byte bound; (e) the
   decoder at 1 layer in float32 (TF32 off), built once on the host and
   carried to the card by ``set_state_dict``: prefill logits within 1e-4
   of the largest, beam tokens and parents equal and scores within 1e-4
   up to each row's first non-decisive step; (f) ``sparse_attention``,
   ``one_hot`` and ``embedding`` (``padding_idx``, ids outside [0, V):
   NaN rows, no device assert), card vs CPU (``launches_by_path[
   "nn_api"]``: (a), (b) and (d)).
8c. a decoder written against the top-level tensor API (``phase_tensor_api``,
   ``tensor_decoder_class``): facade calls only (``normal``, ``matmul``,
   ``reshape``, ``transpose``, ``split``, ``concat``, ``stack``,
   ``multiply``, ``add``, ``sin``/``cos``, indexing, the operators),
   ``_C_ops.rms_norm`` and ``_C_ops.flash_attention(causal=True)`` and a
   user ``PyLayer`` SwiGLU with a hand-written backward, at Llama-3-8B
   width (hidden 4096, 32/8 heads of D 128, FFN 14336, rotate-half RoPE
   base 500000), 2 layers, bf16: (a) 436 M weights drawn on the card by
   the facade's threefry ``normal``, one tensor at a time; (b) forward at
   B=2 S=1024, loss finite, RMSNorm 2L+1 and flash forward L launches;
   (c) ``loss.backward()`` with flash backward L launches and every
   ``.grad`` finite, a second backward accumulating to twice the first,
   ``grad(loss, [h0])`` equal to the ``.grad`` route, the ``PyLayer``'s
   gradients equal to autograd through the same ops in float32; (d) the
   decoder at 1 layer in float32 (TF32 off), B=1 S=64, held on the host
   (its weights drawn on the card: threefry on the host's cores would
   take tens of seconds) and carried to the card by
   ``to_tensor(place=)``: the loss and each gradient within 1e-4 of its
   own largest entry; (e) every registry op at the CPU sweep's inputs
   (``sweep_inputs``; the two flash ops at head_dim 64, the kernels'),
   card vs CPU in float32, forward and gradient, threefry draws
   bit-equal; (f) the host time to enqueue (b)'s forward on facade
   tensors, on plain ones through the same facade functions, and written
   with raw torch calls and the kernel wrappers, launches equal
   (``launches_by_path["tensor_api"]``: (b) and (c)).

The line before the last is a JSON object of per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,     # dense tensor-core bf16
            "float32": 67e12}       # float32 outside the tensor cores
TOL = {"float32": (1e-4, 0.0),      # (atol, rtol)
       "bfloat16": (2e-2, 2.0 ** -7)}   # rtol: one bf16 ulp of the value


def _log(msg=""):
    print(msg, flush=True)


def _bound(nbytes, nops, dtype):
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = nops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# device cycles of the spin that holds the device busy ahead of a timed
# run with no flush: about 100 us at the H100's 1.7-2.0 GHz clock
HOLD_CYCLES = 200_000


def _time_ms(torch, fn, flush=None, warmup=5, iters=25):
    """Median CUDA-event time of ``fn`` in ms over ``iters`` runs after
    ``warmup``; ``flush`` (if given) runs between timed launches, outside
    the events, so the launch finds the L2 cache cold.  Host time stays
    out of the window: each timed run is enqueued behind device work (the
    flush, about 80 us, or else a spin of ``HOLD_CYCLES``), so the device
    is still busy while the host records the start event and runs the
    wrapper, and the events time the device alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        else:
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _check(torch, name, got, want, dtype, row_atol=None, rtol=None,
           tol=None):
    """Max |got - want|, after asserting every element within ``atol +
    rtol * |want|``: ``tol`` or ``TOL[dtype]``, or, where ``row_atol`` is
    given, an atol of ``row_atol`` times the RMS over the last axis of
    ``want``'s row, and ``rtol``.  Logs the largest share of the limit any
    element used."""
    atol, rt = tol or TOL[dtype]
    if row_atol is not None:
        w = want.float()
        atol, rt = row_atol * w.square().mean(-1, keepdim=True).sqrt(), rtol
        how = f"atol {row_atol:.3g} x row RMS"
    else:
        how = f"atol {atol:.3g}"
    err, share = _within(torch, name, got, want, atol, rt, how)
    _log(f"  {name}: max |err| {err:.3g}, {share:.3f} of the limit ({how}, "
         f"rtol {rt:.3g})")
    return err


def _within(torch, name, got, want, atol, rtol, how=None):
    """Assert every element of ``got`` finite and within ``atol + rtol *
    |want|`` of ``want``; returns (max |err|, the largest share of the
    limit any element used)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (g - w).abs()
    limit = atol + rtol * w.abs()
    bad = err > limit
    if bad.any():
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max |err| {err.max().item():.3g}, {int(bad.sum())} elements "
            f"past {how or f'atol {atol:.3g}'} rtol {rtol:.3g})")
    return (err.max().item(),
            torch.where(err == 0, 0.0, err / limit).max().item())


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _log(smi)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} "
         f"count {torch.cuda.device_count()}")
    from paddle_tpu_torch import ops
    t0 = time.perf_counter()
    reports = ops.build_all()
    _log(f"kernel build: {time.perf_counter() - t0:.3f} s for "
         f"{sorted(reports)}")
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  ptxas {name}: {line.strip()}")
    return smi


def _rms_case(torch, rows, dtype, gen, d=4096):
    from paddle_tpu_torch.ops import rms_norm as rn
    dt = getattr(torch, dtype)
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dt)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dt)
    eps = 1e-5
    got = rn.rms_norm(x, w, eps)
    want = rn.rms_norm_plain(x, w, eps)
    torch.cuda.synchronize()
    err = _check(torch, f"rms_norm [{rows},{d}] {dtype}", got, want, dtype)
    item = x.element_size()
    bound_ms, by = _bound((2 * rows * d + d) * item, 4 * rows * d, dtype)
    ms = _time_ms(torch, lambda: rn.rms_norm(x, w, eps))
    plain_ms = _time_ms(torch, lambda: rn.rms_norm_plain(x, w, eps))
    lib_ms = _time_ms(torch, lambda: torch.nn.functional.rms_norm(
        x, (d,), w, eps))
    return dict(shape=f"[{rows},{d}]", dtype=dtype, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms)


# bf16 copies timed beside the streaming kernels (``_copy_floor``)
COPY_FLOORS = [((8, 2048, 32, 64), "RoPE on the training q"),
               ((16384, 2048), "RMSNorm on the training rows")]

# RMSNorm row widths whose row bits phase 2 holds alone and inside batches:
# the 8B model's (serving) and the 1.1B model's (training)
RMS_ROW_WIDTHS = (4096, 2048)


def _rms_rows_case(torch, dtype, d, gen):
    """A row's RMSNorm output bits depend on d and the dtype alone: rows
    0, 3 and 7 normalised alone equal the same rows inside an N = 8 and
    an N = 256 batch, bit for bit."""
    from paddle_tpu_torch.ops import rms_norm as rn
    dt = getattr(torch, dtype)
    x = torch.randn(256, d, generator=gen, device="cuda").to(dt)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dt)
    n256, n8 = rn.rms_norm(x, w, 1e-5), rn.rms_norm(x[:8], w, 1e-5)
    for r in (0, 3, 7):
        alone = rn.rms_norm(x[r:r + 1], w, 1e-5)
        _same(torch, f"rms_norm [{r}/{d}] {dtype}", alone, n8[r:r + 1],
              "alone vs N=8")
        _same(torch, f"rms_norm [{r}/{d}] {dtype}", alone, n256[r:r + 1],
              "alone vs N=256")
    torch.cuda.synchronize()
    _log(f"  rms_norm d={d} {dtype}: rows 0, 3, 7 bit-equal alone, at N=8 "
         f"and at N=256")


def _device_us(torch, fn, n=50):
    """Device time of one call of ``fn`` from ``torch.profiler``: the
    CUDA kernel durations of ``n`` calls summed (a kernel's recorded
    duration holds no host time), over the kernels recorded, in
    microseconds, and the kernels recorded a call.  (None, 0) where the
    profiler records no kernel."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per_kernel, count = _profile_kernels(torch, prof)
    launches = sum(count.values())
    if not launches:
        return None, 0
    return sum(per_kernel.values()) / launches, launches / n


# RMSNorm against F.rms_norm in device time: one decode step's rows and the
# training step's (batch x seq rows of the 1.1B width), bfloat16
RMS_TURN_SHAPES = [(8, 4096), (16384, 2048)]
# turns of host timing (kernel, library) whose least and mean are kept: the
# host is shared, so the least is the wrapper's own cost
RMS_HOST_TURNS = 5


def _rms_turns(torch, rows, d, gen):
    """The RMSNorm kernel and ``F.rms_norm`` (one PyTorch call computing
    the same function) in turns, kernel, library, kernel, library, each
    timed by ``_time_ms`` (device only), then each one's device time per
    launch from the profiler's kernel durations, host time per call
    (``_host_us``, ``RMS_HOST_TURNS`` turns) and the launch floor.
    Returns the row of numbers."""
    from paddle_tpu_torch.ops import rms_norm as rn
    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()

    def kern():
        return rn.rms_norm(x, w, 1e-5)

    def lib():
        return torch.nn.functional.rms_norm(x, (d,), w, 1e-5)

    turns = []
    for _ in range(2):
        turns += [_time_ms(torch, kern), _time_ms(torch, lib)]
    (k_us, k_n), (l_us, l_n) = _device_us(torch, kern), _device_us(torch,
                                                                  lib)
    host = []
    for _ in range(RMS_HOST_TURNS):
        host += [_host_us(torch, kern), _host_us(torch, lib)]
    row = dict(shape=f"[{rows},{d}]", kernel_ms=turns[0::2],
               library_ms=turns[1::2], kernel_us_profiled=k_us,
               library_us_profiled=l_us,
               kernel_host_us=min(host[0::2]),
               library_host_us=min(host[1::2]),
               kernel_host_mean_us=statistics.mean(host[0::2]),
               library_host_mean_us=statistics.mean(host[1::2]),
               floor_ms=_time_ms(torch, lambda: torch.cuda._sleep(0)))
    factor = statistics.mean(row["kernel_ms"]) \
        / statistics.mean(row["library_ms"])
    prof = ("not measured" if k_us is None or l_us is None else
            f"{k_us:.2f} us against {l_us:.2f} us ({k_n:.2f} and "
            f"{l_n:.2f} kernels recorded a call)")
    _log(f"rms_norm turns {row['shape']} bfloat16: kernel "
         f"{' / '.join(f'{t:.4f}' for t in row['kernel_ms'])} ms, "
         f"F.rms_norm {' / '.join(f'{t:.4f}' for t in row['library_ms'])} "
         f"ms (kernel / library {factor:.3f}); profiled per launch {prof}; "
         f"host per call {row['kernel_host_us']:.1f} us against "
         f"{row['library_host_us']:.1f} us (least of {RMS_HOST_TURNS} turns "
         f"each; mean {row['kernel_host_mean_us']:.1f} against "
         f"{row['library_host_mean_us']:.1f}); launch "
         f"floor (torch.cuda._sleep(0) under _time_ms) "
         f"{row['floor_ms']:.4f} ms")
    return row


def _copy_floor(torch, shape, gen, what):
    """The device time of torch's own copy of a bf16 tensor of ``shape``
    into another (``Tensor.copy_``, timed by ``_time_ms``): it reads and
    writes the bytes that a streaming kernel of that shape must move, so
    it is the rate this card streams them at, beside the data sheet's
    3.35 TB/s."""
    a = torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    b_ = torch.empty_like(a)
    ms = _time_ms(torch, lambda: b_.copy_(a))
    nbytes = 2 * a.numel() * a.element_size()
    _log(f"copy floor {list(shape)} bfloat16 ({what}): torch copy_ "
         f"{ms:.4f} ms = {nbytes / ms / 1e9:.3f} TB/s; byte bound "
         f"{nbytes / H100_BYTES_PER_S * 1e3:.4f} ms")


def _read_flush(torch):
    """An L2 flush that leaves the cache clean: one read of 256 MB (the
    50 MB L2 holds none of the operands afterwards, and, unlike a write,
    no dirty lines whose write-back would share the timed kernel's
    memory bandwidth).  Returns (buffer, flush)."""
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    return scratch, lambda: scratch.max()


def _paged_tables(np, rng, lens, blk_len, mb):
    """Per-row tables of distinct random blocks (trash-padded past each
    row's need) for the decode cases; returns (tables, blocks needed, NB)."""
    need = [min(int(n) // blk_len + 1, mb) for n in lens]
    nb = sum(need) + 8
    perm = rng.permutation(nb)
    tables = np.full((len(lens), mb), nb, np.int32)
    used = 0
    for i, k in enumerate(need):
        tables[i, :k] = perm[used:used + k]
        used += k
    return tables, need, nb


def _same(torch, name, a, b_, what):
    """A row's output must not change with the batch it rides in."""
    if not torch.equal(a, b_):
        raise AssertionError(f"{name}: a row's output changed with the "
                             f"batch it rode in ({what})")


def _decode_case(torch, dtype, gen, rng, geom=(8, 4, 128)):
    """B=8 rows, (Hkv, G, D) = ``geom`` (8, 4, 128: Llama-3-8B; GPT's
    multi-head geometries have G = 1), L=16, 128-block tables: ragged lens
    up to 2047 (a full table), mid-block frontiers, trash-padded
    tables and a random (finite) trash row.  Each row of the B=8 launch
    must be bit-equal to the same row launched alone and beside an
    all-trash row (a vacant slot; lens far past its table).  Timed with
    the L2 flushed by a read, beside the host time of one call."""
    import numpy as np
    from paddle_tpu_torch.ops import decode_attention as da
    (hkv, g, d), b, blk_len, mb = geom, 8, 16, 128
    lens = np.array([2047, 1500, 1023, 700, 383, 100, 17, 0], np.int32)
    tables, need, nb = _paged_tables(np, rng, lens, blk_len, mb)
    dt = getattr(torch, dtype)
    shape = da.paged_arena_shape(nb + 1, hkv, blk_len, d)
    ka = torch.randn(shape, generator=gen, device="cuda").to(dt)
    va = torch.randn(shape, generator=gen, device="cuda").to(dt)
    q = torch.randn(b, hkv * g, d, generator=gen, device="cuda").to(dt)
    tb = torch.from_numpy(tables).cuda()
    ln = torch.from_numpy(lens).cuda()
    name = f"paged_decode_attention Hkv={hkv} G={g} D={d} {dtype}"
    got = da.decode_attention_paged(q, ka, va, tb, ln)
    want = da.decode_attention_paged_plain(q, ka, va, tb, ln)
    torch.cuda.synchronize()
    err = _check(torch, name, got, want, dtype)
    trash = torch.full_like(tb[:1], nb)
    for i in range(b):
        alone = da.decode_attention_paged(q[i:i + 1], ka, va, tb[i:i + 1],
                                          ln[i:i + 1])
        pair_ln = torch.tensor([int(lens[i]), 1234], dtype=torch.int32,
                               device="cuda")
        pair = da.decode_attention_paged(q[[i, (i + 1) % b]], ka, va,
                                         torch.cat([tb[i:i + 1], trash]),
                                         pair_ln)
        _same(torch, name, alone[0], got[i], f"row {i} alone")
        _same(torch, name, pair[0], got[i], f"row {i} beside an all-trash "
                                            f"row")
        if not torch.isfinite(pair[1]).all():
            raise AssertionError(f"{name}: an all-trash row is not finite")
    _log(f"  {name}: each of the {b} rows bit-equal alone and beside an "
         f"all-trash row")
    item = q.element_size()
    slots = int((lens.astype(np.int64) + 1).sum())
    nbytes = (slots * 2 * hkv * d * item          # valid K and V
              + 2 * q.numel() * item              # q in, out
              + sum(need) * 4 + b * 4)            # table entries, lens
    bound_ms, by = _bound(nbytes, 4 * slots * hkv * g * d, dtype)
    scratch, flush = _read_flush(torch)
    ms = _time_ms(torch, lambda: da.decode_attention_paged(q, ka, va, tb, ln),
                  flush)
    host_us = _host_us(torch, lambda: da.decode_attention_paged(
        q, ka, va, tb, ln))
    plain_ms = _time_ms(
        torch, lambda: da.decode_attention_paged_plain(q, ka, va, tb, ln),
        flush)
    # library yardstick: SDPA over the PRE-GATHERED dense view (the
    # gather is outside the timed call), kv heads repeated to Hq
    s = mb * blk_len
    kd = da.paged_gather_view(ka, tb).reshape(b, s, hkv, d)
    vd = da.paged_gather_view(va, tb).reshape(b, s, hkv, d)
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    mask = (torch.arange(s, device="cuda")[None, :]
            <= ln.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask)
    lib_err = (lib.reshape(b, -1).float() - want.float()).abs().max().item()
    lib_ms = _time_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask), flush)
    del scratch
    _log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
         f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms; host {host_us:.1f} us "
         f"a call")
    return dict(shape=f"B={b} Hkv={hkv} G={g} D={d} L={blk_len} "
                      f"max_blocks={mb} lens<={int(lens.max())}",
                dtype=dtype, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                library_max_abs_err=lib_err, host_us=host_us)


# int8 paged decode: float32 atol 1e-5 (the same fp32 math in another
# order, outputs below 1); bfloat16 as flash O, an atol of 2^-5 of the
# row's RMS over D plus one bf16 ulp (rtol 2^-7): the kernel rounds P to
# bf16 relative to the online softmax's running max (as the TPU kernel
# rounds it relative to its row max), the plain version rounds the
# normalized P, so each term of a row may differ by 2^-8 of itself.
DECODE_INT8_TOL = {"float32": dict(tol=(1e-5, 1e-5)),
                   "bfloat16": dict(row_atol=2.0 ** -5, rtol=2.0 ** -7)}
# quantized matmul: outputs of size ~1-3 summed over K <= 14336 exact fp32
# products in another order: float32 atol 1e-4 plus rtol 1e-5; bfloat16
# one ulp of the value (rtol 2^-7: both round an fp32 sum once) plus atol
# 1e-4 for values near zero
QMM_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-4, 2.0 ** -7)}
# the 8B projections (K, N) at decode (M = 8 slots), the gate/up
# projection at the 8B drafter's one slot (M = 1), at a verify forward (8
# slots x 5 queries) and at one prefill chunk (M = 256)
QMM_SHAPES = [(8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336),
              (8, 14336, 4096), (256, 4096, 14336), (1, 4096, 14336),
              (40, 4096, 14336)]
# a row's bits at every M: the rows of x[:M] for each M, and the epilogue
# forms (bias, act) the kernel fuses
QMM_ROW_MS = (1, 8, 40, 256)
QMM_FORMS = [(False, None), (True, None), (True, "silu"), (False, "relu"),
             (True, "gelu")]


def _decode_int8_case(torch, dtype, gen, rng, geom=(8, 4, 128)):
    """The serving shape of ``_decode_case`` (B=8, Hkv=8, G=4, D=128,
    L=16, 128-block tables, lens up to 2047, L2 flushed by a read) over
    an int8 cache: random float arenas quantized per entry per kv head
    (``quantize_kv_heads``), the trash row included.  Each row of the B=8
    launch must be bit-equal to the same row launched alone and beside an
    all-trash row, as in ``_decode_case``; the host time of one call
    beside."""
    import numpy as np
    from paddle_tpu_torch.models.generation import quantize_kv_heads
    from paddle_tpu_torch.ops import decode_attention as da
    (hkv, g, d), b, blk_len, mb = geom, 8, 16, 128
    lens = np.array([2047, 1500, 1023, 700, 383, 100, 17, 0], np.int32)
    tables, need, nb = _paged_tables(np, rng, lens, blk_len, mb)
    dt = getattr(torch, dtype)
    shape = da.paged_arena_shape(nb + 1, hkv, blk_len, d)
    planes = []
    for _ in range(2):
        f = torch.randn(nb + 1, blk_len, hkv, d, generator=gen, device="cuda")
        codes, sc = quantize_kv_heads(f)
        planes.append((codes.reshape(shape), sc))
    (kc, ks), (vc, vs) = planes
    q = torch.randn(b, hkv * g, d, generator=gen, device="cuda").to(dt)
    tb = torch.from_numpy(tables).cuda()
    ln = torch.from_numpy(lens).cuda()
    name = f"paged_decode_attention_int8 Hkv={hkv} G={g} D={d} {dtype}"
    got = da.decode_attention_paged(q, kc, vc, tb, ln, kv_scales=(ks, vs))
    want = da.decode_attention_paged_plain(q, kc, vc, tb, ln,
                                           kv_scales=(ks, vs))
    torch.cuda.synchronize()
    err = _check(torch, name, got, want, dtype, **DECODE_INT8_TOL[dtype])
    trash = torch.full_like(tb[:1], nb)
    for i in range(b):
        alone = da.decode_attention_paged(q[i:i + 1], kc, vc, tb[i:i + 1],
                                          ln[i:i + 1], kv_scales=(ks, vs))
        pair_ln = torch.tensor([int(lens[i]), 1234], dtype=torch.int32,
                               device="cuda")
        pair = da.decode_attention_paged(q[[i, (i + 1) % b]], kc, vc,
                                         torch.cat([tb[i:i + 1], trash]),
                                         pair_ln, kv_scales=(ks, vs))
        _same(torch, name, alone[0], got[i], f"row {i} alone")
        _same(torch, name, pair[0], got[i], f"row {i} beside an all-trash "
                                            f"row")
        if not torch.isfinite(pair[1]).all():
            raise AssertionError(f"{name}: an all-trash row is not finite")
    _log(f"  {name}: each of the {b} rows bit-equal alone and beside an "
         f"all-trash row")
    item = q.element_size()
    slots = int((lens.astype(np.int64) + 1).sum())
    nbytes = (slots * 2 * hkv * (d + 4)           # valid codes and scales
              + 2 * q.numel() * item              # q in, out
              + sum(need) * 4 + b * 4)            # table entries, lens
    bound_ms, by = _bound(nbytes, 4 * slots * hkv * g * d, dtype)
    scratch, flush = _read_flush(torch)
    ms = _time_ms(torch, lambda: da.decode_attention_paged(
        q, kc, vc, tb, ln, kv_scales=(ks, vs)), flush)
    host_us = _host_us(torch, lambda: da.decode_attention_paged(
        q, kc, vc, tb, ln, kv_scales=(ks, vs)))
    plain_ms = _time_ms(torch, lambda: da.decode_attention_paged_plain(
        q, kc, vc, tb, ln, kv_scales=(ks, vs)), flush)
    del scratch
    _log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
         f"{bound_ms:.4f} ms; host {host_us:.1f} us a call")
    return dict(shape=f"B={b} Hkv={hkv} G={g} D={d} L={blk_len} "
                      f"max_blocks={mb} lens<={int(lens.max())} int8 cache",
                dtype=dtype, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None,
                host_us=host_us)


# the speculative path of phase 3c: verify width C = spec_decode + 1, and
# the draft model's dense cache of max_context + max_draft slots
SPEC = dict(k=4, max_context=512)
MULTI_LENS = [2047 - (SPEC["k"] + 1), 1500, 1023, 700, 383, 100, 17, 0]


def _multi_timing(torch, q, ka, va, tb, ln, scales, lens, need, int8, flush):
    """The K-wide kernel, its plain version and (float cache) SDPA over
    the pre-gathered dense view, timed on one batch beside its bound.
    Returns (ms, plain_ms, bound_ms, bound_by, library_ms, library
    max_abs_err against the plain version)."""
    import numpy as np
    from paddle_tpu_torch.ops import decode_attention as da
    b, cq, hq, d = q.shape
    hkv = ka.shape[-1] // d
    g = hq // hkv
    blk_len, mb = ka.shape[1], tb.shape[1]
    dtype = str(q.dtype).split(".")[-1]
    item = q.element_size()
    slots = int((lens.astype(np.int64) + cq).sum())
    per_slot = 2 * hkv * ((d + 4) if int8 else d * item)
    nbytes = (slots * per_slot                    # staged K and V
              + 2 * q.numel() * item              # q in, out
              + sum(need) * 4 + b * 4)            # table entries, lens
    bound_ms, by = _bound(nbytes, 4 * slots * cq * hq * d, dtype)
    ms = _time_ms(torch, lambda: da.decode_attention_paged_multi(
        q, ka, va, tb, ln, scales), flush)
    plain_ms = _time_ms(torch, lambda: da.decode_attention_paged_multi_plain(
        q, ka, va, tb, ln, scales), flush)
    lib_ms = lib_err = None
    if not int8:
        # library yardstick: SDPA with an explicit causal boolean mask
        # over the PRE-GATHERED dense view, kv heads repeated to Hq
        s = mb * blk_len
        kd = da.paged_gather_view(ka, tb).reshape(b, s, hkv, d)
        vd = da.paged_gather_view(va, tb).reshape(b, s, hkv, d)
        kd = kd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
        vd = vd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
        pos = ln.long()[:, None] + torch.arange(cq, device="cuda")[None, :]
        mask = (torch.arange(s, device="cuda")[None, None, :]
                <= pos[:, :, None])[:, None]              # [B, 1, C, S]
        qt = q.transpose(1, 2)                            # [B, Hq, C, D]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        want = da.decode_attention_paged_multi_plain(q, ka, va, tb, ln,
                                                     scales)
        lib = sdpa(qt, kd, vd, attn_mask=mask).transpose(1, 2)
        lib_err = (lib.float() - want.float()).abs().max().item()
        lib_ms = _time_ms(torch, lambda: sdpa(qt, kd, vd, attn_mask=mask),
                          flush)
    return ms, plain_ms, bound_ms, by, lib_ms, lib_err


def _multi_case(torch, dtype, gen, rng, int8, geom=(8, 4, 128)):
    """The K-wide verify attention at the serving geometry of
    ``_decode_case`` with C = 5 queries per row (lens up to 2047 - C, so
    the last query reaches slot 2046 of a full table), float or int8
    cache, L2 flushed by a read.  Further launches hold each row to
    itself, bit for bit, whatever batch it rides in: a real row beside a
    row outside spec mode (all-trash table, n_valid 0, lens far past its
    blocks; finite, and equal to its plain version), the longest row
    alone (B=1, the 1-slot engine's shape), and a ragged pair, that row
    beside a short one (lens 3, one block), each equal to itself
    launched alone.  Timed at B=8 and at B=1.  Returns the two rows."""
    import numpy as np
    from paddle_tpu_torch.models.generation import quantize_kv_heads
    from paddle_tpu_torch.ops import decode_attention as da
    (hkv, g, d), b, cq, blk_len, mb = geom, 8, SPEC["k"] + 1, 16, 128
    lens = np.array(MULTI_LENS, np.int32)
    tables, need, nb = _paged_tables(np, rng, lens + cq - 1, blk_len, mb)
    dt = getattr(torch, dtype)
    shape = da.paged_arena_shape(nb + 1, hkv, blk_len, d)
    if int8:
        planes = []
        for _ in range(2):
            f = torch.randn(nb + 1, blk_len, hkv, d, generator=gen,
                            device="cuda")
            codes, sc = quantize_kv_heads(f)
            planes.append((codes.reshape(shape), sc))
        (ka, ks), (va, vs) = planes
        scales = (ks, vs)
    else:
        ka = torch.randn(shape, generator=gen, device="cuda").to(dt)
        va = torch.randn(shape, generator=gen, device="cuda").to(dt)
        scales = None
    q = torch.randn(b, cq, hkv * g, d, generator=gen, device="cuda").to(dt)
    tb = torch.from_numpy(tables).cuda()
    ln = torch.from_numpy(lens).cuda()
    name = "paged_decode_attention_multi" + ("_int8" if int8 else "") \
        + ("" if geom == (8, 4, 128) else f" Hkv={hkv} G={g} D={d}")
    tol = DECODE_INT8_TOL[dtype] if int8 else {}

    def run(rows, row_lens, what, tables=None):
        """The kernel on rows ``rows`` of q and tb (or ``tables``) at
        ``row_lens``, checked against its plain version."""
        qq, tt = q[rows], tb[rows] if tables is None else tables
        ll = torch.tensor(row_lens, dtype=torch.int32, device="cuda")
        got = da.decode_attention_paged_multi(qq, ka, va, tt, ll, scales)
        want = da.decode_attention_paged_multi_plain(qq, ka, va, tt, ll,
                                                     scales)
        torch.cuda.synchronize()
        return got, _check(torch, f"{name} {dtype}{what}", got, want, dtype,
                           **tol)

    def same(a, b_, what):
        _same(torch, f"{name} {dtype}", a, b_, what)

    got, err = run(list(range(b)), lens.tolist(), "")
    # a real row beside a row outside spec mode (all-trash table)
    got2, _ = run([1, 2], [int(lens[1]), 1234], " with an all-trash row",
                  torch.stack([tb[1], torch.full_like(tb[1], nb)]))
    same(got2[0], got[1], "beside an all-trash row")
    # the longest row alone, then beside a short row, which is itself
    # launched alone
    got1, _ = run([0], [int(lens[0])], " B=1")
    same(got1[0], got[0], "B=1 alone")
    got_pair, _ = run([0, 7], [int(lens[0]), 3], " ragged pair")
    got_short, _ = run([7], [3], " short row alone")
    same(got_pair[0], got[0], "ragged pair, long row")
    same(got_pair[1], got_short[0], "ragged pair, short row")
    scratch, flush = _read_flush(torch)
    rows = []
    for sel, tag in ((slice(None), ""), (slice(0, 1), " B=1")):
        ms, plain_ms, bound_ms, by, lib_ms, lib_err = _multi_timing(
            torch, q[sel], ka, va, tb[sel], ln[sel], scales, lens[sel],
            need[sel], int8, flush)
        row = dict(shape=f"B={q[sel].shape[0]} C={cq} Hkv={hkv} G={g} "
                         f"D={d} L={blk_len} max_blocks={mb} "
                         f"lens<={int(lens[sel].max())}"
                         + (" int8 cache" if int8 else ""),
                   dtype=dtype, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)
        if lib_err is not None:
            row["library_max_abs_err"] = lib_err
        rows.append(row)
        _log(f"  {name} {dtype}{tag}: kernel {ms:.4f} ms, plain "
             f"{plain_ms:.4f} ms, library "
             + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
             + f", bound {bound_ms:.4f} ms")
    del scratch
    return rows


def _dense_case(torch, dtype, gen, geom=(8, 4, 128)):
    """The dense decode attention of the draft model's ``generate()``:
    B=1, the 8B head geometry, S = max_context + max_draft of phase 3c's
    drafter (516, not a multiple of the kernel's 16-slot chunk), lens at
    the last decode step's frontier; the same row at B=3 (beside a row at
    lens 0 and one past S) must give the same bits; a launch with lens
    past S (clamped) and an odd S, against the plain version."""
    from paddle_tpu_torch.ops import decode_attention as da
    hkv, g, d = geom
    s = SPEC["max_context"] + SPEC["k"]
    dt = getattr(torch, dtype)
    shape = da.cache_shape(3, hkv, s, d)
    kc3 = torch.randn(shape, generator=gen, device="cuda").to(dt)
    vc3 = torch.randn(shape, generator=gen, device="cuda").to(dt)
    q3 = torch.randn(3, hkv * g, d, generator=gen, device="cuda").to(dt)
    kc, vc, q = kc3[1:2].contiguous(), vc3[1:2].contiguous(), q3[1:2]
    ln = torch.tensor([s - 2], dtype=torch.int32, device="cuda")
    name = f"decode_attention Hkv={hkv} G={g} D={d} {dtype}"
    got = da.decode_attention(q, kc, vc, ln)
    want = da.decode_attention_plain(q, kc, vc, ln)
    torch.cuda.synchronize()
    err = _check(torch, name, got, want, dtype)
    ln3 = torch.tensor([0, s - 2, s + 40], dtype=torch.int32, device="cuda")
    got3 = da.decode_attention(q3, kc3, vc3, ln3)
    _check(torch, f"{name} B=3", got3,
           da.decode_attention_plain(q3, kc3, vc3, ln3), dtype)
    _same(torch, name, got3[1], got[0], "B=1 against B=3")
    odd = s - 3
    q3 = torch.randn(3, hkv * g, d, generator=gen, device="cuda").to(dt)
    k3 = torch.randn(da.cache_shape(3, hkv, odd, d), generator=gen,
                     device="cuda").to(dt)
    v3 = torch.randn(k3.shape, generator=gen, device="cuda").to(dt)
    l3 = torch.tensor([0, odd - 1, odd + 40], dtype=torch.int32,
                      device="cuda")
    _check(torch, f"decode_attention {dtype} S={odd}",
           da.decode_attention(q3, k3, v3, l3),
           da.decode_attention_plain(q3, k3, v3, l3), dtype)
    item = q.element_size()
    slots = s - 1
    nbytes = slots * 2 * hkv * d * item + 2 * q.numel() * item + 4
    bound_ms, by = _bound(nbytes, 4 * slots * hkv * g * d, dtype)
    scratch, flush = _read_flush(torch)
    ms = _time_ms(torch, lambda: da.decode_attention(q, kc, vc, ln), flush)
    plain_ms = _time_ms(torch, lambda: da.decode_attention_plain(
        q, kc, vc, ln), flush)
    # library yardstick: SDPA over the dense cache with a boolean mask
    kt = kc.reshape(1, s, hkv, d).permute(0, 2, 1, 3) \
        .repeat_interleave(g, dim=1).contiguous()
    vt = vc.reshape(1, s, hkv, d).permute(0, 2, 1, 3) \
        .repeat_interleave(g, dim=1).contiguous()
    mask = (torch.arange(s, device="cuda") <= ln.long()[:, None])[:, None,
                                                                   None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(q4, kt, vt, attn_mask=mask)
    lib_err = (lib.reshape(1, -1).float() - want.float()).abs().max().item()
    lib_ms = _time_ms(torch, lambda: sdpa(q4, kt, vt, attn_mask=mask), flush)
    host_us = _host_us(torch, lambda: da.decode_attention(q, kc, vc, ln))
    del scratch
    _log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
         f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms; host {host_us:.1f} us "
         f"a call")
    return dict(shape=f"B=1 Hkv={hkv} G={g} D={d} S={s} lens={s - 2}",
                dtype=dtype, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                library_max_abs_err=lib_err, host_us=host_us)


def _qmm_case(torch, dtype, bits, m, k, n, gen, bias=False):
    """The quantized matmul on x [M, K] and codes of a random [K, N]
    weight (std 0.02) quantized per output channel by the serving rule.
    ``bound_ms`` uses the peak of x's dtype (bf16: the tensor cores the
    kernel runs on; float32: the CUDA cores).  ``library_ms`` is one
    ``torch.matmul`` in x's dtype on the pre-dequantized weight: the GEMM
    of the same shape, not the same function (it streams 2 or 4 bytes per
    weight, not 1 or 1/2).  Every timed call finds the L2 cold and clean
    (``_read_flush``), as a decode step finds each layer's weights.  With
    ``bias`` (GPT's projections) an f32 bias [N] of std 0.1 joins the
    epilogue, and the library call is ``torch.addmm`` with it."""
    from paddle_tpu_torch.ops import quantized_matmul as qm
    from paddle_tpu_torch.quantization import (absmax_to_scales,
                                               quantize_channelwise)
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
    w = 0.02 * torch.randn(k, n, generator=gen, device="cuda")
    scales = absmax_to_scales(w.abs().amax(0), bits)
    codes = quantize_channelwise(w, scales, bits)
    del w
    if bits == 4:
        codes = qm.pack_int4(codes)
    bvec = 0.1 * torch.randn(n, generator=gen, device="cuda") if bias \
        else None
    got = qm.quantized_matmul(x, codes, scales, bits=bits, bias=bvec)
    want = qm.quantized_matmul_plain(x, codes, scales, bits=bits, bias=bvec)
    torch.cuda.synchronize()
    tag = f"M={m} K={k} N={n} int{bits}" + (" bias" if bias else "")
    err = _check(torch, f"quantized_matmul {tag} {dtype}", got, want, dtype,
                 tol=QMM_TOL[dtype])
    item = x.element_size()
    nbytes = (m * k * item + codes.numel() + 4 * n * (2 if bias else 1)
              + m * n * item)
    ops = 2.0 * m * k * n
    bound_ms, by = _bound(nbytes, ops, dtype)
    scratch, flush = _read_flush(torch)
    ms = _time_ms(torch, lambda: qm.quantized_matmul(x, codes, scales,
                                                     bits=bits, bias=bvec),
                  flush)
    plain_ms = _time_ms(torch, lambda: qm.quantized_matmul_plain(
        x, codes, scales, bits=bits, bias=bvec), flush, warmup=2, iters=10)
    wd = qm.dequant_view(codes, scales, bits, dt)
    if bias:
        bd = bvec.to(dt)
        lib_ms = _time_ms(torch, lambda: torch.addmm(bd, x, wd), flush)
    else:
        lib_ms = _time_ms(torch, lambda: torch.matmul(x, wd), flush)
    del scratch, wd
    return dict(shape=tag, dtype=dtype, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms)


def _qmm_rows_case(torch, bits, gen, k=4096, n=14336):
    """A row's bits at every M (bf16 x, the 8B gate/up projection): x
    [256, K], and the launches on x[:M] for M in ``QMM_ROW_MS``, for each
    epilogue form of ``QMM_FORMS`` (bias [N] of std 0.1).  Every launch
    is held against its plain version (``QMM_TOL``), and the rows of each
    launch must equal the same rows of the next larger one bit for bit."""
    from paddle_tpu_torch.ops import quantized_matmul as qm
    from paddle_tpu_torch.quantization import (absmax_to_scales,
                                               quantize_channelwise)
    x = torch.randn(max(QMM_ROW_MS), k, generator=gen,
                    device="cuda").bfloat16()
    w = 0.02 * torch.randn(k, n, generator=gen, device="cuda")
    scales = absmax_to_scales(w.abs().amax(0), bits)
    codes = quantize_channelwise(w, scales, bits)
    del w
    if bits == 4:
        codes = qm.pack_int4(codes)
    bias = 0.1 * torch.randn(n, generator=gen, device="cuda")
    atol, rtol = QMM_TOL["bfloat16"]
    for with_bias, act in QMM_FORMS:
        kw = dict(bias=bias if with_bias else None, act=act, bits=bits)
        tag = (f"quantized_matmul K={k} N={n} int{bits} bfloat16 "
               f"bias={with_bias} act={act}")
        outs, share = {}, 0.0
        for m in QMM_ROW_MS:
            got = qm.quantized_matmul(x[:m], codes, scales, **kw)
            want = qm.quantized_matmul_plain(x[:m], codes, scales, **kw)
            share = max(share, _within(torch, f"{tag} M={m}", got, want,
                                       atol, rtol)[1])
            outs[m] = got
        for small, big in zip(QMM_ROW_MS, QMM_ROW_MS[1:]):
            _same(torch, tag, outs[small], outs[big][:small],
                  f"M={small} against the first {small} rows of M={big}")
        _log(f"  {tag}: M={', '.join(map(str, QMM_ROW_MS))} within the "
             f"limit ({share:.3f} of it at most), each row bit-equal at "
             f"every M")


# The training shapes of phase 5 (examples/llama_pretrain.py at full width)
TRAIN = dict(batch=8, seq=2048, hidden=2048, heads=32, kv_heads=8,
             head_dim=64, inter=8192, layers=16, vocab=32000)
# flash attention in bfloat16: (atol as a share of the RMS of the value's
# row over D, rtol) for O, dQ, dK and dV.  rtol 2^-7 is one bf16 ulp of
# the value at any magnitude: fp32 sums in another order (dQ's atomics in
# an order that changes from run to run) may round the other way.  The
# forward rounds P to bf16 relative to the running max of its online
# softmax, as the TPU kernel does, while the plain version rounds the
# normalized P, so each term p_j v_j of a row of O may differ by 2^-8 of
# itself; where the terms cancel, O keeps an error of that order of the
# row's size while its value is near zero.  O's atol is 2^-5 of its row's
# RMS (each check logs the largest share of its limit that an element
# used).  The backward rounds the same normalized P and dS as
# its plain version, so the gradients get 2^-8 of the row's RMS.  float32
# flash uses TOL's atol 1e-4 (true fp32 products, no TF32).
FLASH_BF16_TOL = {"O": (2.0 ** -5, 2.0 ** -7), "dQ": (2.0 ** -8, 2.0 ** -7),
                  "dK": (2.0 ** -8, 2.0 ** -7), "dV": (2.0 ** -8, 2.0 ** -7)}
# the LSE is fp32 in both dtypes (scores of bf16 inputs are exact products
# summed in fp32): atol 1e-4 on values near log(S) ~ 8.
LSE_TOL = (1e-4, 1e-5)


def _check_lse(torch, tag, lse, lse_ref):
    """Max |err| of the LSE after asserting it within LSE_TOL."""
    atol, rtol = LSE_TOL
    err = (lse - lse_ref).abs()
    if (err > atol + rtol * lse_ref.abs()).any():
        raise AssertionError(f"flash_attention_fwd LSE {tag}: max |err| "
                             f"{err.max().item():.3g} past atol {atol}")
    return err.max().item()


def _flash_case(torch, dtype, b, gen, geom=None):
    """Causal flash attention at the training geometry (S=2048, Hq=32,
    Hkv=8, D=64; or ``geom`` = (S, Hq, Hkv, D), GPT-2 small's 1024, 12,
    12, 64), forward and backward, each against its plain version
    within FLASH_BF16_TOL in bfloat16 (its reasons are stated there) and
    TOL in float32."""
    from paddle_tpu_torch.ops import flash_attention as fa
    s, hq, hkv, d = geom or (TRAIN["seq"], TRAIN["heads"], TRAIN["kv_heads"],
                             TRAIN["head_dim"])
    dt = getattr(torch, dtype)
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dt)
    do = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dt)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, True)
    torch.cuda.synchronize()
    tag = f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal {dtype}"
    def check(what, got, want):
        row_atol, rtol = FLASH_BF16_TOL[what] if dtype == "bfloat16" \
            else (None, None)
        return _check(torch, f"flash_attention {what} {tag}", got, want,
                      dtype, row_atol, rtol)

    err_o = check("O", o, o_ref)
    err_lse = _check_lse(torch, tag, lse, lse_ref)
    del o_ref, lse_ref
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    err_b = max(check(n, g, r)
                for n, g, r in zip(("dQ", "dK", "dV"), grads, refs))
    del grads, refs
    torch.cuda.empty_cache()
    item = q.element_size()
    fwd_ops = 4 * b * hq * s * s * d / 2
    fwd_bytes = (2 * q.numel() + k.numel() + v.numel()) * item \
        + lse.numel() * 4
    # in: q, k, v, o, dO, LSE; out: dQ, dK, dV
    bwd_bytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) * item \
        + lse.numel() * 4
    fb, fby = _bound(fwd_bytes, fwd_ops, dtype)
    bb, bby = _bound(bwd_bytes, 2.5 * fwd_ops, dtype)
    fwd_ms = _time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, True),
                      iters=10)
    fwd_plain_ms = _time_ms(
        torch, lambda: fa.flash_attention_fwd_plain(q, k, v, True),
        warmup=2, iters=5)
    bwd_ms = _time_ms(
        torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True),
        iters=10)
    bwd_plain_ms = _time_ms(
        torch, lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    True),
        warmup=2, iters=5)
    # library yardstick: SDPA on [B, H, S, D] views, GQA in the call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = (out.transpose(1, 2).float() - o.float()).abs().max().item()
    dot = do.transpose(1, 2)
    with torch.no_grad():
        lib_fwd_ms = _time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True), iters=10)
    lib_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    del out, qt, kt, vt
    shape = f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal"
    fwd = dict(shape=shape, dtype=dtype, max_abs_err=max(err_o, err_lse),
               ms=fwd_ms, plain_ms=fwd_plain_ms,
               bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms,
               library_max_abs_err=lib_err)
    bwd = dict(shape=shape, dtype=dtype, max_abs_err=err_b, ms=bwd_ms,
               plain_ms=bwd_plain_ms, bound_ms=bb, bound_by=bby,
               library_ms=lib_bwd_ms)
    return fwd, bwd


# RoPE shapes of phase 2, [B, S, H, D]: the training path's q (its largest
# call, the main case) and k, the 8B drafter's prefill q, and a head dim
# whose D/2 = 18 takes the element route in both dtypes (S = 300: not a
# multiple of the positions a CTA takes)
ROPE_SHAPES = [(8, 2048, 32, 64), (8, 2048, 8, 64), (1, 512, 32, 128),
               (4, 300, 8, 36)]


def _rope_case(torch, dtype, gen, shape=ROPE_SHAPES[0]):
    """RoPE forward and backward (-sin) against the plain version.  Both
    round each fp32 product and sum on its own and cast once, so they
    must agree bit for bit."""
    from paddle_tpu_torch.ops import rope as rp
    b, s, h, d = shape
    dt = getattr(torch, dtype)
    x = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
    g = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
    inv = 1.0 / (500000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                           device="cuda") / d))
    freqs = torch.outer(torch.arange(s, dtype=torch.float32, device="cuda"),
                        inv)
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    y = rp._rope_cuda(x, cos, sin, 1.0)
    gx = rp._rope_cuda(g, cos, sin, -1.0)
    want_y = rp.apply_rope_plain(x, cos, sin)
    want_gx = rp.apply_rope_plain(g, cos, -sin)
    torch.cuda.synchronize()
    tag = f"[{b},{s},{h},{d}] {dtype}"
    if hasattr(rp, "rope_plan"):
        tag += f" ({rp.rope_plan(b, s, h, d, dt)})"
    for what, got, want in (("fwd", y, want_y), ("bwd", gx, want_gx)):
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"rope {what} {tag}: not bit-identical to "
                                 f"the plain version (max |err| {err:.3g})")
    _log(f"  rope fwd and bwd {tag}: bit-identical to the plain version")
    item = x.element_size()
    bound_ms, by = _bound(2 * x.numel() * item + 2 * cos.numel() * 4,
                          3 * x.numel(), dtype)
    ms = _time_ms(torch, lambda: rp._rope_cuda(x, cos, sin, 1.0))
    plain_ms = _time_ms(torch, lambda: rp.apply_rope_plain(x, cos, sin))
    return dict(shape=f"[{b},{s},{h},{d}]", dtype=dtype, max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None)


def _flash_twopass_case(torch, dtype, b, gen, causal=True,
                        hkv=TRAIN["kv_heads"], time_it=True, s=TRAIN["seq"],
                        d=TRAIN["head_dim"]):
    """The two-pass backward (``flash_onepass_bwd=False``) at Hq=32 (by
    default the training shape S=2048, D=64): dQ, dK and dV through
    ``flash_attention_bwd`` against
    the plain backward within FLASH_BF16_TOL in bfloat16 (its reasons
    are stated there) and TOL in float32, and the dQ kernel's output
    bit-identical over two launches (it writes every element once, no
    atomics).  With ``time_it``: the dQ and dK/dV kernels alone, their
    plain versions, and SDPA's backward (no single PyTorch call computes
    dQ alone or dK and dV alone).  Returns (dq row, dkv row)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import flash_attention as fa
    hq = TRAIN["heads"]
    dt = getattr(torch, dtype)
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dt)
    do = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dt)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1) \
        .contiguous()
    shape = (f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
             + ("causal" if causal else "non-causal"))
    tag = f"{shape} {dtype}"
    dq1 = fa._dq_cuda(q, k, v, do, lse, delta, causal)
    dq2 = fa._dq_cuda(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    if not torch.equal(dq1.view(torch.int16 if dtype == "bfloat16"
                                else torch.int32),
                       dq2.view(torch.int16 if dtype == "bfloat16"
                                else torch.int32)):
        raise AssertionError(f"flash dQ kernel {tag}: two launches gave "
                             f"different bits")
    del dq1, dq2
    ptt.set_flags({"FLAGS_flash_onepass_bwd": False})
    try:
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    finally:
        ptt.set_flags({"FLAGS_flash_onepass_bwd": True})
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()

    def check(what, got, want):
        row_atol, rtol = FLASH_BF16_TOL[what] if dtype == "bfloat16" \
            else (None, None)
        return _check(torch, f"flash two-pass {what} {tag}", got, want,
                      dtype, row_atol, rtol)

    err_dq = check("dQ", grads[0], refs[0])
    err_dkv = max(check("dK", grads[1], refs[1]),
                  check("dV", grads[2], refs[2]))
    del grads, refs
    torch.cuda.empty_cache()
    if not time_it:
        return None, None
    item = q.element_size()
    score = 2.0 * b * hq * s * s * d * (0.5 if causal else 1.0)
    stats = 2 * lse.numel() * 4                  # lse and delta, fp32
    ins = (2 * q.numel() + k.numel() + v.numel()) * item + stats
    dq_b, dq_by = _bound(ins + q.numel() * item, 3 * score, dtype)
    dkv_b, dkv_by = _bound(ins + (k.numel() + v.numel()) * item, 4 * score,
                           dtype)
    args = (q, k, v, do, lse, delta, causal)
    dq_ms = _time_ms(torch, lambda: fa._dq_cuda(*args), iters=10)
    dkv_ms = _time_ms(torch, lambda: fa._dkv_cuda(*args), iters=10)
    dq_plain_ms = _time_ms(torch, lambda: fa._dq_plain(*args), warmup=2,
                           iters=5)
    dkv_plain_ms = _time_ms(torch, lambda: fa._dkv_plain(*args), warmup=2,
                            iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2)
    lib_ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    del out, qt, kt, vt
    torch.cuda.empty_cache()
    dq_row = dict(shape=shape, dtype=dtype, max_abs_err=err_dq, ms=dq_ms,
                  plain_ms=dq_plain_ms, bound_ms=dq_b, bound_by=dq_by,
                  library_ms=lib_ms)
    dkv_row = dict(shape=shape, dtype=dtype, max_abs_err=err_dkv,
                   ms=dkv_ms, plain_ms=dkv_plain_ms, bound_ms=dkv_b,
                   bound_by=dkv_by, library_ms=lib_ms)
    _log(f"  flash two-pass {tag}: dQ {dq_ms:.4f} + dK/dV {dkv_ms:.4f} = "
         f"{dq_ms + dkv_ms:.4f} ms (SDPA backward {lib_ms:.4f} ms)")
    return dq_row, dkv_row


def _flash_fwd_case(torch, dtype, gen, b, sq, sk, hq, hkv, d, causal,
                    time_it=False):
    """The flash forward alone at one geometry: O within FLASH_BF16_TOL
    (bfloat16) or TOL (float32) and the LSE within LSE_TOL of the plain
    version.  With ``time_it``: the kernel, the plain version and SDPA
    (GQA in the call, never called by the port) beside the bound.
    Returns the row, or None."""
    from paddle_tpu_torch.ops import flash_attention as fa
    dt = getattr(torch, dtype)
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    shape = (f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} "
             + ("causal" if causal else "non-causal"))
    tag = f"{shape} {dtype}"
    row_atol, rtol = FLASH_BF16_TOL["O"] if dtype == "bfloat16" \
        else (None, None)
    err = max(_check(torch, f"flash_attention O {tag}", o, o_ref, dtype,
                     row_atol, rtol),
              _check_lse(torch, tag, lse, lse_ref))
    del o_ref, lse_ref
    if not time_it:
        return None
    item = q.element_size()
    ops = 4.0 * b * hq * sq * sk * d * (0.5 if causal else 1.0)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * item + lse.numel() * 4
    bound_ms, by = _bound(nbytes, ops, dtype)
    ms = _time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal))
    plain_ms = _time_ms(torch, lambda: fa.flash_attention_fwd_plain(
        q, k, v, causal), iters=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = _time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True))
    _log(f"  flash_attention_fwd {tag}: kernel {ms:.4f} ms, SDPA "
         f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return dict(shape=shape, dtype=dtype, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms)


def _flash_onepass_case(torch, dtype, gen, b, s, hkv, d, causal):
    """The one-pass backward (the default route, ``flash_onepass_bwd``)
    at one geometry beyond the training shape, Hq=32: dQ, dK and dV
    through ``flash_attention_bwd`` against the plain backward within
    FLASH_BF16_TOL in bfloat16 (its reasons are stated there) and TOL in
    float32, one launch of its kernel."""
    from paddle_tpu_torch.ops import flash_attention as fa
    hq = TRAIN["heads"]
    dt = getattr(torch, dtype)
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dt)
    do = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dt)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    before = fa.KERNEL_BWD.launches
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    tag = (f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
           + ("causal" if causal else "non-causal") + f" {dtype}")
    if fa.KERNEL_BWD.launches != before + 1:
        raise AssertionError(f"flash one-pass {tag}: the backward did not "
                             f"launch the one-pass kernel once")
    for what, got, want in zip(("dQ", "dK", "dV"), grads, refs):
        row_atol, rtol = FLASH_BF16_TOL[what] if dtype == "bfloat16" \
            else (None, None)
        _check(torch, f"flash one-pass {what} {tag}", got, want, dtype,
               row_atol, rtol)


def _flash_shape_rows(torch, seed):
    """Phase 2's flash cases beyond the training shape, at B <= 2, in
    bfloat16 (the tensor-core kernels) and float32 (the CUDA-core ones):
    the forward at the 8B drafter's prefill (B=1 S=512 Hq=32 Hkv=8
    D=128 causal; timed in bfloat16), at a ragged causal length (S=1000,
    D=128) and non-causal with Sq != Sk (300 against 1000, D=64); the
    two-pass backward at the ragged length with G = 4 and G = 1, dQ
    bit-identical over two launches there as at D=64; the one-pass
    backward at the ragged length with G = 4 and G = 1 and non-causal at
    Sq = Sk = 1000, D=64.  Returns the timed forward rows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 6)
    hq, hkv = TRAIN["heads"], TRAIN["kv_heads"]
    rows = []
    for dtype in ("bfloat16", "float32"):
        row = _flash_fwd_case(torch, dtype, gen, 1, 512, 512, hq, hkv, 128,
                              True, time_it=dtype == "bfloat16")
        if row is not None:
            rows.append(row)
        _flash_fwd_case(torch, dtype, gen, 2, 1000, 1000, hq, hkv, 128, True)
        _flash_fwd_case(torch, dtype, gen, 2, 300, 1000, hq, hkv, 64, False)
        for g_kv in (hkv, hq):
            _flash_twopass_case(torch, dtype, 2, gen, hkv=g_kv,
                                time_it=False, s=1000, d=128)
            _flash_onepass_case(torch, dtype, gen, 2, 1000, g_kv, 128, True)
        _flash_onepass_case(torch, dtype, gen, 2, 1000, hkv, 64, False)
    return rows


# the fused AdamW checks: the 1.1B model's MLP weight and embedding, a
# norm weight and an odd length; hyperparameters of a late step
ADAMW_SHAPES = [(TRAIN["inter"], TRAIN["hidden"]),
                (TRAIN["vocab"], TRAIN["hidden"]), (TRAIN["hidden"],),
                (1000,)]
ADAMW_HP = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1)
_ADAMW_OPS = {"p": "p'' = p*(1 - lr*wd) - (lr*(m'/bc1)) / (sqrt(v'/bc2) "
                   "+ eps), cast to p's dtype",
              "m": "m' = b1*m + (1-b1)*g, stored in m's dtype",
              "v": "v' = b2*v + ((1-b2)*g)*g, stored in v's dtype"}


def _adamw_inputs(torch, shape, p_dtype, m_dtype, gen):
    def rnd(scale, dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * scale) \
            .to(dtype)
    p = rnd(0.02, p_dtype)
    g = rnd(1e-3, p_dtype)
    m = rnd(1e-4, m_dtype)
    v = (rnd(1e-3, torch.float32) ** 2).to(m_dtype)
    return p, g, m, v


def _adamw_case(torch, shape, p_dtype, m_dtype, seed, gen, time_it=False):
    """The fused AdamW kernel against its plain version on the card, on
    the same inputs: p, m and v must be BIT-identical (the kernel does
    each operation as one fp32 IEEE op in the plain version's order, and
    both draw the same noise).  With ``time_it``: the kernel, the plain
    version and ``torch._fused_adamw_`` (the op behind
    ``torch.optim.AdamW(fused=True)``, which the port never calls) on
    fp32 copies, beside the byte bound."""
    from paddle_tpu_torch.ops import fused_optimizer as fo
    pdt, mdt = getattr(torch, p_dtype), getattr(torch, m_dtype)
    p, g, m, v = _adamw_inputs(torch, shape, pdt, mdt, gen)
    lr = torch.tensor(3e-4, dtype=torch.float32, device="cuda")
    step = torch.tensor(7.0, dtype=torch.float32, device="cuda")
    tag = (f"{list(shape)} p {p_dtype} moments {m_dtype} "
           + ("seed" if seed is not None else "no seed"))
    kern = [t.clone() for t in (p, m, v)]
    plain = [t.clone() for t in (p, m, v)]
    fo.fused_adamw_update(kern[0], g, kern[1], kern[2], lr, step,
                          seed=seed, **ADAMW_HP)
    fo.fused_adamw_update_plain(plain[0], g, plain[1], plain[2], lr, step,
                                seed=seed, **ADAMW_HP)
    torch.cuda.synchronize()
    for name, a, b in zip("pmv", kern, plain):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        diff = a.view(bits) != b.view(bits)
        if diff.any():
            i = int(diff.reshape(-1).nonzero()[0])
            raise AssertionError(
                f"fused_adamw {name} {tag}: {int(diff.sum())} elements "
                f"differ from the plain version (first at flat index {i}: "
                f"kernel {a.reshape(-1)[i].item()!r} plain "
                f"{b.reshape(-1)[i].item()!r}); the operation: "
                f"{_ADAMW_OPS[name]}")
    moved = (kern[0] != p).float().mean().item()
    _log(f"  fused_adamw {tag}: p, m, v bit-identical to the plain "
         f"version ({100 * moved:.1f}% of p changed)")
    del kern, plain
    if not time_it:
        return None
    n = p.numel()
    ps, ms_ = p.element_size(), m.element_size()
    bound_ms, by = _bound(n * (2 * ps + 2 * ms_) + n * (ps + 2 * ms_),
                          20 * n, "float32")
    hp = dict(seed=seed, **ADAMW_HP)
    # the kernel alone, its scalars made once; the wrapper's time adds
    # its checks, as the train step calls it (the scalars made once per
    # step and shared by every parameter)
    sc = fo.adamw_scalars(lr, step, ADAMW_HP["beta1"], ADAMW_HP["beta2"],
                          p.device)
    ms = _time_ms(torch, lambda: fo._launch(p, g, m, v, sc, **hp))
    wrapper_ms = _time_ms(torch, lambda: fo.fused_adamw_update(
        p, g, m, v, lr, step, scalars=sc, **hp))
    plain_ms = _time_ms(torch, lambda: fo.fused_adamw_update_plain(
        p, g, m, v, lr, step, **hp), iters=10)
    # library yardstick: torch._fused_adamw_ takes one dtype for p, g, m
    # and v, so it runs on fp32 copies (fp32 moments, as the port's
    # multi_precision route keeps them)
    lp, lg, lm, lv = (t.float() for t in (p, g, m, v))
    steps = [torch.tensor(7.0, device="cuda")]
    lib_ms = _time_ms(torch, lambda: torch._fused_adamw_(
        [lp], [lg], [lm], [lv], [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
        weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False))
    del lp, lg, lm, lv
    _log(f"  fused_adamw {tag}: kernel {ms:.4f} ms, wrapper {wrapper_ms:.4f} "
         f"ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
         f"{bound_ms:.4f} ms")
    return dict(shape=str(list(shape)),
                dtype=f"p {p_dtype}, moments {m_dtype}", max_abs_err=0.0,
                ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)


def _train5_rows(torch, seed):
    """Phase 2's rows of the slice-5 kernels: the two-pass flash
    backward and the fused AdamW update.  Returns {name: [rows]}, the
    main path's case first."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 5)
    rows = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": [],
            "fused_adamw": []}
    for dtype, b in (("bfloat16", TRAIN["batch"]), ("float32", 2)):
        dq, dkv = _flash_twopass_case(torch, dtype, b, gen)
        rows["flash_attention_bwd_dq"].append(dq)
        rows["flash_attention_bwd_dkv"].append(dkv)
    _flash_twopass_case(torch, "bfloat16", 2, gen, causal=False,
                        time_it=False)
    _flash_twopass_case(torch, "bfloat16", 2, gen, hkv=TRAIN["heads"],
                        time_it=False)
    # timed: the main path's case first (phase 5b: bf16 p, bf16 moments,
    # a seed), then the embedding, then fp32 moments (phase 5's route)
    timed = [(0, "bfloat16", "bfloat16", True), (1, "bfloat16", "bfloat16",
                                                  True),
             (0, "bfloat16", "float32", False), (1, "bfloat16", "float32",
                                                 False)]
    for i, pd, md, with_seed in timed:
        rows["fused_adamw"].append(_adamw_case(
            torch, ADAMW_SHAPES[i], pd, md, 1234 + i if with_seed else None,
            gen, time_it=True))
    for i, shape in enumerate(ADAMW_SHAPES):
        for pd in ("bfloat16", "float32"):
            for md in ("bfloat16", "float32"):
                for with_seed in (True, False):
                    if (i, pd, md, with_seed) not in timed:
                        _adamw_case(torch, shape, pd, md,
                                    1234 + i if with_seed else None, gen)
    return rows


def phase_kernels(torch, seed):
    import numpy as np
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    rows = {"rms_norm": [], "paged_decode_attention": [],
            "paged_decode_attention_int8": [], "quantized_matmul": [],
            "flash_attention_fwd": [], "flash_attention_bwd": [],
            "rope": [], "paged_decode_attention_multi": [],
            "paged_decode_attention_multi_int8": [], "decode_attention": []}
    for dtype in ("bfloat16", "float32"):
        for n in (8, 256):
            rows["rms_norm"].append(_rms_case(torch, n, dtype, gen))
        rows["paged_decode_attention"].append(
            _decode_case(torch, dtype, gen, rng))
        rows["paged_decode_attention_int8"].append(
            _decode_int8_case(torch, dtype, gen, rng))
        rows["paged_decode_attention_multi"] += _multi_case(
            torch, dtype, gen, rng, int8=False)
        rows["paged_decode_attention_multi_int8"] += _multi_case(
            torch, dtype, gen, rng, int8=True)
        rows["decode_attention"].append(_dense_case(torch, dtype, gen))
        for bits in (8, 4):
            for m, k, n in QMM_SHAPES:
                rows["quantized_matmul"].append(
                    _qmm_case(torch, dtype, bits, m, k, n, gen))
            if dtype == "bfloat16":
                _qmm_rows_case(torch, bits, gen)
        # flash at the training batch in bf16 (the main path's shape), at
        # B=2 in f32 (the plain backward's fp32 score tensors at B=8 f32
        # would be 4.3 GB each)
        fwd, bwd = _flash_case(torch, dtype,
                               TRAIN["batch"] if dtype == "bfloat16" else 2,
                               gen)
        rows["flash_attention_fwd"].append(fwd)
        rows["flash_attention_bwd"].append(bwd)
        rows["rope"].append(_rope_case(torch, dtype, gen))
    for shape in ROPE_SHAPES[1:]:
        for dtype in ("bfloat16", "float32"):
            rows["rope"].append(_rope_case(torch, dtype, gen, shape))
    rows["rms_norm"].append(_rms_case(
        torch, TRAIN["batch"] * TRAIN["seq"], "bfloat16", gen,
        d=TRAIN["hidden"]))
    for d in RMS_ROW_WIDTHS:
        for dtype in ("bfloat16", "float32"):
            _rms_rows_case(torch, dtype, d, gen)
    for n, d in RMS_TURN_SHAPES:
        _rms_turns(torch, n, d, gen)
    for shape, what in COPY_FLOORS:
        _copy_floor(torch, shape, gen, what)
    rows.update(_train5_rows(torch, seed))
    rows["flash_attention_fwd"] += _flash_shape_rows(torch, seed)
    for name, cases in rows.items():
        for c in cases:
            lib = c["library_ms"]
            _log(f"{name} {c['shape']} {c['dtype']}: "
                 f"max_abs_err={c['max_abs_err']:.3g} "
                 f"kernel_ms={c['ms']:.4f} bound_ms={c['bound_ms']:.4f} "
                 f"({c['bound_by']}) plain_ms={c['plain_ms']:.4f} "
                 f"library_ms="
                 + ("none" if lib is None else f"{lib:.4f}")
                 + (f" (library max_abs_err={c['library_max_abs_err']:.3g})"
                    if "library_max_abs_err" in c else ""))
    return rows


def _build_8b(torch, n_layers, dtype, seed):
    import dataclasses
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_3_8b_config
    cfg = dataclasses.replace(llama_3_8b_config(), num_hidden_layers=n_layers)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, dtype=dtype, seed=seed)
    torch.cuda.synchronize()
    _log(f"model: {n_layers} layers at Llama-3-8B width, {dtype}, "
         f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
         f"built in {time.perf_counter() - t0:.2f} s")
    return cfg, model


def _serve_trace(torch, eng, cfg, seed, check_hits=True, streams=None,
                 assign=None):
    """The serving trace of phases 3, 3b and 3g, from ``seed``: 7 requests
    of 64-512 prompt tokens, then (once the first has finished its
    prefill) an 8th sharing its 256-token prefix (16 full blocks).  The
    launch counters are set to 0 just before and read just after.  Every
    request must finish with in-vocabulary tokens and (``check_hits``,
    which needs an enabled registry) the prefix must hit.  Returns
    (launches, stats, wall seconds, requests, tokens, rng, the Request
    objects).

    With a ``streams`` list (phase 3i (a)) every request is submitted
    with ``stream=True`` and the engine is stepped by hand: after each
    step every stream is read, and ``streams`` receives, per step, the
    tokens each stream flushed and the harvest points the step had
    (first tokens, deferred harvests and forced syncs).

    ``assign`` (phase 3j) gives each request, in submission order, extra
    ``submit`` keywords (its ``adapter`` and ``tenant``)."""
    import numpy as np
    from paddle_tpu_torch.ops import KERNELS
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, 256)

    def prompt(n, prefix=None):
        ids = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        if prefix is not None:
            ids[:len(prefix)] = prefix
        return ids

    first = [(prompt(384, shared), 32), (prompt(64), 64), (prompt(512), 16),
             (prompt(200), 48), (prompt(130), 24), (prompt(450), 40),
             (prompt(96), 56)]
    second = (prompt(320, shared), 20)       # shares 16 full blocks
    stream = streams is not None
    handles = []

    def harvests():
        m = eng._m
        return int(m.prefills.total() + m.async_harvests.total()
                   + m.async_syncs.total())

    def step():
        h0 = harvests()
        eng.step()
        streams.append(([s.read().tolist() for s in handles],
                        harvests() - h0))

    made = [0]

    def submit(ids, m):
        extra = assign[made[0]] if assign else {}
        made[0] += 1
        r = eng.submit(ids, max_new_tokens=m, stream=stream, **extra)
        if stream:
            handles.append(r)
            return r.request
        return r

    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [submit(ids, m) for ids, m in first]
    while reqs[0].state in ("queued", "prefill"):
        step() if stream else eng.step()
    reqs.append(submit(second[0], second[1]))
    if stream:
        while any(not s.finished for s in handles):
            step()
        # every token, the terminal pad included, was read after the step
        # that made it host truth: a tail read is empty
        tail = [s.read().tolist() for s in handles]
        if any(tail):
            streams.append((tail, 0))
    else:
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    st = eng.stats()
    specs = first + [second]
    _finished_in_vocab(reqs, [m for _, m in specs], cfg.vocab_size,
                       "serving")
    if check_hits and st["prefix_hits"] <= 0:
        raise AssertionError(f"the shared prefix did not hit: {st}")
    return (launches, st, wall, len(specs), sum(m for _, m in specs), rng,
            reqs)


def _check_launches(launches, want, st):
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != expected "
                             f"{want} for {st['prefill_chunks']} chunks and "
                             f"{st['decode_steps']} decode steps")


def _log_serving(tag, n_req, n_tok, wall, st, launches, extra=""):
    """One serving run's line.  ``decode dispatch`` is the host time of
    the decode dispatches (with the wait of a harvest that syncs at once)
    per scanned step, not a step's wall: that comes from the unprofiled
    window of ``_profile_decode``."""
    _log(f"{tag}: {n_req} requests, {n_tok} tokens in {wall:.3f} s "
         f"= {n_tok / wall:.2f} tokens/s; mean TTFT "
         f"{st['mean_ttft_s'] * 1e3:.2f} ms; decode dispatch "
         f"{st['decode_seconds'] / st['decode_steps'] * 1e3:.3f} ms a step "
         f"over {st['decode_steps']} steps in {st['block_dispatches']} "
         f"dispatches; prefill chunks "
         f"{st['prefill_chunks']}; prefix hits {st['prefix_hits']} "
         f"(rate {st['prefix_hit_rate']:.3f}); peak blocks "
         f"{st['peak_blocks_in_use']}; {extra}launches {launches}")


# phase 3's arms, run in turns (each twice): the lockstep arm, the
# engine's default (dispatch-ahead at depth 1) and depth 2
SERVING_ARMS = (("lockstep", dict(async_dispatch=False)),
                ("depth 1", {}),
                ("depth 2", dict(async_depth=2)))
SERVING_TURNS = (0, 1, 2, 2, 1, 0)


def phase_serving(torch, seed, cfg, model):
    """Phase 3: the serving trace through an 8-slot engine in three arms
    (``SERVING_ARMS``), in turns, twice each.  Every run holds the launch
    formula; the arms' tokens must be equal; each run logs tokens/s, TTFT,
    the forced syncs by reason, the overlap seconds, the decode graphs and
    peak memory, and each arm's first run the unprofiled wall and the
    device busy time of a decode step and the device's idle share (1 -
    the union of its kernel intervals over the window's wall).  The first depth-1 run also runs the
    sync-debug window.  Returns the launch counts of the first depth-1
    run (the engine's defaults), that run's decode profile and the
    trace's tokens."""
    from paddle_tpu_torch.inference import ServingEngine
    nl = cfg.num_hidden_layers
    tokens, first, main_launches, main_prof = None, None, None, None
    for turn, ai in enumerate(SERVING_TURNS):
        tag, arm = SERVING_ARMS[ai]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(model, num_slots=8, prompt_len=512,
                            chunk_len=256, max_cache_len=1024, block_len=16,
                            compute_dtype="bfloat16", **arm)
        launches, st, wall, n_req, n_tok, rng, reqs = _serve_trace(
            torch, eng, cfg, seed)
        peak = torch.cuda.max_memory_allocated()
        _check_launches(launches, _serving_launches(nl, st, False), st)
        outs = [r.output.tolist() for r in reqs]
        if tokens is None:
            tokens, first = outs, tag
        elif outs != tokens:
            raise AssertionError(f"serving: the {tag} arm's tokens differ "
                                 f"from the {first} arm's")
        g = st["decode_graphs"]
        syncs = {k: v for k, v in st["async_syncs_by_reason"].items() if v}
        _log_serving(f"serving [{tag}, turn {turn + 1}]", n_req, n_tok, wall,
                     st, launches,
                     f"syncs {syncs or 'none'}, harvests after the next "
                     f"dispatch {st['async_harvests']}, overlap "
                     f"{st['overlap_seconds'] * 1e3:.1f} ms, dispatch "
                     f"{st['dispatch_seconds'] * 1e3:.1f} ms, host "
                     f"{st['host_seconds'] * 1e3:.1f} ms; decode graphs "
                     f"{g['captures']} captured in "
                     f"{g['capture_seconds'] * 1e3:.1f} ms, "
                     f"{g['replays']} replays; peak memory "
                     f"{peak / 2 ** 30:.2f} GiB; ")
        # one decode profile per arm, on its first run
        prof = (_profile_decode(torch, eng, rng, cfg.vocab_size)
                if SERVING_TURNS.index(ai) == turn else None)
        if ai == 1 and main_launches is None:
            main_launches, main_prof = launches, prof
            _sync_debug_window(torch, eng, rng, cfg.vocab_size)
            if prof is not None:
                ratio = prof["wall_ms"] / prof["busy_ms"]
                _log(f"serving [depth 1]: unprofiled wall per decode step "
                     f"{prof['wall_ms']:.3f} ms = {ratio:.2f} x the device "
                     f"busy time {prof['busy_ms']:.3f} ms (acceptance: at "
                     f"most 2 x)")
        del eng
    torch.cuda.empty_cache()
    _log(f"serving: the {len(SERVING_TURNS)} runs of "
         f"{len(SERVING_ARMS)} arms gave equal tokens")
    return main_launches, main_prof, tokens


def _sync_debug_window(torch, eng, rng, vocab, steps=8, sampling=None):
    """No hidden host sync on the steady-state path: 8 fresh requests
    (``sampling``: their per-request configurations, or greedy) fill the
    slots and decode until every harvest defers, then ``steps`` decode
    steps run under ``torch.cuda.set_sync_debug_mode("error")`` (a
    ``.item()``, ``.cpu()``, pageable copy or boolean-mask index raises
    there; the harvest's wait on its event is not such a sync).  Every
    step must defer its harvest, with no forced sync."""
    mix = sampling if sampling is not None else [None] * eng.num_slots
    reqs = [eng.submit(rng.integers(0, vocab, 64).astype("int32"),
                       max_new_tokens=2 * steps + 8, sampling=sp)
            for sp in mix]
    while any(r.state in ("queued", "prefill") for r in reqs) \
            or not eng._pend_q:
        eng.step()
    eng.step()
    before = eng.stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(steps):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = eng.stats()
    eng.run()
    if after["async_syncs"] != before["async_syncs"] or \
            after["async_harvests"] - before["async_harvests"] != steps:
        raise AssertionError(
            f"sync-debug window: syncs {before['async_syncs']} -> "
            f"{after['async_syncs']}, deferred harvests "
            f"{before['async_harvests']} -> {after['async_harvests']} over "
            f"{steps} steps")
    _log(f"sync-debug window ({'sampled mix' if sampling else 'greedy'}): "
         f"{steps} steady-state depth-1 decode steps under "
         f"set_sync_debug_mode('error'): no hidden sync, every harvest "
         f"deferred")


def _graph_inputs(torch, eng, rng, vocab):
    """Decode-block inputs of an 8-slot engine at the serving shape: every
    slot live at a ragged length (100 .. 900 tokens) over its own blocks,
    the arenas filled with random bytes (int8 codes and positive scales
    for an int8 cache)."""
    import numpy as np
    dev = eng.device
    b, mb = eng.num_slots, eng.max_blocks
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2 ** 31)))
    for a in eng._arenas:
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=gen,
                                  device=dev, dtype=torch.int8))
        elif a.dtype == torch.float32 and eng.kv_cache_dtype == "int8":
            a.copy_(torch.rand(a.shape, generator=gen, device=dev) * 0.02
                    + 1e-3)
        else:
            a.copy_(torch.randn(a.shape, generator=gen, device=dev,
                                dtype=torch.float32).to(a.dtype))
    lens = rng.integers(100, 900, b).astype(np.int32)
    tables = np.full((b, mb), eng._pool.trash, np.int32)
    for i in range(b):
        tables[i] = np.arange(i * mb, (i + 1) * mb)
    tok = rng.integers(0, vocab, b).astype(np.int32)
    as_t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return (as_t(tok), as_t(lens), torch.zeros(b, dtype=torch.bool,
                                               device=dev),
            as_t(np.full(b, 50, np.int32)), as_t(tables))


def phase_graphs(torch, seed, cfg, model):
    """Phase 3a: the engine's captured decode block against the eager
    ``paged_decode_block`` at B=8 (every slot live at a ragged length)
    for n = 1 and 2 scanned steps, in bf16 and with an int8 KV cache and
    int8 weights: on the same inputs and copies of the same arenas, the
    tokens, the carries and every arena must be bit-equal, and one
    replay must count exactly the launches of one eager block."""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.llm import paged_decode_block
    from paddle_tpu_torch.ops import KERNELS
    rng = np.random.default_rng(seed + 11)
    for quant in ({}, dict(kv_cache_dtype="int8", weight_dtype="int8")):
        torch.cuda.empty_cache()
        eng = ServingEngine(model, num_slots=8, prompt_len=512,
                            chunk_len=256, max_cache_len=1024, block_len=16,
                            compute_dtype="bfloat16", **quant)
        tag = "int8 KV + int8 W" if quant else "bf16"
        for n in (1, 2):
            inputs = _graph_inputs(torch, eng, rng, cfg.vocab_size)
            t0 = time.perf_counter()
            prog = eng._block_program(n)
            torch.cuda.synchronize()
            t_cap = time.perf_counter() - t0
            copies = [a.clone() for a in eng._arenas]
            _zero_launches()
            want = paged_decode_block(model, eng.cfg, n, *inputs, copies,
                                      wq=eng._wq_ctx)[:5]
            torch.cuda.synchronize()
            eager = {k: v.launches for k, v in KERNELS.items()}
            _zero_launches()
            got = prog(*inputs)
            torch.cuda.synchronize()
            replay = {k: v.launches for k, v in KERNELS.items()}
            for name, g, w in zip(("toks", "tok", "lens", "done", "budget"),
                                  got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"graph vs eager ({tag}, n={n}): "
                                         f"{name} differ")
            for i, (a, c) in enumerate(zip(eng._arenas, copies)):
                if not torch.equal(a.view(torch.uint8), c.view(torch.uint8)):
                    raise AssertionError(f"graph vs eager ({tag}, n={n}): "
                                         f"arena {i} differs")
            if replay != eager or not any(eager.values()):
                raise AssertionError(f"graph vs eager ({tag}, n={n}): "
                                     f"launches {replay} != {eager}")
            _log(f"graph vs eager ({tag}, B=8, n={n}): tokens, carries and "
                 f"{len(copies)} arenas bit-equal; capture "
                 f"{t_cap * 1e3:.1f} ms; launches per replay "
                 f"{ {k: v for k, v in replay.items() if v} }")
            del copies
        del eng
    torch.cuda.empty_cache()


def _host_us(torch, fn, n=500):
    """Host time of one call of ``fn`` in microseconds: ``n`` calls
    enqueued back to back, timed on the host clock without a device sync
    inside the window (the device runs behind)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return t * 1e6


def phase_quant_serving(torch, seed, cfg, model):
    """Phase 3b: phase 3's model and trace through an int8-KV engine with
    int8 weights and one with int4 weights, after the host cost of one
    projection call (the decode step is host-bound).  Returns the launch
    counts of each run, by path."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops import KERNELS
    from paddle_tpu_torch.ops import quantized_matmul as qm
    nl = cfg.num_hidden_layers
    dev = next(model.parameters()).device
    with torch.no_grad():
        x = torch.zeros(8, 4096, dtype=torch.bfloat16, device=dev)
        lin = torch.nn.Linear(4096, 1024, bias=False, device=dev,
                              dtype=torch.bfloat16)
        codes = torch.zeros(4096, 1024, dtype=torch.int8, device=dev)
        scales = torch.ones(1024, device=dev)
        q_us = _host_us(torch, lambda: qm.quantized_matmul(x, codes, scales))
        l_us = _host_us(torch, lambda: lin(x))
    _log(f"host time per projection call, M=8 K=4096 N=1024 bf16: "
         f"quantized_matmul {q_us:.1f} us, nn.Linear {l_us:.1f} us")
    by_path = {}
    for wd in ("int8", "int4"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServingEngine(model, num_slots=8, prompt_len=512,
                            chunk_len=256, max_cache_len=1024, block_len=16,
                            compute_dtype="bfloat16", kv_cache_dtype="int8",
                            weight_dtype=wd)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        launches, st, wall, n_req, n_tok, rng, _ = _serve_trace(
            torch, eng, cfg, seed)
        peak = torch.cuda.max_memory_allocated()
        forwards = st["prefill_chunks"] + st["decode_steps"]
        want = {name: 0 for name in KERNELS}
        want.update({"rms_norm": (2 * nl + 1) * forwards,
                     "quantized_matmul": 7 * nl * forwards,
                     "paged_decode_attention_int8": nl * st["decode_steps"]})
        _check_launches(launches, want, st)
        _log_serving(f"serving int8 KV + {wd} weights", n_req, n_tok, wall,
                     st, launches,
                     f"peak memory {peak / 2 ** 30:.2f} GiB (the bf16 model "
                     f"stays beside the planes); plan built in "
                     f"{t_plan:.2f} s; modeled weight bytes per forward "
                     f"{eng._weight_sweep_bytes / 1e9:.3f} GB; ")
        _profile_decode(torch, eng, rng, cfg.vocab_size)
        by_path[f"serving_int8kv_{wd}w"] = launches
        del eng
    torch.cuda.empty_cache()
    return by_path


# phase 3c's trace: 8 requests whose prompt plus output fit the draft
# model's 512-token context grid, so a drafter over the target sees the
# whole sequence; (prompt length, max_new_tokens)
SPEC_TRACE = [(64, 16), (128, 20), (200, 12), (256, 24), (300, 8),
              (96, 18), (384, 14), (150, 22)]
SPEC_TRACE_SHORT = [(n, 12) for n, _m in SPEC_TRACE]


def _spec_launches(nl, st, n_draft_layers=None, quant=False):
    """Launches of one spec-engine trace, by kernel: the target's forwards
    (prefill chunks, decode steps of the iterations whose drafts all came
    back empty, verify forwards) and the ModelDrafter's (one dense prefill
    and ``SPEC['k'] - 1`` dense decode steps per proposal; a proposal is
    a draft hit or miss)."""
    from paddle_tpu_torch.ops import KERNELS
    forwards = st["prefill_chunks"] + st["decode_steps"] \
        + st["spec_verify_steps"]
    proposals = st["spec_draft_hits"] + st["spec_draft_misses"]
    nd = nl if n_draft_layers is None else n_draft_layers
    draft_steps = (SPEC["k"] - 1) * proposals
    want = {name: 0 for name in KERNELS}
    want.update({
        "rms_norm": (2 * nl + 1) * forwards
        + (2 * nd + 1) * (proposals + draft_steps),
        "paged_decode_attention" + ("_int8" if quant else ""):
            nl * st["decode_steps"],
        "paged_decode_attention_multi" + ("_int8" if quant else ""):
            nl * st["spec_verify_steps"],
        "decode_attention": nd * draft_steps,
        "flash_attention_fwd": nd * proposals,
        "rope": 2 * nd * proposals})
    if quant:
        want["quantized_matmul"] = 7 * nl * forwards
    return want


def _spec_trace(torch, eng, cfg, seed, specs):
    """Phase 3c's trace through a spec engine: every request with
    ``spec_decode=SPEC['k']``; launch counters set to 0 just before and
    read just after.  Every request must finish with in-vocabulary
    tokens.  Returns (launches, stats, wall seconds, tokens, rng)."""
    import numpy as np
    from paddle_tpu_torch.ops import KERNELS
    rng = np.random.default_rng(seed)
    trace = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for n, m in specs]
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(ids, max_new_tokens=m, spec_decode=SPEC["k"])
            for ids, m in trace]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    _finished_in_vocab(reqs, [m for _, m in trace], cfg.vocab_size,
                       "spec serving")
    return launches, eng.stats(), wall, sum(m for _, m in trace), rng


# the kernels a profile sums by name: the split and merge kernels of
# csrc/decode_split.cuh by their walk (PagedWalk: the one-token paged
# decode, float or, in an int8-KV engine, int8, and the K-wide verify;
# DenseWalk: the dense decode), the first design's int8 one-token kernel
# (a parent tree's), the quantized matmul (every kernel of its source:
# qmm_tc_kernel, or the float32 route's partial and epilogue kernels and a
# parent tree's) and RMSNorm
DECODE_KERNELS = {"paged (split+merge)": "PagedWalk",
                  "dense (split+merge)": "DenseWalk",
                  "int8 paged (first design)": "paged_decode_int8_kernel",
                  "quantized matmul": "qmm_",
                  "rms_norm": "rms_norm"}


def _decode_ms(per_kernel, steps=1):
    """Device ms per step of each kernel of ``DECODE_KERNELS`` in a
    profile's ``{kernel name: us}``."""
    return {tag: sum(us for n, us in per_kernel.items() if key in n)
            / 1e3 / steps for tag, key in DECODE_KERNELS.items()}


def _device_events(torch, prof):
    """A profile's device work (kernels and copies): its CUDA events
    without the device-side ranges of user annotations (the engine's
    spans open ``record_function`` ranges while a profiler runs, and
    their device ranges cover the kernels they launched)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("serving.")]


def _profile_kernels(torch, prof):
    """A profile's CUDA kernels: ``{name: us}`` summed, and ``{name:
    launches}``."""
    per_kernel, count = {}, {}
    for e in _device_events(torch, prof):
        per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                              + e.time_range.elapsed_us())
        count[e.name] = count.get(e.name, 0) + 1
    return per_kernel, count


def _log_decode_kernels(per_kernel, steps=1):
    """Every decode attention kernel of a profile by its full name (any
    name with "decode" or "paged_multi", so another tree's kernels show
    too), device ms per step."""
    for name, us in sorted(per_kernel.items()):
        if "decode" in name or "paged_multi" in name:
            _log(f"  {us / 1e3 / steps:8.3f} ms/step  decode attention: "
                 f"{name[:120]}")


def _profile_verify(torch, eng, rng, vocab):
    """Where a speculative step's time goes: 8 fresh 64-token spec
    requests fill the slots; once all are prefilled, one step runs
    unprofiled and one under ``torch.profiler`` (the step drafts for every
    slot, then runs one verify forward).  Reports the step's wall, the
    verify forward's wall (host, synced) and the device busy time."""
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.submit(rng.integers(0, vocab, 64).astype("int32"),
                       max_new_tokens=24, spec_decode=SPEC["k"])
            for _ in range(eng.num_slots)]
    while any(r.state in ("queued", "prefill") for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    v0 = eng.stats()["verify_seconds"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    verify = eng.stats()["verify_seconds"] - v0
    per_kernel, _ = _profile_kernels(torch, prof)
    eng.run()
    if not per_kernel:
        _log(f"  verify profile: step wall {wall * 1e3:.1f} ms; device time "
             f"not measured (the profiler recorded no CUDA kernels)")
        return
    busy = sum(per_kernel.values()) / 1e3
    dec = _decode_ms(per_kernel)
    _log(f"  verify profile: 1 step x {eng.num_slots} spec slots: wall "
         f"{wall * 1e3:.1f} ms unprofiled, {wall_prof * 1e3:.1f} ms "
         f"profiled, of which the verify forward {verify * 1e3:.1f} ms; "
         f"device busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}% of "
         f"the unprofiled wall; K-wide verify kernel "
         f"{dec['paged (split+merge)']:.3f} ms, the drafter's dense decode "
         f"{dec['dense (split+merge)']:.3f} ms, quantized matmul "
         f"{dec['quantized matmul']:.3f} ms), "
         f"{len(per_kernel)} distinct kernels")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        _log(f"  {us / 1e3:8.3f} ms  {name[:90]}")
    _log_decode_kernels(per_kernel)


def phase_spec_serving(torch, seed, cfg, model):
    """Phase 3c: greedy speculative decoding at full Llama-3-8B width
    (phase 3's model) through three 8-slot engines with spec_decode=4:
    (a) a ModelDrafter over the target itself, (b) the same with an int8
    KV cache and int8 weights, (c) a ModelDrafter over a 2-layer model of
    the same width from another seed, on a shorter trace.  Exact launch
    counts; acceptance above 0 in (a) and (b), below 1 in (c).  Returns
    the launch counts summed over the three traces."""
    from paddle_tpu_torch.inference import ModelDrafter, ServingEngine
    nl = cfg.num_hidden_layers
    kw = dict(num_slots=8, prompt_len=512, chunk_len=256, max_cache_len=1024,
              block_len=16, compute_dtype="bfloat16")
    dkw = dict(max_context=SPEC["max_context"], max_draft=SPEC["k"],
               compute_dtype="bfloat16")
    total = {}
    _, other = _build_8b(torch, 2, "bfloat16", seed + 5)
    engines = [("a: drafter = target", dict(), model, SPEC_TRACE),
               ("b: drafter = target, int8 KV + int8 weights",
                dict(kv_cache_dtype="int8", weight_dtype="int8"), model,
                SPEC_TRACE),
               ("c: drafter = 2-layer model", dict(), other,
                SPEC_TRACE_SHORT)]
    for tag, extra, draft_model, specs in engines:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(model, drafter=ModelDrafter(draft_model, **dkw),
                            **kw, **extra)
        launches, st, wall, n_tok, rng = _spec_trace(torch, eng, cfg, seed,
                                                     specs)
        peak = torch.cuda.max_memory_allocated()
        want = _spec_launches(
            nl, st, draft_model.config.num_hidden_layers,
            quant="weight_dtype" in extra)
        _check_launches(launches, want, st)
        rate = st["spec_acceptance_rate"]
        if draft_model is model and not rate > 0:
            raise AssertionError(f"spec {tag}: acceptance {rate}, the target "
                                 f"as its own drafter must accept")
        if draft_model is other and not rate < 1:
            raise AssertionError(f"spec {tag}: acceptance {rate}, another "
                                 f"model's drafts must be rejected")
        if st["blocks_in_use"] != 0:
            raise AssertionError(f"spec {tag}: {st['blocks_in_use']} blocks "
                                 f"still in use after the drain")
        _log(f"spec serving {tag}: {len(specs)} requests, {n_tok} tokens in "
             f"{wall:.3f} s = {n_tok / wall:.2f} tokens/s; mean TTFT "
             f"{st['mean_ttft_s'] * 1e3:.2f} ms; verify step "
             f"{st['verify_seconds'] / st['spec_verify_steps'] * 1e3:.3f} ms "
             f"over {st['spec_verify_steps']} verifies; acceptance "
             f"{rate:.3f}, mean accepted {st['spec_mean_accepted_len']:.3f} "
             f"per verify; drafts {st['spec_draft_tokens']} "
             f"(hits {st['spec_draft_hits']}, misses "
             f"{st['spec_draft_misses']}); decode steps "
             f"{st['decode_steps']}; prefill chunks {st['prefill_chunks']}; "
             f"peak memory {peak / 2 ** 30:.2f} GiB; drafter graph captures "
             f"{_capture_ms(draft_model)}; launches {launches}")
        _profile_verify(torch, eng, rng, cfg.vocab_size)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        del eng
    del other
    torch.cuda.empty_cache()
    return total


def _capture_ms(model):
    """The capture ms of each ``generate()`` graph ``model`` holds (its
    first call of a key captures; later calls replay)."""
    graphs = getattr(model, "_generate_graphs", {}).values()
    return [round(g.prog.capture_s * 1e3, 1) for g in graphs]


def _launched(tag, names):
    """Raise unless every kernel of ``names`` launched since the counts
    were last set to 0."""
    from paddle_tpu_torch.ops import KERNELS
    counts = {n: KERNELS[n].launches for n in names}
    if not all(counts.values()):
        raise AssertionError(f"{tag}: a kernel never launched: {counts}")
    return counts


def _zero_launches():
    from paddle_tpu_torch.ops import KERNELS
    for k in KERNELS.values():
        k.launches = 0


def _swap_watch(torch, eng, log):
    """Time every host-tier copy of ``eng`` (the gather of a swap-out or
    demotion with its copy into pinned host memory, the scatter of a
    resume or promotion from pinned staging, each between two device
    syncs) into ``log`` as (kind, blocks, bytes, s), and hold every
    scatter's destination rows against the host stacks it wrote, bit for
    bit, right after it ran.  A lazy demotion's gather ("demote") is
    timed to the end of its device copy; its numpy copy happens at the
    next harvest point, outside the timing.  The wrappers reach the
    engine through a weak reference: stored on the engine, a strong one
    would make a cycle that keeps a dropped engine (and its model) on the
    card until the cyclic garbage collector runs."""
    import weakref

    import numpy as np
    from paddle_tpu_torch.inference.prefixcache import host_rows
    me, cls = weakref.ref(eng), type(eng)
    block_bytes = eng.block_len * eng._kv_row_bytes

    def timed_gather(ids_row, keep, materialize=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cls._gather_rows(me(), ids_row, keep, materialize)
        torch.cuda.synchronize()
        log.append(("out" if materialize else "demote", keep,
                    keep * block_bytes, time.perf_counter() - t0))
        return out

    def timed_scatter(ids_row, stacks, dtypes):
        k = stacks[0].shape[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cls._scatter_rows(me(), ids_row, stacks, dtypes)
        torch.cuda.synchronize()
        log.append(("in", k, k * block_bytes, time.perf_counter() - t0))
        ids = torch.from_numpy(ids_row[:k].astype(np.int64)).to(me().device)
        for a, s in zip(me()._arenas, stacks):
            got, _ = host_rows(a.index_select(0, ids))
            if not np.array_equal(got.view(np.uint8), s.view(np.uint8)):
                raise AssertionError(
                    f"swap-in: arena rows {ids_row[:k].tolist()} differ "
                    f"from the host stack they were restored from")
    eng._gather_rows, eng._scatter_rows = timed_gather, timed_scatter


def _log_swaps(tag, log):
    parts = [f"{kind} {n} blocks {nbytes / 2 ** 20:.1f} MiB "
             f"{s * 1e3:.3f} ms = {nbytes / s / 1e9:.2f} GB/s"
             for kind, n, nbytes, s in log]
    _log(f"{tag}: host-tier copies: " + "; ".join(parts))


def _serving_launches(nl, st, int8):
    """Phase 3's launch formula: RMSNorm 2L+1 per forward, the paged
    decode (float or int8) L per decode step; a swap launches none."""
    from paddle_tpu_torch.ops import KERNELS
    want = {name: 0 for name in KERNELS}
    want.update({"rms_norm": (2 * nl + 1)
                 * (st["prefill_chunks"] + st["decode_steps"]),
                 "paged_decode_attention" + ("_int8" if int8 else ""):
                 nl * st["decode_steps"]})
    return want


def _arena_block_bytes(eng):
    """Bytes of one block across every flat arena, from the arena
    shapes."""
    return sum(a[0].numel() * a.element_size() for a in eng._arenas)


def _finished_in_vocab(reqs, specs, vocab, tag):
    for r, m in zip(reqs, specs):
        out = r.output
        if r.state != "finished" or out.shape != (m,):
            raise AssertionError(f"{tag}: request {r.request_id} state "
                                 f"{r.state}, {out.shape[0]} tokens of {m}")
        if out.min() < 0 or out.max() >= vocab:
            raise AssertionError(f"{tag}: request {r.request_id}: token "
                                 f"outside the vocabulary")


def phase_preemption(torch, seed, cfg, model):
    """Phase 3d: preemption at full Llama-3-8B width.  A 4-slot engine
    over a 160-block pool serves three priority-0 requests (512-token
    prompts, 200 new tokens: 45 blocks each); once all three decode, a
    priority-1 arrival (512 + 64: 36 blocks, 25 free) must swap one out
    to host RAM; the victim resumes when blocks retire.  The radix
    cache's demotions are off (``host_cache_blocks=0``) so every host-tier
    copy is the preemption's.  Checks: preemptions >= 1, as many resumes,
    blocks and bytes out == in, the bytes equal to the blocks times the
    arena block size, no swap parcel left, the pool audit, in-vocabulary
    outputs, resumed rows bit-equal to the host stacks, phase 3's launch
    formula.  Then the same with an int8 KV cache (codes and scale
    planes travel).  Returns the launch counts summed over both runs."""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops import KERNELS
    nl = cfg.num_hidden_layers
    total = {}
    for kv in (None, "int8"):
        torch.cuda.empty_cache()
        eng = ServingEngine(model, num_slots=4, prompt_len=512,
                            chunk_len=256, max_cache_len=1024, block_len=16,
                            num_blocks=160, host_cache_blocks=0,
                            compute_dtype="bfloat16", kv_cache_dtype=kv)
        block = _arena_block_bytes(eng)
        # a bf16 block: layers x (K, V) x 16 rows x Hkv*D x 2 bytes (8B:
        # 32 x 2 x 16 x 1024 x 2 B = 2 MiB)
        width = cfg.num_key_value_heads * cfg.head_dim
        if kv is None and block != nl * 2 * 16 * width * 2:
            raise AssertionError(f"preemption: {block} bytes a bf16 block, "
                                 f"expected {nl} x K,V x 16 x {width} x 2 B")
        swaps = []
        _swap_watch(torch, eng, swaps)
        rng = np.random.default_rng(seed + 7)
        specs = [200, 200, 200, 64]
        prompts = [rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
                   for _ in specs]
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=m)
                for p, m in zip(prompts[:3], specs[:3])]
        while any(r.state != "decode" for r in reqs):
            eng.step()
        reqs.append(eng.submit(prompts[3], max_new_tokens=specs[3],
                               priority=1))
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in KERNELS.items()}
        st = eng.stats()
        tag = f"preemption ({kv or 'bf16'} KV)"
        _finished_in_vocab(reqs, specs, cfg.vocab_size, tag)
        if not (st["preemptions"] >= 1
                and st["preempt_resumes"] == st["preemptions"]
                and st["swap_blocks_out"] == st["swap_blocks_in"] > 0
                and st["swap_bytes_out"] == st["swap_blocks_out"] * block
                and st["swap_bytes_in"] == st["swap_bytes_out"]
                and st["swap_host_blocks"] == 0 and st["blocks_in_use"] == 0):
            raise AssertionError(f"{tag}: {st}")
        if [k for k, *_ in swaps].count("in") != st["preempt_resumes"]:
            raise AssertionError(f"{tag}: {swaps} for {st}")
        eng._pool.check()
        _check_launches(launches, _serving_launches(nl, st, kv == "int8"),
                        st)
        _log(f"{tag}: 4 requests in {wall:.3f} s; preemptions "
             f"{st['preemptions']}, resumes {st['preempt_resumes']}, "
             f"{st['swap_blocks_out']} blocks out and in, "
             f"{st['swap_bytes_out'] / 2 ** 20:.1f} MiB each way "
             f"({block / 2 ** 20:.3f} MiB a block); decode steps "
             f"{st['decode_steps']}; launches {launches}")
        _log_swaps(tag, swaps)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        del eng
    torch.cuda.empty_cache()
    return total


def phase_radix_tier(torch, seed, cfg, model):
    """Phase 3e: the radix cache's host tier at full Llama-3-8B width.  A
    2-slot engine over a 40-block pool serves A (300-token prompt: 18
    cached prompt blocks), then B (512 + 97 tokens: 38 blocks, 22 free),
    whose allocation reclaims A's 16 oldest cached blocks and demotes them
    to host RAM, then C, sharing A's first 256 tokens, whose admission
    promotes those 16 blocks back.  Checks: prefix_host_hits >= 1,
    host_swapin_blocks == 16, the promoted rows bit-equal to the demoted
    parcels, the pool audit, in-vocabulary outputs, phase 3's launch
    formula.  Returns the launch counts."""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.prefixcache import host_rows
    from paddle_tpu_torch.ops import KERNELS
    nl = cfg.num_hidden_layers
    torch.cuda.empty_cache()
    eng = ServingEngine(model, num_slots=2, prompt_len=512, chunk_len=256,
                        max_cache_len=1024, block_len=16, num_blocks=40,
                        compute_dtype="bfloat16")
    swaps = []
    _swap_watch(torch, eng, swaps)
    rng = np.random.default_rng(seed + 8)
    a = rng.integers(0, cfg.vocab_size, 300).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    c = np.concatenate([a[:256], rng.integers(0, cfg.vocab_size, 64)
                        ]).astype(np.int32)
    specs = [16, 97, 32]
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(a, max_new_tokens=specs[0])]
    eng.run()
    reqs.append(eng.submit(b, max_new_tokens=specs[1]))
    eng.run()
    _m, span = eng._radix.match(c)
    span = span[:16]
    if [kind for kind, _ in span] != ["host"] * 16:
        raise AssertionError(f"radix tier: C's span {span}, expected 16 "
                             f"host-resident blocks")
    saved = [[r.copy() for r in eng._host_tier.entry(k).rows]
             for _, k in span]
    reqs.append(eng.submit(c, max_new_tokens=specs[2]))
    eng.step()                       # admission promotes, then one chunk
    dest = torch.from_numpy(np.asarray(reqs[2].blocks[:16], np.int64)).to(
        eng.device)
    for ai, arena in enumerate(eng._arenas):
        got, _ = host_rows(arena.index_select(0, dest))
        want = np.concatenate([s[ai] for s in saved], axis=0)
        if not np.array_equal(got.view(np.uint8), want.view(np.uint8)):
            raise AssertionError(f"radix tier: promoted rows of arena {ai} "
                                 f"differ from the demoted parcels")
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    st = eng.stats()
    _finished_in_vocab(reqs, specs, cfg.vocab_size, "radix tier")
    if not (st["prefix_host_hits"] >= 1 and st["host_swapin_blocks"] == 16
            and st["swap_blocks_out"] >= 16 and st["blocks_in_use"] == 0):
        raise AssertionError(f"radix tier: {st}")
    eng._pool.check()
    _check_launches(launches, _serving_launches(nl, st, False), st)
    _log(f"radix tier: 3 requests in {wall:.3f} s; demoted "
         f"{st['swap_blocks_out']} blocks, promoted "
         f"{st['host_swapin_blocks']} (host hits {st['prefix_host_hits']}), "
         f"prefix hit tokens {st['prefix_hit_tokens']}, host cache blocks "
         f"{st['host_cache_blocks']}; prefill chunks {st['prefill_chunks']}; "
         f"launches {launches}")
    _log_swaps("radix tier", swaps)
    del eng
    torch.cuda.empty_cache()
    return launches


# -- the sampled half (phases 2's sampler row, 3a's sampled graph, 3f, 4f) --

# phase 3g: the engine's registry/recorder arms, in turns (enabled,
# disabled, disabled, enabled), in the default engine and in lockstep
OBS_ARMS = (("enabled", True), ("disabled", False))
OBS_TURNS = (0, 1, 1, 0)
OBS_MODES = (("depth 1", {}), ("lockstep", dict(async_dispatch=False)))
OBS_WINDOW_STEPS = 16

# stats() keys read out of the registry, and the instrument each is
STATS_INSTRUMENTS = {
    "kv_bytes_swept": "serving.kv.bytes_swept",
    "weight_bytes_swept": "serving.weights.bytes_swept",
    "finished": "serving.requests_finished",
    "cancelled": "serving.requests_cancelled",
    "prefills": "serving.prefills",
    "prefill_chunks": "serving.prefill_chunks",
    "decode_steps": "serving.decode_steps",
    "busy_slot_steps": "serving.busy_slot_steps",
    "block_dispatches": "serving.block_dispatches",
    "prefix_hits": "serving.prefix_hits",
    "prefix_misses": "serving.prefix_misses",
    "prefix_hit_tokens": "serving.prefix.hit_tokens",
    "prefix_partial_hits": "serving.prefix.partial_hits",
    "prefix_host_hits": "serving.prefix.host_hits",
    "host_swapin_blocks": "serving.prefix.host_swapin_blocks",
    "spec_verify_steps": "serving.spec.verify_steps",
    "spec_draft_hits": "serving.spec.draft_hits",
    "spec_draft_misses": "serving.spec.draft_misses",
    "spec_draft_tokens": "serving.spec.draft_tokens",
    "spec_accepted_tokens": "serving.spec.accepted_tokens",
    "sampled_tokens": "serving.sample.sampled_tokens",
    "greedy_tokens": "serving.sample.greedy_tokens",
    "masked_tokens": "serving.sample.masked_tokens",
    "sample_resamples": "serving.sample.resamples",
    "preemptions": "serving.preempt.requests",
    "preempt_resumes": "serving.preempt.resumes",
    "swap_blocks_out": "serving.swap.blocks_out",
    "swap_blocks_in": "serving.swap.blocks_in",
    "swap_bytes_out": "serving.swap.bytes_out",
    "swap_bytes_in": "serving.swap.bytes_in",
    "shed": "serving.shed.requests",
    "timeouts": "serving.timeout.requests",
    "useful_tokens": "serving.goodput.useful_tokens",
    "wasted_tokens": "serving.goodput.wasted_tokens",
    "dispatched_tokens": "serving.goodput.dispatched_tokens",
    "handoffs": "serving.handoff.requests",
    "slo_attained": "serving.slo.attained",
    "slo_missed": "serving.slo.missed",
    "async_syncs": "serving.async.syncs",
    "async_harvests": "serving.async.harvests",
}
STATS_SECONDS = {"host_seconds": "serving.step.host_seconds",
                 "dispatch_seconds": "serving.step.dispatch_seconds",
                 "overlap_seconds": "serving.step.overlap_seconds"}


def _strip_events(events):
    """Flight events without their wall times: (seq, step, request,
    kind, attrs)."""
    return [(e.seq, e.step, e.request, e.kind,
             tuple(sorted((k, str(v)) for k, v in e.attrs.items())))
            for e in events]


def _check_ledger(tag, eng):
    """Phase 3g (b): exact goodput conservation, and ``stats()`` equal to
    the engine's private registry key for key (counters label-summed,
    the per-reason breakdowns per label, the step split's seconds to the
    histograms' sums)."""
    st, reg = eng.stats(), eng.metrics_registry
    if not (st["useful_tokens"] + st["wasted_tokens"]
            == st["dispatched_tokens"] > 0
            and st["wasted_tokens"] == sum(st["wasted_by_reason"].values())):
        raise AssertionError(f"{tag}: goodput ledger {st}")
    bad = {k: (st[k], reg.get(n).total())
           for k, n in STATS_INSTRUMENTS.items()
           if st[k] != reg.get(n).total()}
    syncs = reg.get("serving.async.syncs")
    bad.update({f"syncs[{r}]": (v, syncs.value(reason=r))
                for r, v in st["async_syncs_by_reason"].items()
                if v != syncs.value(reason=r)})
    wasted = reg.get("serving.goodput.wasted_tokens")
    bad.update({f"wasted[{r}]": (v, wasted.value(reason=r,
                                                 tenant="default"))
                for r, v in st["wasted_by_reason"].items()
                if v != wasted.value(reason=r, tenant="default")})
    bad.update({k: (st[k], reg.get(n).summary()["sum"])
                for k, n in STATS_SECONDS.items()
                if st[k] != reg.get(n).summary()["sum"]})
    if st["peak_queue"] != reg.get("serving.queue_depth").hwm():
        bad["peak_queue"] = (st["peak_queue"],
                             reg.get("serving.queue_depth").hwm())
    if bad:
        raise AssertionError(f"{tag}: stats() != registry: {bad}")
    return st


def _window_split(torch, eng, rng, vocab, profiled,
                  steps=OBS_WINDOW_STEPS, prof_steps=8):
    """A steady decode window of ``steps`` step() calls on 8 fresh
    64-token requests (every slot decoding, every step dispatching one
    decode step: depth 1 fuses nothing): the unprofiled wall per step and
    the means per step of the engine's dispatch, overlap and host seconds
    (its totals, which advance with the registry disabled too); with
    ``profiled``, ``prof_steps`` more steps under ``torch.profiler`` give
    the device busy time per step and the idle share (1 - the union of
    the device intervals over the profiled wall).  Returns (wall s,
    split, busy ms or None, idle or None)."""
    reqs = [eng.submit(rng.integers(0, vocab, 64).astype("int32"),
                       max_new_tokens=steps + prof_steps + 12)
            for _ in range(eng.num_slots)]
    while any(r.state in ("queued", "prefill") for r in reqs):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = dict(eng._time)
    w0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - w0) / steps
    split = {k: (eng._time[k] - t0[k]) / steps for k in t0}
    busy = idle = None
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            for _ in range(prof_steps):
                eng.step()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - w0
        per_kernel, _count = _profile_kernels(torch, prof)
        if per_kernel:
            busy = sum(per_kernel.values()) / 1e3 / prof_steps
            idle = 1 - _union_us(torch, prof)[0] / 1e6 / wall_prof
    live = sum(r.state == "decode" for r in reqs)
    eng.run()
    if live != eng.num_slots:
        raise AssertionError(f"observability window: {live} slots "
                             f"decoding of {eng.num_slots}")
    return wall, split, busy, idle


def _merged_trace(torch, eng, rng, vocab, steps=8):
    """Phase 3g (d): a warm decode window (the decode graph already
    captured: no capture runs under the profiler) profiled with
    ``torch.profiler``, exported as a chrome trace and merged with the
    flight recorder's lanes through ``merge_chrome_traces``.  The merged
    file's ``serving.decode_block`` ranges must number the window's
    block dispatches and its device lanes must hold the paged decode and
    RMSNorm kernels."""
    import tempfile

    from paddle_tpu_torch.observability import merge_chrome_traces
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.submit(rng.integers(0, vocab, 64).astype("int32"),
                       max_new_tokens=steps + 12)
            for _ in range(eng.num_slots)]
    while any(r.state in ("queued", "prefill") for r in reqs):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    d0 = eng.stats()["block_dispatches"]
    graphs0 = eng.stats()["decode_graphs"]["captures"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    dispatches = eng.stats()["block_dispatches"] - d0
    if eng.stats()["decode_graphs"]["captures"] != graphs0:
        raise AssertionError("merged trace: a decode graph was captured "
                             "inside the profiled window")
    eng.run()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        dev = os.path.join(tmp, "decode.pt.trace.json")
        prof.export_chrome_trace(dev)
        out = os.path.join(tmp, "merged.json")
        info = merge_chrome_traces(
            out, host=eng.flight_recorder.chrome_events(),
            device_trace_dir=dev)
        with open(out) as f:
            evs = json.load(f)["traceEvents"]
    spans = [e for e in evs if e.get("name") == "serving.decode_block"
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    kernels = [e["name"] for e in evs if e.get("cat") == "kernel"]
    paged = sum("PagedWalk" in n for n in kernels)
    rms = sum("rms_norm" in n for n in kernels)
    lanes = sum(1 for e in evs if e.get("pid") == 0
                and str(e.get("name", "")).startswith("flightrec."))
    if len(spans) != dispatches or not paged or not rms or not lanes:
        raise AssertionError(
            f"merged trace: {len(spans)} serving.decode_block ranges for "
            f"{dispatches} block dispatches, {paged} paged decode and "
            f"{rms} RMSNorm kernels, {lanes} flight-recorder events; "
            f"{info}")
    if not all(int(e["args"]["steps"]) >= 1 for e in spans):
        raise AssertionError(f"merged trace: span attrs {spans[:2]}")
    _log(f"observability (d): merged trace {info['host_events']} host "
         f"events ({lanes} flight-recorder instants), "
         f"{info['device_events']} profiler events in "
         f"{info['device_processes']} processes; {len(spans)} "
         f"serving.decode_block ranges = {dispatches} block dispatches of "
         f"the window; device lanes: {paged} paged decode and {rms} "
         f"RMSNorm kernels")
    return info


def _fault_trace(torch, seed, cfg, model):
    """Phase 3g (e): faults at 8B width, modelled on phase 3d.  A 4-slot
    engine over a 160-block pool with its own ``FaultInjector``: a
    request that leaves its 32 prompt blocks cached, then three 512 +
    200-token requests (45 blocks each) whose first allocation fails and
    whose pressure demotes cached blocks to the host tier; once all three
    decode, a forced swap and a 50 ms stall in one step, then a tier
    eviction; every request finishes.  Then a poisoned harvest at a fixed
    step raises ``PoisonedDispatchError``.  Holds: the fired faults, the
    pool audit after each, ``serving.fault.stall_seconds`` >= 0.05 s with
    the stalled step's host seconds below the stall, in-vocabulary
    outputs, no poisoned token adopted, and the path's kernels
    launched."""
    import numpy as np
    from paddle_tpu_torch.inference import (FaultInjector,
                                            PoisonedDispatchError,
                                            ServingEngine)
    from paddle_tpu_torch.observability import (FlightRecorder,
                                                MetricsRegistry)
    fi = FaultInjector()
    torch.cuda.empty_cache()
    eng = ServingEngine(model, num_slots=4, prompt_len=512, chunk_len=256,
                        max_cache_len=1024, block_len=16, num_blocks=160,
                        compute_dtype="bfloat16", fault_injector=fi,
                        registry=MetricsRegistry(),
                        flight_recorder=FlightRecorder())
    rng = np.random.default_rng(seed + 21)
    prompts = [rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
               for _ in range(4)]
    _zero_launches()
    warm = eng.submit(prompts[3], max_new_tokens=16)
    eng.run()
    fi.fail_allocs(1)
    reqs = [eng.submit(p, max_new_tokens=200) for p in prompts[:3]]
    while any(r.state != "decode" for r in reqs):
        eng.step()
    host0 = eng._time["host"]
    fi.force_swap(reqs[0].request_id)
    fi.stall_steps(1, 0.05)
    eng.step()
    stalled_host = eng._time["host"] - host0
    fi.force_tier_evicts(4)
    eng.run()
    eng._pool.check()
    st = eng.stats()
    stall = eng.metrics_registry.get(
        "serving.fault.stall_seconds").summary()
    _finished_in_vocab([warm] + reqs, [16, 200, 200, 200], cfg.vocab_size,
                       "fault trace")
    fired = [k for k, _ in fi.events]
    if not (fired.count("alloc_fail") == 1 and "forced_swap" in fired
            and "stall" in fired and "tier_evict" in fired
            and st["preemptions"] >= 1
            and st["preempt_resumes"] == st["preemptions"]
            and stall["count"] == 1 and stall["sum"] >= 0.05
            and stalled_host < 0.05):
        raise AssertionError(
            f"fault trace: fired {fi.events}, stall {stall}, stalled step's "
            f"host {stalled_host:.6f} s, stats {st}")
    _check_ledger("fault trace", eng)
    counts = _launched("fault trace", ("rms_norm", "paged_decode_attention"))
    # a poisoned harvest: raised before its outputs become host truth
    more = [eng.submit(p[:128], max_new_tokens=24) for p in prompts[:2]]
    while any(r.state != "decode" for r in more):
        eng.step()
    fi.poison_at_step(eng._step_idx + 2)
    before = [list(r.tokens) for r in more]
    raised, steps = None, 0
    while raised is None and steps < 6:
        before = [list(r.tokens) for r in more]
        try:
            eng.step()
        except PoisonedDispatchError as e:
            raised = e
        steps += 1
    eng._pool.check()
    if raised is None or [list(r.tokens) for r in more] != before \
            or any(not 0 <= t < cfg.vocab_size
                   for r in more for t in r.tokens) \
            or ("poison", None) not in fi.events:
        raise AssertionError(f"fault trace: poison at step "
                             f"{eng._step_idx}: {raised!r}, {fi.events}")
    _log(f"observability (e): fault trace at 8B width (4 slots, 160 "
         f"blocks): fired {[k for k, _ in fi.events]}; preemptions "
         f"{st['preemptions']}, resumes {st['preempt_resumes']}, "
         f"{st['swap_blocks_out']} blocks out; stall "
         f"{stall['sum'] * 1e3:.3f} ms in serving.fault.stall_seconds, the "
         f"stalled step's host {stalled_host * 1e3:.3f} ms; survivors "
         f"finished; then PoisonedDispatchError at step {eng._step_idx} "
         f"({raised}), streams untouched, pool audit clean; launches "
         f"{counts}")
    del eng
    torch.cuda.empty_cache()


def phase_observability(torch, seed, cfg, model, want_tokens):
    """Phase 3g: the metrics registry, the flight recorder, spans, the
    goodput ledger and the fault injector on phase 3's model and trace.

    (a) Two arms, in turns, twice each, in the default engine (dispatch-
    ahead at depth 1) and in lockstep: a private enabled
    ``MetricsRegistry`` with an enabled ``FlightRecorder``, and both
    disabled.  Every run's tokens equal phase 3's; the enabled runs hold
    phase 3's launch formula and the disabled ones launch the same.  Each
    run then times ``OBS_WINDOW_STEPS`` steady decode steps (the step's
    wall and the means of its dispatch, overlap and host seconds), and
    each arm's first run profiles a decode window (device busy time).
    The enabled-vs-disabled overhead is the relative difference of the
    arms' mean step walls.  (b) Each enabled run's ledger conserves
    exactly and ``stats()`` equals its registry key for key.  (c) The two
    enabled runs of a mode give equal flight records modulo wall.  (d)
    The merged trace (``_merged_trace``) on the first enabled depth-1
    engine.  (e) The fault trace (``_fault_trace``).  Returns the launch
    counts of the first enabled depth-1 run."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.observability import (FlightRecorder,
                                                MetricsRegistry)
    nl = cfg.num_hidden_layers
    path_launches, summary = None, []
    for mode_tag, mode in OBS_MODES:
        walls = {tag: [] for tag, _ in OBS_ARMS}
        records, on_launches = [], None
        for turn, ai in enumerate(OBS_TURNS):
            tag, on = OBS_ARMS[ai]
            torch.cuda.empty_cache()
            eng = ServingEngine(model, num_slots=8, prompt_len=512,
                                chunk_len=256, max_cache_len=1024,
                                block_len=16, compute_dtype="bfloat16",
                                registry=MetricsRegistry(enabled=on),
                                flight_recorder=FlightRecorder(enabled=on),
                                **mode)
            launches, st, wall, n_req, n_tok, rng, reqs = _serve_trace(
                torch, eng, cfg, seed, check_hits=on)
            name = f"observability [{mode_tag}, {tag}, turn {turn + 1}]"
            if [r.output.tolist() for r in reqs] != want_tokens:
                raise AssertionError(f"{name}: tokens differ from phase 3")
            if on:
                _check_launches(launches, _serving_launches(nl, st, False),
                                st)
                if on_launches is None:
                    on_launches = launches
                st = _check_ledger(name, eng)
                records.append(_strip_events(eng.flight_recorder.events()))
                if path_launches is None:
                    path_launches = launches
            elif launches != on_launches:
                raise AssertionError(f"{name}: launches {launches} != the "
                                     f"enabled arm's {on_launches}")
            elif any(st[k] for k in ("decode_steps", "finished")) or \
                    eng.flight_recorder.events():
                raise AssertionError(f"{name}: a disabled registry or "
                                     f"recorder recorded: {st}")
            step_wall, split, busy_ms, idle = _window_split(
                torch, eng, rng, cfg.vocab_size,
                profiled=OBS_TURNS.index(ai) == turn)
            walls[tag].append(step_wall)
            busy = ("" if OBS_TURNS.index(ai) != turn else
                    "; device busy not measured (the profiler recorded no "
                    "CUDA kernel)" if busy_ms is None else
                    f"; profiled: device busy {busy_ms:.3f} ms/step, idle "
                    f"{100 * idle:.1f}% of the profiled wall")
            if on and mode_tag == "depth 1" and turn == 0:
                _merged_trace(torch, eng, rng, cfg.vocab_size)
            ledger = (f"useful {st['useful_tokens']} + wasted "
                      f"{st['wasted_tokens']} = dispatched "
                      f"{st['dispatched_tokens']} tokens "
                      f"({dict((k, v) for k, v in st['wasted_by_reason'].items() if v)}), "
                      if on else "")
            _log(f"{name}: {n_req} requests, {n_tok} tokens in {wall:.3f} s "
                 f"= {n_tok / wall:.2f} tokens/s; {ledger}decode window "
                 f"{OBS_WINDOW_STEPS} steps: wall {step_wall * 1e3:.3f} "
                 f"ms/step, means per step: dispatch "
                 f"{split['dispatch'] * 1e3:.3f} ms, overlap "
                 f"{split['overlap'] * 1e3:.3f} ms, host "
                 f"{split['host'] * 1e3:.3f} ms{busy}")
            del eng
        if records[0] != records[1]:
            diff = next(i for i, (a, b) in enumerate(zip(*records))
                        if a != b) if len(records[0]) == len(records[1]) \
                else "length"
            raise AssertionError(f"observability [{mode_tag}]: the enabled "
                                 f"runs' flight records differ ({diff})")
        on_ms = statistics.mean(walls["enabled"]) * 1e3
        off_ms = statistics.mean(walls["disabled"]) * 1e3
        summary.append(f"{mode_tag}: enabled {on_ms:.3f} ms/step, disabled "
                       f"{off_ms:.3f} ms/step, overhead "
                       f"{100 * (on_ms - off_ms) / off_ms:+.2f}% "
                       f"(walls {[round(w * 1e3, 3) for w in walls['enabled']]}"
                       f" vs {[round(w * 1e3, 3) for w in walls['disabled']]})"
                       f"; the enabled runs' {len(records[0])} flight events "
                       f"equal modulo wall")
    torch.cuda.empty_cache()
    _log("observability (a, c): " + "; ".join(summary))
    _fault_trace(torch, seed, cfg, model)
    return path_launches


# the depth of the exactness phases whose CPU half serves a whole trace
# (3g (f), 4f, 4j): 1 layer at 8B width, cut from phase 4's 4 for the
# smoke's time (ROADMAP.md)
EXACT_CPU_LAYERS = 1


def phase_observability_exactness(torch, seed):
    """Phase 3g (f): phase 4d's preemption trace (a) on a 1-layer float32
    model at 8B width (``EXACT_CPU_LAYERS``), TF32 off, on the card and,
    from the same state dict, on the CPU, each engine with a private
    registry and an enabled flight recorder: the two flight records are
    equal modulo wall, and so are the goodput ledgers and every counter
    of the two registries.  (No EOS is configured, so the schedule, the
    events and the ledger do not depend on the tokens; the tokens are
    phase 4d's business.)"""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.observability import (FlightRecorder,
                                                MetricsRegistry)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, gpu = _build_8b(torch, EXACT_CPU_LAYERS, "float32", seed + 1)
    cpu = LlamaForCausalLM(cfg, device="cpu", init=False)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(seed + 9)
    pa = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
          for n, m in ((40, 60), (17, 5), (64, 9))]
    kw = dict(num_slots=2, num_blocks=9, prompt_len=64, chunk_len=32,
              max_cache_len=128, block_len=16, compute_dtype="float32")
    runs = {}
    for where, model in (("card", gpu), ("cpu", cpu)):
        if where == "card":
            _zero_launches()
        t0 = time.perf_counter()
        eng = ServingEngine(model, device=None if where == "card" else "cpu",
                            registry=MetricsRegistry(),
                            flight_recorder=FlightRecorder(), **kw)
        reqs = [eng.submit(ids, max_new_tokens=m) for ids, m in pa[:2]]
        while reqs[1].state != "finished":
            eng.step()
        reqs.append(eng.submit(pa[2][0], max_new_tokens=pa[2][1],
                               priority=1))
        eng.run()
        eng._pool.check()
        runs[where] = (eng, _check_ledger(f"card vs CPU ({where})", eng),
                       time.perf_counter() - t0)
        if where == "card":
            counts = _launched("card vs CPU", ("rms_norm",
                                               "paged_decode_attention"))
    (ge, gst, gwall), (ce, cst, cwall) = runs["card"], runs["cpu"]
    if gst["preemptions"] < 1:
        raise AssertionError(f"card vs CPU: no preemption: {gst}")
    gev = _strip_events(ge.flight_recorder.events())
    if gev != _strip_events(ce.flight_recorder.events()):
        raise AssertionError("card vs CPU: flight records differ")
    ledger = ("useful_tokens", "wasted_tokens", "dispatched_tokens",
              "wasted_by_reason")
    if any(gst[k] != cst[k] for k in ledger):
        raise AssertionError(f"card vs CPU: ledgers differ: "
                             f"{[(k, gst[k], cst[k]) for k in ledger]}")
    greg, creg = ge.metrics_registry, ce.metrics_registry
    bad = [n for n in greg.names()
           if greg.get(n)._snap()["type"] == "counter"
           and greg.get(n)._snap() != creg.get(n)._snap()]
    if bad:
        raise AssertionError(f"card vs CPU: counters differ: {bad}")
    _log(f"observability (f): phase 4d's trace (a) on the card "
         f"({gwall:.2f} s) and the CPU ({cwall:.2f} s), "
         f"{cfg.num_hidden_layers} layers float32 "
         f"at 8B width: {len(gev)} flight events equal modulo wall, "
         f"ledgers equal (useful {gst['useful_tokens']}, wasted "
         f"{gst['wasted_tokens']}, dispatched {gst['dispatched_tokens']}), "
         f"every counter equal; {gst['preemptions']} preemption; launches "
         f"{counts}")
    del ge, ce, gpu, cpu
    torch.cuda.empty_cache()


def _cycle_dfa(np, vocab, seed, states=4, width=2048):
    """A ``[states, vocab]`` DFA over a token subset that never ends:
    state s allows ``width`` tokens of its own random subset and moves to
    state s + 1 (mod ``states``)."""
    rng = np.random.default_rng(seed)
    t = np.full((states, vocab), -1, np.int32)
    for s in range(states):
        t[s, rng.choice(vocab, width, replace=False)] = (s + 1) % states
    return t


def _sampled_mix(np, vocab, seed):
    """The eight per-request configurations of phase 3f (fresh mask
    processors on every call: they are stateful): 2 greedy, 2 seeded at
    T=0.8, one at top_k=50 top_p=0.9, one with repetition_penalty=1.2,
    one under a DFA token mask and one seedless at top_p=0.95."""
    from paddle_tpu_torch.inference import DfaTokenMask, SamplingParams
    return [None, None,
            SamplingParams(temperature=0.8, seed=seed + 1),
            SamplingParams(temperature=0.8, seed=seed + 2),
            SamplingParams(top_k=50, top_p=0.9, seed=seed + 3),
            SamplingParams(repetition_penalty=1.2, seed=seed + 4),
            SamplingParams(temperature=0.8, seed=seed + 5,
                           mask_processor=DfaTokenMask(
                               _cycle_dfa(np, vocab, seed))),
            SamplingParams(top_p=0.95)]


def _planes_on_card(torch, np, rng, b, vocab, dev, flags):
    """Sampling planes of every flag in ``flags`` for ``b`` rows on the
    card: random keys and positions, a greedy/sampled mix, top-k and
    top-p rows, penalties, a random presence plane and mask bias."""
    from paddle_tpu_torch.inference.sampling import MASK_BIAS
    sampled, _f, penalty, bias = flags
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    planes = {}
    if sampled:
        planes.update(
            base=as_t(rng.integers(0, 2 ** 32, (b, 2)).astype(np.int64)),
            pos=as_t(rng.integers(0, 500, b).astype(np.int64)),
            temp=as_t(np.where(np.arange(b) % 2, 0.8, 1.0).astype(
                np.float32)),
            top_k=as_t(np.where(np.arange(b) % 3 == 0, 50, 0).astype(
                np.int64)),
            top_p=as_t(np.where(np.arange(b) % 4 == 1, 0.9, 1.0).astype(
                np.float32)),
            greedy=as_t(np.arange(b) % 4 == 3))
    if penalty:
        planes.update(rep=as_t(np.full(b, 1.2, np.float32)),
                      presence=as_t(rng.random((b, vocab)) < 0.01))
    if bias:
        banned = rng.random((b, vocab)) < 0.5
        banned[:, 0] = False
        planes["bias"] = as_t(np.where(banned, MASK_BIAS, 0.0).astype(
            np.float32))
    return planes


def phase_sampler(torch, seed):
    """Phase 2's sampler row: the threefry bits and uniforms of 8 keys over
    ``[8, 128256]`` on the card bit-equal to the same call on the CPU;
    ``categorical_rows`` over 65536 positions of one fixed 16-token row
    against its softmax by a chi-square test at the 0.999 quantile; and
    ``sample_rows`` alone at one decode step's shape (bf16 logits
    ``[8, 128256]``) timed in the greedy, the sampled and the sampled +
    filtered buckets (CUDA events), eagerly (a few hundred launches, so
    the host's launch gaps count) and as a captured CUDA graph (device
    time, as inside the decode block's graph)."""
    import numpy as np
    from scipy.stats import chi2
    from paddle_tpu_torch.inference import sampling, threefry
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 41)
    keys = rng.integers(0, 2 ** 32, (8, 2)).astype(np.int64)
    kc, kg = torch.from_numpy(keys), torch.from_numpy(keys).to(dev)
    shape = (128256,)
    bits_c = threefry.random_bits(kc, shape)
    bits_g = threefry.random_bits(kg, shape)
    u_c = threefry.uniform(kc, shape)
    u_g = threefry.uniform(kg, shape)
    torch.cuda.synchronize()
    if not torch.equal(bits_g.cpu(), bits_c):
        raise AssertionError("sampler: threefry bits on the card differ "
                             "from the CPU's")
    if not torch.equal(u_g.cpu().view(torch.int32), u_c.view(torch.int32)):
        raise AssertionError("sampler: uniforms on the card differ from "
                             "the CPU's")
    n, v = 65536, 16
    row = torch.linspace(-2.0, 2.0, v)
    base = threefry.as_key(threefry.prng_key(seed)).to(dev).expand(n, 2)
    ks = sampling._fold_keys(base, torch.arange(n, device=dev), 1)
    draws = sampling.categorical_rows(row.to(dev).expand(n, v).contiguous(),
                                      ks)
    counts = torch.bincount(draws.long(), minlength=v).cpu().double()
    expect = torch.softmax(row.double(), 0) * n
    stat = float(((counts - expect) ** 2 / expect).sum())
    limit = float(chi2.ppf(0.999, v - 1))
    if not stat < limit:
        raise AssertionError(f"sampler: chi-square {stat:.2f} over {n} "
                             f"draws >= the 0.999 quantile {limit:.2f}")
    logits = torch.randn(8, 128256, device=dev).to(torch.bfloat16)
    times = {}
    for tag, flags in (("greedy", sampling.NO_FLAGS),
                       ("sampled", (True, False, False, False)),
                       ("sampled + filtered", (True, True, False, False))):
        planes = _planes_on_card(torch, np, rng, 8, 128256, dev, flags)

        def fn():
            return sampling.sample_rows(logits, planes, flags)
        eager = _time_ms(torch, fn)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        times[tag] = (eager, _time_ms(torch, graph.replay))
        del graph
    _log(f"sampler: threefry bits and uniforms over [8, 128256] bit-equal "
         f"card vs CPU; categorical_rows over {n} draws of one 16-token row: "
         f"chi-square {stat:.2f} < {limit:.2f} (0.999 quantile, {v - 1} "
         f"dof); sample_rows [8, 128256] bf16 alone, eager / as a graph: "
         + ", ".join(f"{k} {e:.4f} / {g:.4f} ms"
                     for k, (e, g) in times.items()))
    return times


def phase_sampled_graph(torch, seed, cfg, model):
    """Phase 3a, sampled: the decode block graph with all four sampling
    flags on (a greedy/sampled mix with top-k, top-p, penalties, a
    presence plane and a mask bias) against the eager
    ``decode_block_carries`` on the same inputs and copies of the same
    arenas, n = 1 and 2: tokens, carries, ``pos``, ``presence`` and every
    arena bit-equal, and one replay counting the launches of one eager
    block."""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.llm import decode_block_carries
    from paddle_tpu_torch.ops import KERNELS
    rng = np.random.default_rng(seed + 12)
    flags = (True, True, True, True)
    torch.cuda.empty_cache()
    eng = ServingEngine(model, num_slots=8, prompt_len=512, chunk_len=256,
                        max_cache_len=1024, block_len=16,
                        compute_dtype="bfloat16")
    for n in (1, 2):
        inputs = _graph_inputs(torch, eng, rng, cfg.vocab_size)
        planes = _planes_on_card(torch, np, rng, 8, cfg.vocab_size,
                                 eng.device, flags)
        t0 = time.perf_counter()
        prog = eng._block_program(n, flags)
        torch.cuda.synchronize()
        t_cap = time.perf_counter() - t0
        copies = [a.clone() for a in eng._arenas]
        _zero_launches()
        want = decode_block_carries(model, eng.cfg, n, *inputs, copies,
                                    samp={k: v.clone()
                                          for k, v in planes.items()},
                                    flags=flags)
        torch.cuda.synchronize()
        eager = {k: v.launches for k, v in KERNELS.items()}
        _zero_launches()
        got = prog(*inputs, samp=planes)
        torch.cuda.synchronize()
        replay = {k: v.launches for k, v in KERNELS.items()}
        got = tuple(got) + (prog.pos, prog.presence)
        for name, g, w in zip(("toks", "tok", "lens", "done", "budget",
                               "pos", "presence"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"sampled graph vs eager (n={n}): "
                                     f"{name} differ")
        for i, (a, c) in enumerate(zip(eng._arenas, copies)):
            if not torch.equal(a.view(torch.uint8), c.view(torch.uint8)):
                raise AssertionError(f"sampled graph vs eager (n={n}): "
                                     f"arena {i} differs")
        if replay != eager or not any(eager.values()):
            raise AssertionError(f"sampled graph vs eager (n={n}): "
                                 f"launches {replay} != {eager}")
        _log(f"sampled graph vs eager (all four flags, bf16, B=8, n={n}): "
             f"tokens, carries, pos, presence and {len(copies)} arenas "
             f"bit-equal; capture {t_cap * 1e3:.1f} ms; launches per replay "
             f"{ {k: v for k, v in replay.items() if v} }")
        del copies
    del eng
    torch.cuda.empty_cache()


# phase 3f's trace: (prompt length, max_new_tokens) of the 8 requests of
# _sampled_mix, in slot order; the penalty row (5) rides before the mask
# row (6) and finishes first, so both forced-sync reasons are charged
SAMPLED_TRACE = [(384, 32), (64, 64), (512, 16), (200, 48), (130, 24),
                 (450, 40), (96, 56), (320, 20)]


def _sampled_trace(torch, eng, cfg, prompts, mix, specs=None,
                   spec_decode=None):
    """One run of a sampled trace: the launch counters set to 0 just
    before and read just after.  Every request must finish with
    in-vocabulary tokens.  Returns (launches, stats, wall, requests)."""
    from paddle_tpu_torch.ops import KERNELS
    specs = SAMPLED_TRACE if specs is None else specs
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(ids, max_new_tokens=m, sampling=sp,
                       spec_decode=spec_decode)
            for ids, (_n, m), sp in zip(prompts, specs, mix)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    _finished_in_vocab(reqs, [m for _, m in specs], cfg.vocab_size,
                       "sampled serving")
    return launches, eng.stats(), wall, reqs


def _legal_under_dfa(table, out, tag):
    s = 0
    for t in out:
        nxt = int(table[s, int(t)])
        if nxt < 0:
            raise AssertionError(f"{tag}: token {int(t)} illegal in DFA "
                                 f"state {s}")
        s = nxt


def _add_launches(total, launches):
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def phase_sampled_serving(torch, seed, cfg, model, greedy_prof):
    """Phase 3f: sampled serving at full Llama-3-8B width (phase 3's
    model, bf16, 8 slots at the defaults).  The 8 requests of
    ``_sampled_mix`` (``SAMPLED_TRACE``) run in phase 3's three arms in
    turns, twice each: the tokens of every request equal across all six
    runs, the greedy rows' tokens equal an all-greedy engine's on the
    same prompts, every token in the vocabulary, the mask row's tokens
    legal under its DFA, the launch formula of phase 3 (the sampler
    launches no counted kernel), no forced sync in the lockstep arm and
    the same syncs by reason in both runs of an arm, ``mask`` and
    ``penalty`` among them.  The first depth-1 run logs a profiled decode
    window against phase 3's greedy one (``greedy_prof``) and runs the
    sync-debug window on a sampled mix.  Then one int8 KV + int8 W run of
    the mix and one sampled spec run (spec_decode=4, a ModelDrafter over
    the target, T=0.8).  Returns the launch counts summed over every
    run."""
    import numpy as np
    from paddle_tpu_torch.inference import (ModelDrafter, SamplingParams,
                                            ServingEngine)
    nl = cfg.num_hidden_layers
    rng = np.random.default_rng(seed + 17)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _m in SAMPLED_TRACE]
    kw = dict(num_slots=8, prompt_len=512, chunk_len=256, max_cache_len=1024,
              block_len=16, compute_dtype="bfloat16")
    total = {}
    torch.cuda.empty_cache()
    ref = ServingEngine(model, **kw)
    _, _, _, greedy_reqs = _sampled_trace(
        torch, ref, cfg, prompts, [None] * len(prompts))
    del ref
    tokens, syncs = None, {}
    table = _cycle_dfa(np, cfg.vocab_size, seed)
    for turn, ai in enumerate(SERVING_TURNS):
        tag, arm = SERVING_ARMS[ai]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(model, **kw, **arm)
        mix = _sampled_mix(np, cfg.vocab_size, seed)
        launches, st, wall, reqs = _sampled_trace(torch, eng, cfg, prompts,
                                                  mix)
        peak = torch.cuda.max_memory_allocated()
        _check_launches(launches, _serving_launches(nl, st, False), st)
        _add_launches(total, launches)
        outs = [r.output.tolist() for r in reqs]
        if tokens is None:
            tokens = outs
            for i, sp in enumerate(mix):
                if sp is None and outs[i] != greedy_reqs[i].output.tolist():
                    raise AssertionError(
                        f"sampled serving: greedy row {i} differs from the "
                        f"all-greedy engine's")
            _legal_under_dfa(table, reqs[6].output, "sampled serving")
        elif outs != tokens:
            raise AssertionError(f"sampled serving: the {tag} arm's tokens "
                                 f"(turn {turn + 1}) differ from the first "
                                 f"run's")
        by = {k: v for k, v in st["async_syncs_by_reason"].items() if v}
        if ai == 0 and by:
            raise AssertionError(f"sampled serving: the lockstep arm "
                                 f"charged syncs {by}")
        if ai != 0 and not (by.get("mask") and by.get("penalty")):
            raise AssertionError(f"sampled serving [{tag}]: syncs {by} lack "
                                 f"mask or penalty")
        if syncs.setdefault(tag, by) != by:
            raise AssertionError(f"sampled serving [{tag}]: syncs {by} != "
                                 f"{syncs[tag]} in the arm's other run")
        g = st["decode_graphs"]
        _log_serving(f"sampled serving [{tag}, turn {turn + 1}]",
                     len(reqs), sum(m for _, m in SAMPLED_TRACE), wall, st,
                     launches,
                     f"sampled / greedy / masked tokens "
                     f"{st['sampled_tokens']} / {st['greedy_tokens']} / "
                     f"{st['masked_tokens']}; syncs {by or 'none'}; decode "
                     f"graphs {g['captures']} captured in "
                     f"{g['capture_seconds'] * 1e3:.1f} ms, {g['replays']} "
                     f"replays; peak memory {peak / 2 ** 30:.2f} GiB; ")
        if turn == 1:
            # the whole mix (its mask and penalty rows sync every step),
            # then the rows whose harvests defer (the sampler's device
            # cost with the host hidden)
            deferrable = [None, SamplingParams(temperature=0.8, seed=1),
                          SamplingParams(top_k=50, top_p=0.9, seed=2),
                          SamplingParams(top_p=0.95)] * 2
            for what, mixf in (
                    ("the mix", lambda: _sampled_mix(np, cfg.vocab_size,
                                                     seed + 7)),
                    ("deferrable rows (no mask, no penalty)",
                     lambda: list(deferrable))):
                prof = _profile_decode(torch, eng, rng, cfg.vocab_size,
                                       sampling=mixf)
                if prof is None or greedy_prof is None:
                    continue
                _log(f"sampled serving [depth 1, {what}]: unprofiled decode "
                     f"step {prof['wall_ms']:.3f} ms against the greedy "
                     f"arm's {greedy_prof['wall_ms']:.3f} ms "
                     f"({prof['wall_ms'] / greedy_prof['wall_ms']:.3f} x); "
                     f"device busy {prof['busy_ms']:.3f} against "
                     f"{greedy_prof['busy_ms']:.3f} ms a step; idle "
                     f"{100 * prof['idle']:.1f}% against "
                     f"{100 * greedy_prof['idle']:.1f}%; sampler kernels "
                     f"ms/step (sampled / greedy): "
                     + ", ".join(
                         f"{k} {prof['groups'][k]:.3f} / "
                         f"{greedy_prof['groups'][k]:.3f}"
                         for k in prof["groups"]))
            _sync_debug_window(torch, eng, rng, cfg.vocab_size,
                               sampling=list(deferrable))
        del eng
    _log(f"sampled serving: the {len(SERVING_TURNS)} runs of "
         f"{len(SERVING_ARMS)} arms gave equal tokens; greedy rows equal "
         f"the all-greedy engine's; the mask row legal under its DFA")
    torch.cuda.empty_cache()
    eng = ServingEngine(model, kv_cache_dtype="int8", weight_dtype="int8",
                        **kw)
    launches, st, wall, reqs = _sampled_trace(
        torch, eng, cfg, prompts, _sampled_mix(np, cfg.vocab_size, seed))
    forwards = st["prefill_chunks"] + st["decode_steps"]
    want = {name: 0 for name in launches}
    want.update({"rms_norm": (2 * nl + 1) * forwards,
                 "quantized_matmul": 7 * nl * forwards,
                 "paged_decode_attention_int8": nl * st["decode_steps"]})
    _check_launches(launches, want, st)
    _legal_under_dfa(table, reqs[6].output, "sampled serving int8")
    _add_launches(total, launches)
    _log_serving("sampled serving int8 KV + int8 weights", len(reqs),
                 sum(m for _, m in SAMPLED_TRACE), wall, st, launches,
                 f"syncs { {k: v for k, v in st['async_syncs_by_reason'].items() if v} }; ")
    del eng
    torch.cuda.empty_cache()
    dkw = dict(max_context=SPEC["max_context"], max_draft=SPEC["k"],
               compute_dtype="bfloat16")
    eng = ServingEngine(model, drafter=ModelDrafter(model, **dkw), **kw)
    srng = np.random.default_rng(seed + 19)
    sprompts = [srng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n, _m in SPEC_TRACE_SHORT]
    mix = [SamplingParams(temperature=0.8, seed=seed + i)
           for i in range(len(sprompts))]
    launches, st, wall, reqs = _sampled_trace(
        torch, eng, cfg, sprompts, mix, specs=SPEC_TRACE_SHORT,
        spec_decode=SPEC["k"])
    _check_launches(launches, _spec_launches(nl, st, nl), st)
    if not st["spec_verify_steps"] or st["sampled_tokens"] <= 0:
        raise AssertionError(f"sampled spec: no sampled verify ran: {st}")
    _add_launches(total, launches)
    n_tok = sum(m for _, m in SPEC_TRACE_SHORT)
    _log(f"sampled spec (drafter = target, T=0.8, spec_decode={SPEC['k']}): "
         f"{len(reqs)} requests, {n_tok} tokens in {wall:.3f} s = "
         f"{n_tok / wall:.2f} tokens/s; mean TTFT "
         f"{st['mean_ttft_s'] * 1e3:.2f} ms; verify step "
         f"{st['verify_seconds'] / st['spec_verify_steps'] * 1e3:.3f} ms over "
         f"{st['spec_verify_steps']} verifies; acceptance "
         f"{st['spec_acceptance_rate']:.3f}, mean accepted "
         f"{st['spec_mean_accepted_len']:.3f} per verify; sample_resamples "
         f"{st['sample_resamples']}; launches {launches}")
    del eng
    torch.cuda.empty_cache()
    return total


def _sampled_margins(torch, lg, req):
    """Per output position of a CPU request: the top-two margin of the
    scores that decide it (teacher-forced CPU logits ``lg`` [n, V],
    processed as the engine does, / T, filtered, plus the Gumbel noise of
    the request's key at that position; greedy rows: the processed
    logits)."""
    import numpy as np
    from paddle_tpu_torch.inference import sampling, threefry
    from paddle_tpu_torch.models.generation import filter_top_k_top_p
    sp = req.sampling or sampling.GREEDY
    ids = req.prompt[:req.seq_len]
    out = req.output
    mp = sp.mask_processor
    state = mp.start_state if mp is not None else None
    v = lg.shape[-1]
    margins = np.zeros(len(out))
    for t in range(len(out)):
        row = lg[t:t + 1].float()
        if sp.needs_penalty:
            pres = torch.zeros((1, v), dtype=torch.bool)
            pres[0, torch.from_numpy(ids.astype(np.int64))] = True
            pres[0, torch.from_numpy(out[:t].astype(np.int64))] = True
            rep = torch.full_like(row, sp.repetition_penalty)
            row = torch.where(pres, torch.where(row > 0, row / rep,
                                                row * rep), row)
        if mp is not None:
            allowed = torch.from_numpy(mp.table[state] >= 0)
            row = row + torch.where(allowed, 0.0, sampling.MASK_BIAS)
            state = int(mp.table[state, int(out[t])])
        if not sp.is_greedy:
            temp, top_k, top_p, _g = sampling.row_planes(sp)
            row = row / torch.full_like(row, temp)
            if top_k > 0 or top_p < 1.0:
                row = filter_top_k_top_p(row, torch.tensor([top_k]),
                                         torch.tensor([top_p]))
            key = sampling._fold_keys(threefry.as_key(req.samp_base[None]),
                                      torch.tensor([t]), 1)
            row = row + threefry.gumbel(key, (v,))
        top2 = row[0].topk(2).values
        margins[t] = float(top2[0] - top2[1])
    return margins


def _generate_margins(torch, lg, kw, seed):
    """Per generated position of a batch-1 ``generate(do_sample=True)``:
    the top-two margin of the scores that decide it (teacher-forced CPU
    logits ``lg`` [n, V] / T, filtered as ``sample_token`` filters, plus
    the Gumbel noise of that step's key: ``PRNGKey(seed)`` split into the
    first token's key and the loop's, the loop's split once a step)."""
    import numpy as np
    from paddle_tpu_torch.inference import threefry
    from paddle_tpu_torch.models.generation import filter_top_k_top_p
    key0, keyr = threefry.split(threefry.as_key(threefry.prng_key(seed)))
    keys = [key0]
    for _ in range(lg.shape[0] - 1):
        kt, keyr = threefry.split(keyr)
        keys.append(kt)
    margins = np.zeros(lg.shape[0])
    for t, key in enumerate(keys):
        row = lg[t:t + 1].float()
        row = row / torch.full_like(row, kw["temperature"])
        row = filter_top_k_top_p(row, torch.tensor([kw["top_k"]]),
                                 torch.tensor([kw["top_p"]]))
        row = row + threefry.gumbel(key, tuple(row.shape))
        top2 = row[0].topk(2).values
        margins[t] = float(top2[0] - top2[1])
    return margins


def phase_sampled_exactness(torch, seed):
    """Phase 4f: a 1-layer float32 model at 8B width serves a sampled mix
    (greedy, seeded T=0.8, top-k/top-p, a repetition penalty, a DFA mask)
    through a 5-slot engine on the card and, from the same state dict, on
    the CPU: the card's tokens equal the CPU's up to each request's first
    position whose CPU top-two decisive margin is <= 0.01 (teacher-forced
    CPU logits, processed, tempered, filtered, plus the request's Gumbel
    noise), and the kernels of the path launched; then
    ``generate(do_sample=True)`` (temperature, top-k and top-p) of the same
    model on the card against the CPU, under the same rule."""
    import numpy as np
    from paddle_tpu_torch.inference import (DfaTokenMask, SamplingParams,
                                            ServingEngine)
    from paddle_tpu_torch.models import LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, gpu = _build_8b(torch, EXACT_CPU_LAYERS, "float32", seed + 13)
    cpu = LlamaForCausalLM(cfg, device="cpu", init=False)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(seed + 13)
    specs = [(40, 10), (17, 10), (33, 10), (25, 10), (12, 10)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _m in specs]

    def mix():
        return [None, SamplingParams(temperature=0.8, seed=seed + 1),
                SamplingParams(top_k=50, top_p=0.9, seed=seed + 2),
                SamplingParams(repetition_penalty=1.2, seed=seed + 3),
                SamplingParams(temperature=0.8, seed=seed + 4,
                               mask_processor=DfaTokenMask(
                                   _cycle_dfa(np, cfg.vocab_size, seed)))]
    kw = dict(num_slots=5, prompt_len=64, chunk_len=32, max_cache_len=128,
              block_len=16, compute_dtype="float32")
    _zero_launches()
    t0 = time.perf_counter()
    geng = ServingEngine(gpu, **kw)
    greqs = [geng.submit(ids, max_new_tokens=m, sampling=sp)
             for ids, (_n, m), sp in zip(prompts, specs, mix())]
    geng.run()
    t_gpu = time.perf_counter() - t0
    launched = _launched("sampled exactness",
                         ("rms_norm", "paged_decode_attention"))
    t0 = time.perf_counter()
    ceng = ServingEngine(cpu, device="cpu", **kw)
    creqs = [ceng.submit(ids, max_new_tokens=m, sampling=sp)
             for ids, (_n, m), sp in zip(prompts, specs, mix())]
    ceng.run()
    t_cpu = time.perf_counter() - t0
    compared = total = 0
    for g, c, ids in zip(greqs, creqs, prompts):
        lg = _teacher_forced(torch, cpu, None, ids, c.output[:-1], "cpu",
                             kv_dtype=torch.float32)
        margin = _sampled_margins(torch, lg, c)
        upto = _upto(margin)
        if not np.array_equal(g.output[:upto], c.output[:upto]):
            raise AssertionError(f"sampled exactness: request "
                                 f"{c.request_id}: card {g.output} != CPU "
                                 f"{c.output} before position {upto}")
        compared += upto
        total += len(margin)
    if compared < total // 2:
        raise AssertionError(f"sampled exactness: only {compared} of {total} "
                             f"positions decisive")
    _log(f"sampled exactness: {cfg.num_hidden_layers} layers at 8B width, "
         f"float32, a 5-request "
         f"sampled mix (greedy, T=0.8, top-k/top-p, penalty, DFA mask): "
         f"card tokens equal the CPU's at {compared} of {total} positions "
         f"(each request up to its first CPU margin <= 0.01); whole requests "
         f"equal {[bool(np.array_equal(g.output, c.output)) for g, c in zip(greqs, creqs)]}; "
         f"card {t_gpu:.2f} s, CPU {t_cpu:.2f} s; launches {launched}")
    gkw = dict(temperature=0.8, top_k=50, top_p=0.9)
    ids = prompts[0][None, :]
    _zero_launches()
    g_out = gpu.generate(ids, max_new_tokens=8, do_sample=True, seed=seed,
                         compute_dtype="float32", **gkw)[0].cpu().numpy()
    launched = _launched("sampled generate",
                         ("flash_attention_fwd", "decode_attention"))
    c_out = cpu.generate(ids, max_new_tokens=8, do_sample=True, seed=seed,
                         compute_dtype="float32", **gkw)[0].numpy()
    lg = _teacher_forced(torch, cpu, None, prompts[0], c_out[:-1], "cpu",
                         kv_dtype=torch.float32)
    upto = _upto(_generate_margins(torch, lg, gkw, seed))
    if not np.array_equal(g_out[:upto], c_out[:upto]):
        raise AssertionError(f"sampled generate: card {g_out} != CPU "
                             f"{c_out} before position {upto}")
    _log(f"sampled generate (T=0.8, top_k=50, top_p=0.9, seed {seed}): card "
         f"tokens equal the CPU's at {upto} of {len(c_out)} positions; "
         f"whole stream equal {bool(np.array_equal(g_out, c_out))}; "
         f"launches {launched}")
    del geng, ceng, gpu, cpu
    torch.cuda.empty_cache()


def _union_us(torch, prof):
    """The union of the profile's device intervals (kernels and copies),
    in us, and the span from the first start to the last end."""
    iv = sorted((e.time_range.start, e.time_range.end)
                for e in _device_events(torch, prof))
    total, cur = 0.0, None
    for a, b in iv:
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, (iv[-1][1] - iv[0][0]) if iv else 0.0


# the kernels of the sampler in a profile, by name: threefry and the
# other int64 elementwise work (the paged routes' index math too), the
# filtered bucket's sort and scan, and the softmax
SAMPLER_KERNELS = {"int64 elementwise": ("long",), "sort": ("sort", "radix"),
                   "scan": ("scan",), "softmax": ("softmax",)}


def _sampler_ms(per_kernel, steps):
    """Device ms per step of each group of ``SAMPLER_KERNELS``."""
    return {tag: sum(us for n, us in per_kernel.items()
                     if any(k in n.lower() for k in keys)) / 1e3 / steps
            for tag, keys in SAMPLER_KERNELS.items()}


def _profile_decode(torch, eng, rng, vocab, steps=8, sampling=None,
                    adapters=None):
    """Where a decode step's time goes: 8 fresh 64-token requests fill
    the slots (``sampling``, if given, returns their per-request
    configurations); once all are prefilled, ``steps`` decode steps run
    unprofiled (host wall) and ``steps`` more under ``torch.profiler``
    (device busy time = sum of CUDA kernel durations, the union of the
    device intervals against the window's wall, and the kernels that
    take most of it).  Budgets keep every slot decoding through both
    windows.  A step is one scanned decode step: at ``async_depth`` >= 2
    one ``step()`` may dispatch a fused window of several, so the windows
    are divided by the decode steps they ran.  ``adapters`` (phase 3j)
    names each slot's LoRA adapter (None: the base model).  Returns
    ``{"wall_ms", "busy_ms", "union_ms", "idle", "groups", "per_kernel",
    "steps"}`` per decode step (``groups``: ``_sampler_ms``;
    ``per_kernel``: the window's us by kernel name over ``steps``), or
    None when the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile
    depth = getattr(eng, "async_depth", 1)
    mix = sampling() if sampling is not None else [None] * eng.num_slots
    names = adapters or [None] * eng.num_slots
    reqs = [eng.submit(rng.integers(0, vocab, 64).astype("int32"),
                       max_new_tokens=eng.num_slots + 2 * steps * depth + 4,
                       sampling=sp, adapter=a)
            for sp, a in zip(mix, names)]
    while any(r.state in ("queued", "prefill") for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    d0 = eng.stats()["decode_steps"]
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d1 = eng.stats()["decode_steps"]
    wall /= d1 - d0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    steps = eng.stats()["decode_steps"] - d1
    wall_prof /= steps
    live = sum(r.state == "decode" for r in reqs)
    per_kernel, count = _profile_kernels(torch, prof)
    busy = sum(per_kernel.values()) / 1e3 / steps
    union_us, span_us = _union_us(torch, prof)
    union = union_us / 1e3 / steps
    eng.run()
    if live != eng.num_slots:
        raise AssertionError(f"decode profile: {live} of {eng.num_slots} "
                             f"slots still decoding after the windows")
    if not per_kernel:
        _log(f"decode profile: wall {wall * 1e3:.3f} ms/step; device time "
             f"not measured (the profiler recorded no CUDA kernels)")
        return None
    dec = ", ".join(f"{tag} {ms:.3f}" for tag, ms in
                    _decode_ms(per_kernel, steps).items() if ms)
    rms = [n for n in per_kernel if "rms_norm" in n]
    rms_us = (sum(per_kernel[n] for n in rms) / sum(count[n] for n in rms)
              if rms else None)
    _log(f"decode profile: {d1 - d0}+{steps} steps x {eng.num_slots} "
         f"slots: "
         f"wall {wall * 1e3:.3f} ms/step unprofiled, "
         f"{wall_prof * 1e3:.3f} ms/step profiled; device busy "
         f"{busy:.3f} ms/step ({100 * busy / (wall * 1e3):.1f}% of the "
         f"unprofiled wall; by kernel, ms/step: {dec or 'none'}; rms_norm "
         + ("not launched" if rms_us is None else
            f"{rms_us:.2f} us a launch") + f"), "
         f"{len(per_kernel)} distinct kernels; union of device intervals "
         f"{union:.3f} ms/step over a {span_us / 1e3 / steps:.3f} ms/step "
         f"span: device idle {100 * (1 - union / (wall_prof * 1e3)):.1f}% "
         f"of the profiled wall")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        _log(f"  {us / 1e3 / steps:8.3f} ms/step  {name[:90]}")
    _log_decode_kernels(per_kernel, steps)
    return {"wall_ms": wall * 1e3, "busy_ms": busy, "union_ms": union,
            "idle": 1 - union / (wall_prof * 1e3),
            "groups": _sampler_ms(per_kernel, steps),
            "per_kernel": per_kernel, "steps": steps}


def _profile_prefill_chunk(torch, eng, rng, vocab):
    """One prefill chunk (``chunk_len`` rows, the first of a fresh prompt
    of ``prompt_len`` tokens) on an idle engine, under ``torch.profiler``:
    the step's wall, the device busy time and the kernels that take most
    of it."""
    from torch.profiler import ProfilerActivity, profile
    req = eng.submit(rng.integers(0, vocab, eng.prompt_len).astype("int32"),
                     max_new_tokens=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel, count = _profile_kernels(torch, prof)
    eng.run()
    if req.state != "finished":
        raise AssertionError(f"prefill profile: request {req.state}")
    if not per_kernel:
        _log(f"prefill chunk profile: wall {wall * 1e3:.3f} ms; device "
             f"time not measured (the profiler recorded no CUDA kernels)")
        return
    busy = sum(per_kernel.values()) / 1e3
    qmm = [n for n in per_kernel if "qmm_" in n]
    _log(f"prefill chunk profile: {eng.chunk_len} rows: wall "
         f"{wall * 1e3:.3f} ms profiled; device busy {busy:.3f} ms; "
         f"quantized matmul {sum(per_kernel[n] for n in qmm) / 1e3:.3f} ms "
         f"over {sum(count[n] for n in qmm)} kernel launches; "
         f"{len(per_kernel)} distinct kernels")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        _log(f"  {us / 1e3:8.3f} ms  {name[:90]}")


def phase_decode_window(torch, seed):
    """``--decode-window``: the decode attention kernels alone and in the
    serving step.  Phase 2's paged and dense cases in bf16 (kernel, plain
    and SDPA times, host time a call), two tiny launches timed the same
    way (the floor of a kernel that is two launches), the dense split
    length swept where the tree has one; then phase 3's decode window and
    one phase 3c (a) spec step, profiled, on the 8B model.  With
    ``--root`` the package comes from another tree (a parent commit
    unpacked beside this checkout), so one script measures two trees, in
    turns within one call."""
    import numpy as np
    from paddle_tpu_torch.inference import ModelDrafter, ServingEngine
    from paddle_tpu_torch.ops import decode_attention as da
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    for row in (_decode_case(torch, "bfloat16", gen, rng),
                _dense_case(torch, "bfloat16", gen)):
        _log(f"decode window: {row['shape']}: kernel {row['ms']:.4f} ms, "
             f"host {row['host_us']:.1f} us a call")
    scratch, flush = _read_flush(torch)
    x = torch.zeros(1, device="cuda")
    _log(f"decode window: two tiny launches "
         f"{_time_ms(torch, lambda: (x.add_(1), x.add_(1)), flush):.4f} ms")
    if hasattr(da, "_DENSE_SPLIT_SLOTS"):
        s, hkv, d = SPEC["max_context"] + SPEC["k"], 8, 128
        kc, vc = (torch.randn(1, s, hkv * d, generator=gen, device="cuda")
                  .bfloat16() for _ in range(2))
        q = torch.randn(1, 4 * hkv, d, generator=gen,
                        device="cuda").bfloat16()
        ln = torch.tensor([s - 2], dtype=torch.int32, device="cuda")
        keep = da._DENSE_SPLIT_SLOTS
        for slots in (16, 32, 64, 128):
            da._DENSE_SPLIT_SLOTS = slots
            ms = _time_ms(torch, lambda: da.decode_attention(q, kc, vc, ln),
                          flush)
            _log(f"decode window: dense S={s} in {slots}-slot splits "
                 f"{ms:.4f} ms")
        da._DENSE_SPLIT_SLOTS = keep
    del scratch
    cfg, model = _build_8b(torch, 32, "bfloat16", seed)
    kw = dict(num_slots=8, prompt_len=512, chunk_len=256, max_cache_len=1024,
              block_len=16, compute_dtype="bfloat16")
    _profile_decode(torch, ServingEngine(model, **kw), rng, cfg.vocab_size)
    eng = ServingEngine(model, drafter=ModelDrafter(
        model, max_context=SPEC["max_context"], max_draft=SPEC["k"],
        compute_dtype="bfloat16"), **kw)
    _profile_verify(torch, eng, rng, cfg.vocab_size)


# phase 2's bf16 quantized-matmul shapes that --quant-window times
QUANT_WINDOW_SHAPES = [(1, 4096, 14336), (8, 4096, 14336), (40, 4096, 14336),
                       (256, 4096, 14336), (8, 4096, 1024), (8, 14336, 4096)]


# the bf16 quantized matmul's CTA tiles (mt, ng, wn, wm) that
# --quant-window sweeps, by shape (M, K, N)
_SMALL_TILES = [(1, 1, 1, 1), (1, 1, 2, 1), (1, 1, 4, 1)]
QMM_TILE_SWEEP = {
    (8, 4096, 14336): _SMALL_TILES,
    (8, 4096, 4096): _SMALL_TILES,
    (8, 4096, 1024): _SMALL_TILES,
    (8, 14336, 4096): _SMALL_TILES,
    (40, 4096, 14336): [(5, 1, 1, 1), (5, 1, 2, 1), (5, 1, 4, 1)]}


def _qmm_tile_sweep(torch, gen):
    """The bf16 quantized matmul at each shape of ``QMM_TILE_SWEEP`` under
    each CTA tile (the wrapper's ``tc_tile`` replaced for the sweep), int8
    and int4, L2 flushed by a read; every tile's output must equal the
    chosen tile's bit for bit (the tile only places the work)."""
    from paddle_tpu_torch.ops import quantized_matmul as qm
    from paddle_tpu_torch.quantization import (absmax_to_scales,
                                               quantize_channelwise)
    chosen = qm.tc_tile
    scratch, flush = _read_flush(torch)
    try:
        for (m, k, n), tiles in QMM_TILE_SWEEP.items():
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            w = 0.02 * torch.randn(k, n, generator=gen, device="cuda")
            for bits in (8, 4):
                scales = absmax_to_scales(w.abs().amax(0), bits)
                codes = quantize_channelwise(w, scales, bits)
                if bits == 4:
                    codes = qm.pack_int4(codes)
                qm.tc_tile = chosen
                want = qm.quantized_matmul(x, codes, scales, bits=bits)
                res = []
                for tile in tiles:
                    qm.tc_tile = lambda *_a, t=tile: t
                    got = qm.quantized_matmul(x, codes, scales, bits=bits)
                    _same(torch, f"quantized_matmul M={m} K={k} N={n} "
                                 f"int{bits}", got, want, f"tile {tile}")
                    res.append(f"{tile}: {_time_ms(torch, lambda: qm.quantized_matmul(x, codes, scales, bits=bits), flush):.4f}")
                _log(f"quant window: tiles (mt, ng, wn, wm) M={m} K={k} N={n} "
                     f"int{bits} (chosen {chosen(m, n, qm.tc_split_plan(k, bits)[0])}), "
                     f"ms: {'; '.join(res)}")
            del w
    finally:
        qm.tc_tile = chosen
        del scratch


def phase_quant_window(torch, seed):
    """``--quant-window``: the quantized matmul and the int8 one-token
    decode alone and in the quantized serving step.  Phase 2's bf16
    quantized-matmul cases at ``QUANT_WINDOW_SHAPES`` in int8 and int4
    (kernel, plain and bf16 GEMM times), the CTA tiles of
    ``QMM_TILE_SWEEP`` where the tree has them, and its int8 decode case
    in bf16 (kernel and plain times, host time a call); then, on the 8B
    model
    through an int8-KV, int8-weight engine (phase 3b's), phase 3b's decode
    window and one 256-row chunk prefill, profiled.  With ``--root`` the
    package comes from another tree (a parent commit unpacked beside this
    checkout), so one script measures two trees, in turns within one
    call."""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    for m, k, n in QUANT_WINDOW_SHAPES:
        for bits in (8, 4):
            row = _qmm_case(torch, "bfloat16", bits, m, k, n, gen)
            _log(f"quant window: quantized_matmul {row['shape']} bfloat16: "
                 f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
                 f"ms, bf16 GEMM {row['library_ms']:.4f} ms, bound "
                 f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    from paddle_tpu_torch.ops import quantized_matmul as qm
    if hasattr(qm, "tc_tile"):
        _qmm_tile_sweep(torch, gen)
    row = _decode_int8_case(torch, "bfloat16", gen, rng)
    _log(f"quant window: int8 paged decode {row['shape']}: kernel "
         f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
         f"{row['bound_ms']:.4f} ms; host {row['host_us']:.1f} us a call")
    cfg, model = _build_8b(torch, 32, "bfloat16", seed)
    eng = ServingEngine(model, num_slots=8, prompt_len=512, chunk_len=256,
                        max_cache_len=1024, block_len=16,
                        compute_dtype="bfloat16", kv_cache_dtype="int8",
                        weight_dtype="int8")
    _profile_decode(torch, eng, rng, cfg.vocab_size)
    _profile_prefill_chunk(torch, eng, rng, cfg.vocab_size)


def _by_name(per_kernel, count, key):
    """(device ms, launches) of the profiled kernels whose name holds
    ``key``."""
    names = [n for n in per_kernel if key in n]
    return (sum(per_kernel[n] for n in names) / 1e3,
            sum(count[n] for n in names))


def _decode_rms_host(torch, eng, rng, vocab, steps=8):
    """Host time of one RMSNorm call inside bf16 decode steps: 8 fresh
    64-token requests fill the slots and are prefilled, then ``steps``
    decode steps run with the model's ``rms_norm`` (as ``nn.norm`` calls
    it) timed on the host clock around every call; returns (us a call,
    calls a step)."""
    from paddle_tpu_torch.nn import norm
    reqs = [eng.submit(rng.integers(0, vocab, 64).astype("int32"),
                       max_new_tokens=steps + 4)
            for _ in range(eng.num_slots)]
    while any(r.state in ("queued", "prefill") for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    inner, spent = norm.rms_norm, []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        spent.append(time.perf_counter() - t0)
        return out

    norm.rms_norm = timed
    try:
        for _ in range(steps):
            eng.step()
    finally:
        norm.rms_norm = inner
    torch.cuda.synchronize()
    eng.run()
    if not spent:
        return None, 0       # graph replays call no wrapper
    return 1e6 * sum(spent) / len(spent), len(spent) / steps


def _op_host_us(torch, gen):
    """Host us a call of ``apply_rope`` at (1, 256, 32, 128) bf16 and of
    the int8 ``quantized_matmul`` at (8, 4096) x (4096, 14336), no grad,
    least of 5 turns of ``_host_us``."""
    from paddle_tpu_torch.ops import quantized_matmul as qmm
    from paddle_tpu_torch.ops import rope as rp
    bf = dict(device="cuda", dtype=torch.bfloat16)
    x = torch.randn((8, 4096), generator=gen, **bf)
    q = torch.randn((1, 256, 32, 128), generator=gen, **bf)
    cos = torch.rand((1, 256, 1, 64), generator=gen, device="cuda")
    sin = torch.rand((1, 256, 1, 64), generator=gen, device="cuda")
    codes = torch.randint(-127, 128, (4096, 14336), generator=gen,
                          device="cuda", dtype=torch.int8)
    scales = torch.rand(14336, generator=gen, device="cuda")
    with torch.no_grad():
        for name, fn in (
                ("apply_rope (1, 256, 32, 128) bf16",
                 lambda: rp.apply_rope(q, cos, sin)),
                ("quantized_matmul int8 (8, 4096) x (4096, 14336)",
                 lambda: qmm.quantized_matmul(x, codes, scales))):
            turns = [_host_us(torch, fn) for _ in range(5)]
            _log(f"norm window: {name}: host {min(turns):.2f} us a call "
                 f"(least of 5 turns of 500 calls; turns "
                 + " / ".join(f"{t:.2f}" for t in turns) + ")")


def _prefill_chunk_walls(torch, eng, rng, vocab):
    """The unprofiled wall of the eager prefill chunk (a 256-row chunk of
    a 512-token prompt on an idle engine: 65 RMSNorm and 64 RoPE calls at
    32 layers), least of 10 after the first."""
    walls = []
    for _ in range(11):
        eng.submit(rng.integers(0, vocab, 512).astype("int32"),
                   max_new_tokens=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        eng.run()
    _log(f"norm window: eager 8B prefill chunk (256 rows of a 512-token "
         f"prompt, 32 layers, bf16): {min(walls[1:]):.3f} ms (least of 10 "
         f"after the first; walls " + " / ".join(f"{v:.3f}" for v in walls)
         + ")")


def phase_norm_window(torch, seed):
    """``--norm-window``: RoPE and RMSNorm alone and in the steps that run
    them.  Phase 2's bf16 RoPE cases at the first three ``ROPE_SHAPES``
    (kernel and plain times) and ``_rms_turns`` at ``RMS_TURN_SHAPES``
    (kernel against ``F.rms_norm`` in device time, profiled device us and
    host us a call, the launch floor), the copy floors of
    ``COPY_FLOORS``; then one profiled phase-5 train step of the 1.1B
    model (``_profile_train_step``: RoPE's and RMSNorm's device ms and
    launches in it), and phase 3's bf16 8B decode window (RMSNorm's
    device ms a step and us a launch, profiled) and RMSNorm's host us a
    call in those decode steps.  The host cost of the kernels as
    dispatcher ops: host us a call of ``apply_rope`` and
    ``quantized_matmul`` (``_op_host_us``; RMSNorm's is ``_rms_turns``'),
    the phase-5 step's synced wall (least of 3), and the unprofiled wall
    of the eager 8B prefill chunk (``_prefill_chunk_walls``).  With
    ``--root`` the package comes from another tree (a parent commit
    unpacked beside this checkout), so one script measures two trees, in
    turns within one call."""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    for shape in ROPE_SHAPES[:3]:
        row = _rope_case(torch, "bfloat16", gen, shape)
        _log(f"norm window: rope {row['shape']} bfloat16: kernel "
             f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
             f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    for n, d in RMS_TURN_SHAPES:
        _rms_turns(torch, n, d, gen)
    _op_host_us(torch, gen)
    for shape, what in COPY_FLOORS:
        _copy_floor(torch, shape, gen, what)
    b, s, nl = TRAIN["batch"], TRAIN["seq"], TRAIN["layers"]
    cfg, model, opt, step = _train_setup(torch, nl, "bfloat16", seed)
    tokens, labels = _train_batch(torch, cfg, b, s, seed, "cuda")
    step(tokens, labels)
    _profile_train_step(torch, step, tokens, labels)
    ms = _wall_ms(torch, lambda: float(step(tokens, labels)), n=3)
    _log(f"norm window: phase-5 train step ({nl} layers, b{b} s{s}, bf16): "
         f"{ms:.3f} ms (least of 3 synced walls)")
    del step, opt, model
    torch.cuda.empty_cache()
    cfg, model = _build_8b(torch, 32, "bfloat16", seed)
    kw = dict(num_slots=8, prompt_len=512, chunk_len=256, max_cache_len=1024,
              block_len=16, compute_dtype="bfloat16")
    _prefill_chunk_walls(torch, ServingEngine(model, **kw), rng,
                         cfg.vocab_size)
    _profile_decode(torch, ServingEngine(model, **kw), rng, cfg.vocab_size)
    us, calls = _decode_rms_host(torch, ServingEngine(model, **kw), rng,
                                 cfg.vocab_size)
    _log("norm window: decode step: rms_norm host " + (
        "not measured (the decode block replays a CUDA graph, which calls "
        "no wrapper)" if us is None else
        f"{us:.2f} us a call, {calls:.0f} calls a step"))


def phase_facade_window(torch, seed, n=2000, reps=5):
    """``--facade-window``: the host cost of the five tensor ops that the
    port's models call through ``nn.functional`` (``add``, ``multiply``,
    ``concat``, ``split``, ``flatten``: the residual adds of
    ``nn.transformer`` and ERNIE, the vision zoo's joins and flattens) on
    plain CUDA tensors, and phase 5e's ERNIE-base fine-tune step, which
    calls ``add`` 2 a layer.  Each op: host us a call, the least of
    ``reps`` windows of ``n`` calls between two syncs (the device work of
    a call, bf16 [32, 768], is a few us, under the host's).  ERNIE: the
    step's wall (mean of 10 after one warm-up, as 5e) and its calls of
    the five names (counted in one more, untimed, step).  With ``--root``
    the package comes from another tree, so one call measures the parent
    and the change in turns."""
    import paddle_tpu_torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn(32, 768, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    y = torch.randn(32, 768, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    x4 = x.reshape(32, 3, 16, 16)
    cases = (("add", lambda: F.add(x, y)),
             ("multiply", lambda: F.multiply(x, y)),
             ("concat", lambda: F.concat([x, y], axis=1)),
             ("split", lambda: F.split(x, 2, axis=1)),
             ("flatten", lambda: F.flatten(x4, 1)))
    us = {}
    for name, fn in cases:
        fn()
        best = None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            w = (time.perf_counter() - t0) / n * 1e6
            best = w if best is None else min(best, w)
        us[name] = best
    floor = None
    for _ in range(reps):      # the same add in raw torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            torch.add(x, y)
        torch.cuda.synchronize()
        w = (time.perf_counter() - t0) / n * 1e6
        floor = w if floor is None else min(floor, w)
    b, s = ERNIE_TRAIN["batch"], ERNIE_TRAIN["seq"]
    cfg, model, step = _ernie_train_setup(torch, 12, seed, amp_level="O1")
    batch = _ernie_batch(torch, cfg, b, s, seed, "cuda")
    losses, warm, step_s, _, _ = _timed_steps(torch, step, batch, n=10)
    calls = dict.fromkeys(us, 0)
    kept = {name: getattr(F, name) for name in us}

    def counted(name):
        def fn(*a, **k):
            calls[name] += 1
            return kept[name](*a, **k)
        return fn

    try:
        for name in us:
            setattr(F, name, counted(name))
        step(*batch)
        torch.cuda.synchronize()
    finally:
        for name, fn in kept.items():
            setattr(F, name, fn)
    _log("facade window: host us a call on plain bf16 [32, 768] CUDA "
         "tensors (least of " + str(reps) + " windows of " + str(n) +
         "): " + ", ".join(f"F.{k} {v:.2f}" for k, v in us.items()) +
         f"; raw torch.add {floor:.2f}; ERNIE-base fine-tune step "
         f"(phase 5e, batch {b}x{s}, O1 bf16) {step_s * 1e3:.2f} ms (mean "
         f"of 10), calls a step "
         + ", ".join(f"{k} {v}" for k, v in calls.items() if v)
         + f"; losses finite {_finite(losses)}")
    del step, model
    torch.cuda.empty_cache()


def phase_exactness(torch, seed):
    """Phase 4: a mixed trace through a 2-slot engine against each
    request alone on a fresh 1-slot engine, token for token, in float32
    and then with an int8 KV cache and int8 weights (the quantized
    kernels' summation order depends on K alone, never on the batch)."""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops import KERNELS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = _build_8b(torch, 4, "float32", seed + 1)
    rng = np.random.default_rng(seed + 1)
    specs = [(40, 12), (17, 5), (64, 9), (33, 7), (5, 10)]
    trace = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for n, m in specs]
    for quant in ({}, dict(kv_cache_dtype="int8", weight_dtype="int8")):
        kw = dict(prompt_len=64, chunk_len=32, max_cache_len=128,
                  block_len=16, compute_dtype="float32", **quant)
        for k in KERNELS.values():
            k.launches = 0
        # both arms: the lockstep one and the default (dispatch-ahead)
        lock = ServingEngine(model, num_slots=2, async_dispatch=False, **kw)
        locked = [lock.submit(ids, max_new_tokens=m) for ids, m in trace]
        lock.run()
        del lock
        eng = ServingEngine(model, num_slots=2, **kw)
        mixed = [eng.submit(ids, max_new_tokens=m) for ids, m in trace]
        eng.run()
        for r, q in zip(mixed, locked):
            if not np.array_equal(r.output, q.output):
                raise AssertionError(
                    f"request {r.request_id}: dispatch-ahead {r.output} != "
                    f"lockstep {q.output} ({quant or 'float'})")
        for r, (ids, m) in zip(mixed, trace):
            one = ServingEngine(model, num_slots=1, **kw)
            alone = one.submit(ids, max_new_tokens=m)
            one.run()
            if not np.array_equal(r.output, alone.output):
                raise AssertionError(
                    f"request {r.request_id}: mixed 2-slot trace "
                    f"{r.output} != alone on a 1-slot engine "
                    f"{alone.output} ({quant or 'float'})")
            del one
        if quant:
            counts = {n: KERNELS[n].launches for n in
                      ("quantized_matmul", "paged_decode_attention_int8")}
            if not all(counts.values()):
                raise AssertionError(f"exactness: a quantized kernel never "
                                     f"launched: {counts}")
            _log(f"exactness: {len(trace)} requests token-exact (2-slot "
                 f"mixed trace vs 1-slot engines and the lockstep arm, "
                 f"float32, int8 KV cache "
                 f"and int8 weights, 4 layers at 8B width); launches "
                 f"{counts}")
        else:
            _log(f"exactness: {len(trace)} requests token-exact (2-slot "
                 f"mixed trace vs 1-slot engines and the lockstep arm, "
                 f"float32, 4 layers at 8B width)")
        del eng
    del model
    torch.cuda.empty_cache()


def _margins_on_card(torch, model, trace, outs, kv_dtype):
    """Teacher-forced top-2 margins of ``model`` on the card along each
    request's output (``_teacher_forced`` over a float or int8 paged
    cache)."""
    dev = next(model.parameters()).device
    out = []
    for (ids, _m), o in zip(trace, outs):
        lg = _teacher_forced(torch, model, None, ids, o[:-1], dev,
                             kv_dtype=kv_dtype)
        top2 = lg.topk(2, dim=-1).values
        out.append((top2[:, 0] - top2[:, 1]).numpy())
    return out


def _upto(margin, tol=0.01):
    import numpy as np
    close = np.flatnonzero(margin <= tol)
    return int(close[0]) if close.size else len(margin)


def phase_spec_exactness(torch, seed):
    """Phase 4c: a 4-layer float32 model at 8B width.  Over a float and an
    int8 KV cache, 2-slot spec engines (spec_decode=4) with a ModelDrafter
    over the target and over a 2-layer model of another seed give the
    non-spec engine's tokens up to each request's first position whose
    teacher-forced top-2 margin is <= 0.01 (the ROADMAP rule); the
    target-drafter engine equals fresh 1-slot spec engines there too;
    greedy ``generate()`` equals a fresh 1-slot engine there; the target
    as its own drafter accepts everything unless a position is not
    decisive; no block stays in use after a drain."""
    import numpy as np
    from paddle_tpu_torch.inference import ModelDrafter, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = _build_8b(torch, 4, "float32", seed + 1)
    _, other = _build_8b(torch, 2, "float32", seed + 6)
    rng = np.random.default_rng(seed + 1)
    specs = [(40, 12), (17, 5), (64, 9), (33, 7), (5, 10)]
    trace = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for n, m in specs]
    base = dict(prompt_len=64, chunk_len=32, max_cache_len=128, block_len=16,
                compute_dtype="float32")
    dkw = dict(max_context=96, max_draft=SPEC["k"], compute_dtype="float32")
    notes = []
    for kv in (None, "int8"):
        kw = dict(base, kv_cache_dtype=kv)
        plain = ServingEngine(model, num_slots=2, **kw)
        preqs = [plain.submit(ids, max_new_tokens=m) for ids, m in trace]
        plain.run()
        margins = _margins_on_card(torch, model, trace,
                                   [r.output for r in preqs],
                                   torch.int8 if kv else torch.float32)
        decisive = all(_upto(mg) == len(mg) for mg in margins)
        if kv is None:
            for (ids, m), r, mg in zip(trace, preqs, margins):
                one = ServingEngine(model, num_slots=1, **kw)
                alone = one.submit(ids, max_new_tokens=m)
                one.run()
                padded = np.zeros((64,), np.int32)
                padded[:ids.size] = ids
                gen = model.generate(padded[None],
                                     seq_lens=np.array([ids.size]),
                                     max_new_tokens=m, max_cache_len=128,
                                     compute_dtype="float32")[0].cpu().numpy()
                u = _upto(mg)
                if not np.array_equal(gen[:u], alone.output[:u]):
                    raise AssertionError(
                        f"spec exactness: generate() {gen} != 1-slot engine "
                        f"{alone.output} before position {u}")
        for name, dm in (("target", model), ("other", other)):
            eng = ServingEngine(model, num_slots=2,
                                drafter=ModelDrafter(dm, **dkw), **kw)
            sreqs = [eng.submit(ids, max_new_tokens=m, spec_decode=SPEC["k"])
                     for ids, m in trace]
            eng.run()
            st = eng.stats()
            for r, p, mg in zip(sreqs, preqs, margins):
                u = _upto(mg)
                if not np.array_equal(r.output[:u], p.output[:u]):
                    raise AssertionError(
                        f"spec exactness ({name} drafter, {kv or 'float'} "
                        f"KV): spec tokens {r.output} != non-spec "
                        f"{p.output} before position {u}")
            if st["blocks_in_use"] != 0 or st["spec_verify_steps"] == 0:
                raise AssertionError(f"spec exactness: {st}")
            rate = st["spec_acceptance_rate"]
            if name == "target" and decisive and rate != 1.0:
                raise AssertionError(
                    f"spec exactness: the target as its own drafter "
                    f"accepted {rate} with every position decisive")
            if name == "target" and kv is None:
                for (ids, m), r, mg in zip(trace, sreqs, margins):
                    one = ServingEngine(model, num_slots=1,
                                        drafter=ModelDrafter(model, **dkw),
                                        **kw)
                    alone = one.submit(ids, max_new_tokens=m,
                                       spec_decode=SPEC["k"])
                    one.run()
                    u = _upto(mg)
                    if not np.array_equal(alone.output[:u], r.output[:u]):
                        raise AssertionError(
                            f"spec exactness: 1-slot spec engine "
                            f"{alone.output} != 2-slot {r.output} before "
                            f"position {u}")
            notes.append(f"{name} drafter, {kv or 'float'} KV: acceptance "
                         f"{rate:.3f} over {st['spec_verify_steps']} "
                         f"verifies, whole requests equal "
                         f"{[bool(np.array_equal(r.output, p.output)) for r, p in zip(sreqs, preqs)]}")
            del eng
        notes.append(f"{kv or 'float'} KV: smallest margin "
                     f"{min(float(mg.min()) for mg in margins):.4g}, every "
                     f"position decisive: {decisive}")
    _log("spec exactness: 4 layers at 8B width, float32, 5 requests: "
         + "; ".join(notes))
    del model, other
    torch.cuda.empty_cache()


def _same_tokens(tag, got, want):
    import numpy as np
    for g, w in zip(got, want):
        if g.state != "finished" or not np.array_equal(g.output, w.output):
            raise AssertionError(f"{tag}: request {g.request_id} "
                                 f"({g.state}) {g.output} != {w.output}")


def phase_preempt_exactness(torch, seed):
    """Phase 4d: phase 4's 4-layer float32 model at 8B width, TF32 off,
    token for token: (a) a 2-slot trace with priorities on a 9-block pool
    whose priority-1 arrival preempts, against each request alone on a
    fresh 1-slot engine; (b) ``_preempt`` forced mid-prefill and
    mid-decode, then resumed, against the uninterrupted run; (c) a radix
    engine over an 8-block pool that demotes a finished request's prompt
    blocks and promotes them for a sharer, against
    ``prefix_cache_mode="none"``; (d) (a) and (c) with an int8 KV cache;
    (e) a spec-mode request (spec_decode=2, a ``ModelDrafter`` over the
    target) preempted mid-decode and resumed, against the uninterrupted
    run.  Each sub-case holds that its kernels launched."""
    import numpy as np
    from paddle_tpu_torch.inference import ModelDrafter, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = _build_8b(torch, 4, "float32", seed + 1)
    rng = np.random.default_rng(seed + 9)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).astype(np.int32)

    base = dict(prompt_len=64, chunk_len=32, max_cache_len=128,
                block_len=16, compute_dtype="float32")
    notes = []
    pa = [(prompt(40), 60), (prompt(17), 5), (prompt(64), 9)]
    shared = prompt(48)
    pc = [(shared, 8), (prompt(64), 40),
          (np.concatenate([shared[:32], prompt(20)]), 12)]
    for kv in (None, "int8"):
        decode = "paged_decode_attention" + ("_int8" if kv else "")
        kw = dict(base, kv_cache_dtype=kv)
        # (a): r0 (7 blocks) and r1 (2) fill the 9-block pool; r1
        # retires and the priority-1 arrival (5 blocks) preempts r0
        _zero_launches()
        eng = ServingEngine(model, num_slots=2, num_blocks=9, **kw)
        reqs = [eng.submit(ids, max_new_tokens=m) for ids, m in pa[:2]]
        while reqs[1].state != "finished":
            eng.step()
        reqs.append(eng.submit(pa[2][0], max_new_tokens=pa[2][1],
                               priority=1))
        eng.run()
        eng._pool.check()
        st = eng.stats()
        if st["preemptions"] < 1 or \
                st["preempt_resumes"] != st["preemptions"]:
            raise AssertionError(f"exactness (a): {st}")
        counts = _launched("exactness (a)", ("rms_norm", decode))
        alone = []
        for ids, m in pa:
            one = ServingEngine(model, num_slots=1, **kw)
            alone.append(one.submit(ids, max_new_tokens=m))
            one.run()
        _same_tokens(f"exactness (a, {kv or 'float'} KV)", reqs, alone)
        notes.append(f"(a) {kv or 'float'} KV: {st['preemptions']} "
                     f"preemptions, tokens equal alone; launches {counts}")
        # (c): A's 3 cached prompt blocks; B (7 blocks) reclaims 2 of
        # them to the host tier; C shares A's first 32 tokens and
        # promotes them
        outs = {}
        for mode in ("radix", "none"):
            _zero_launches()
            eng = ServingEngine(model, num_slots=1, num_blocks=8,
                                prefix_cache_mode=mode, **kw)
            reqs = []
            for ids, m in pc:
                reqs.append(eng.submit(ids, max_new_tokens=m))
                eng.run()
            eng._pool.check()
            outs[mode] = (reqs, eng.stats())
        st = outs["radix"][1]
        if st["prefix_host_hits"] < 1 or st["host_swapin_blocks"] != 2:
            raise AssertionError(f"exactness (c): {st}")
        counts = _launched("exactness (c)", ("rms_norm", decode))
        _same_tokens(f"exactness (c, {kv or 'float'} KV)",
                     outs["radix"][0], outs["none"][0])
        notes.append(f"(c) {kv or 'float'} KV: {st['swap_blocks_out']} "
                     f"blocks demoted, {st['host_swapin_blocks']} promoted, "
                     f"tokens equal the uncached engine's")
    # (b) forced preemption mid-prefill and mid-decode
    pb = [(prompt(64), 20), (prompt(33), 24)]
    runs = []
    for forced in (True, False):
        _zero_launches()
        eng = ServingEngine(model, num_slots=2, **base)
        reqs = [eng.submit(ids, max_new_tokens=m) for ids, m in pb]
        eng.step()
        if forced:
            if reqs[0].state != "prefill" or reqs[0].pf_pos != 32:
                raise AssertionError(f"exactness (b): {reqs[0].state}")
            eng._preempt(reqs[0])
        while reqs[1].state != "decode" or len(reqs[1].tokens) < 5:
            eng.step()
        if forced:
            eng._preempt(reqs[1])
        eng.run()
        eng._pool.check()
        runs.append((reqs, eng.stats()))
    if runs[0][1]["preemptions"] != 2 or runs[1][1]["preemptions"] != 0:
        raise AssertionError(f"exactness (b): {runs[0][1]}")
    counts = _launched("exactness (b)", ("rms_norm", "paged_decode_attention"))
    _same_tokens("exactness (b)", runs[0][0], runs[1][0])
    notes.append("(b) preempted mid-prefill and mid-decode: tokens equal "
                 "the uninterrupted run")
    # (e) a spec-mode row preempted and resumed
    dkw = dict(max_context=96, max_draft=2, compute_dtype="float32")
    pe = [(prompt(40), 16), (prompt(25), 12)]
    runs = []
    for forced in (True, False):
        _zero_launches()
        eng = ServingEngine(model, num_slots=2,
                            drafter=ModelDrafter(model, **dkw), **base)
        reqs = [eng.submit(pe[0][0], max_new_tokens=pe[0][1],
                           spec_decode=2),
                eng.submit(pe[1][0], max_new_tokens=pe[1][1])]
        while reqs[0].state != "decode" or len(reqs[0].tokens) < 4:
            eng.step()
        if forced:
            eng._preempt(reqs[0])
        eng.run()
        eng._pool.check()
        st = eng.stats()
        if st["spec_verify_steps"] == 0:
            raise AssertionError(f"exactness (e): {st}")
        runs.append((reqs, st))
        if forced:
            counts = _launched("exactness (e)", (
                "rms_norm", "paged_decode_attention",
                "paged_decode_attention_multi", "decode_attention",
                "flash_attention_fwd", "rope"))
    if runs[0][1]["preemptions"] != 1:
        raise AssertionError(f"exactness (e): {runs[0][1]}")
    _same_tokens("exactness (e)", runs[0][0], runs[1][0])
    notes.append(f"(e) spec row preempted and resumed: tokens equal the "
                 f"uninterrupted run; launches {counts}")
    _log("preemption exactness: 4 layers at 8B width, float32: "
         + "; ".join(notes))
    del model
    torch.cuda.empty_cache()


# phase 4b: largest |logit difference| allowed between the card and the
# CPU at every teacher-forced step, stated before the first run.  Logits
# of the random 2-layer model are ~0.25 in size; both sides sum the same
# exact fp32 products in other orders (about 1e-6 relative), and a K/V
# value whose fp32 quotient lies that close to a rounding boundary may
# take the neighbouring int8 code on one side (one step is 1/127 of the
# head's absmax), which moves a logit by well under 1e-4.  A wrong kernel
# (a nibble, scale or slot out of place) moves logits by ~0.1.
QUANT_LOGIT_ATOL = 2e-3


def _teacher_forced(torch, model, wq, prompt, forced, device, block_len=16,
                    kv_dtype=None, lora=None, verify_width=None):
    """Logits of ``model`` over paged arenas (int8 unless ``kv_dtype``
    says otherwise) under the weight context ``wq`` (and, with ``lora``
    planes of one row, its adapter's gathered delta): the prompt as one
    chunk, then one decode step per token of ``forced`` (or, with
    ``verify_width`` w, one verify forward per w tokens of ``forced``, the
    speculative path).  Returns [1 + len(forced), vocab] float32 on the
    CPU."""
    from paddle_tpu_torch.models.generation import init_paged_kv_arena
    from paddle_tpu_torch.models.lora import gather_lora, lora_context
    from paddle_tpu_torch.models.wquant import wquant_context
    nl, hkv, d = model.kv_cache_spec()
    n = len(prompt)
    mb = -(-(n + len(forced) + (verify_width or 0)) // block_len)
    tables = torch.arange(mb, dtype=torch.int32, device=device)[None, :]
    kvs = [tuple(e) + (tables,) for e in init_paged_kv_arena(
        nl, mb, block_len, hkv, d, kv_dtype or torch.int8, device)]
    rows = []
    with torch.no_grad(), wquant_context(wq), lora_context(
            None if lora is None else gather_lora(lora)):
        lg, kvs = model.prefill_chunk(
            torch.from_numpy(prompt[None, :]).to(device), 0, n, kvs)
        rows.append(lg[0].float().cpu())
        w = verify_width or 0
        for i in range(0, len(forced) if w else 0, max(w, 1)):
            chunk = [int(t) for t in forced[i:i + w]]
            toks = torch.zeros((1, w), dtype=torch.int32, device=device)
            toks[0, :len(chunk)] = torch.tensor(chunk, dtype=torch.int32)
            lg, kvs = model.verify_step(
                toks, torch.tensor([n + i], dtype=torch.int32,
                                   device=device),
                torch.tensor([len(chunk)], dtype=torch.int32,
                             device=device), kvs)
            rows += [r.float().cpu() for r in lg[0, :len(chunk)]]
        for t, tok in enumerate(forced if not w else ()):
            lg, kvs = model.decode_step(
                torch.tensor([int(tok)], dtype=torch.int32, device=device),
                torch.tensor([n + t], dtype=torch.int32, device=device), kvs)
            rows.append(lg[0].float().cpu())
    return torch.stack(rows)


def phase_quant_exactness(torch, seed):
    """Phase 4b: a 1-layer float32 model at 8B width with an int8 KV cache
    and int4 weights, on the card and on the CPU (plain versions) from
    the same state dict.  The two weight plans must be bit-identical; a
    2-request trace runs through a 2-slot engine on each side; then the
    first request's prompt and the CPU's tokens are teacher-forced
    through both models: every step's logits within QUANT_LOGIT_ATOL,
    the CPU's argmax equal to its engine's tokens, and the card's tokens
    equal to the CPU's up to the first step whose CPU top-2 margin is
    within 2 * QUANT_LOGIT_ATOL (a near-tie either side may take)."""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import KERNELS
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, gpu = _build_8b(torch, 1, "float32", seed + 3)
    cpu = LlamaForCausalLM(cfg, device="cpu", init=False)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    kw = dict(prompt_len=64, chunk_len=32, max_cache_len=128, block_len=16,
              compute_dtype="float32", kv_cache_dtype="int8",
              weight_dtype="int4", num_slots=2)
    rng = np.random.default_rng(seed + 3)
    trace = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for n, m in [(40, 6), (17, 4)]]
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    geng = ServingEngine(gpu, **kw)
    greqs = [geng.submit(ids, max_new_tokens=m) for ids, m in trace]
    geng.run()
    t_gpu = time.perf_counter() - t0
    launches = {n: KERNELS[n].launches
                for n in ("quantized_matmul", "paged_decode_attention_int8")}
    t0 = time.perf_counter()
    ceng = ServingEngine(cpu, device="cpu", **kw)
    creqs = [ceng.submit(ids, max_new_tokens=m) for ids, m in trace]
    ceng.run()
    t_cpu = time.perf_counter() - t0
    for (_, _, _, gc, gs), (_, t, _, cc, cs) in zip(geng._wq.entries,
                                                    ceng._wq.entries):
        if not (torch.equal(gc.cpu(), cc) and torch.equal(gs.cpu(), cs)):
            raise AssertionError(f"quant exactness: the card's {t} plan "
                                 f"differs from the CPU's")
    prompt, _ = trace[0]
    forced = creqs[0].output[:-1]
    lg_g = _teacher_forced(torch, gpu, geng._wq_ctx, prompt, forced,
                           geng.device)
    lg_c = _teacher_forced(torch, cpu, ceng._wq_ctx, prompt, forced, "cpu")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"quant exactness: {name} never launched")
    diff = (lg_g - lg_c).abs().max(dim=-1).values
    if not torch.isfinite(lg_g).all() or diff.max().item() > QUANT_LOGIT_ATOL:
        raise AssertionError(f"quant exactness: card logits differ from the "
                             f"CPU's by {diff.tolist()} (bound "
                             f"{QUANT_LOGIT_ATOL})")
    if not np.array_equal(lg_c.argmax(-1).numpy(), creqs[0].output):
        raise AssertionError("quant exactness: the CPU engine's tokens are "
                             "not its model's teacher-forced argmax")
    top2 = lg_c.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    close = np.flatnonzero(margin <= 2 * QUANT_LOGIT_ATOL)
    upto = int(close[0]) if close.size else len(margin)
    g_out = greqs[0].output
    if not np.array_equal(g_out[:upto], creqs[0].output[:upto]):
        raise AssertionError(f"quant exactness: card tokens {g_out} != CPU "
                             f"tokens {creqs[0].output} before step {upto}")
    same = [bool(np.array_equal(g.output, c.output))
            for g, c in zip(greqs, creqs)]
    _log(f"quant exactness: 1 layer at 8B width, float32, int8 KV + int4 "
         f"weights: plans bit-identical; teacher-forced logits max |diff| "
         f"{diff.max().item():.3g} over {len(diff)} steps (last step "
         f"{diff[-1].item():.3g}; bound {QUANT_LOGIT_ATOL}); tokens equal "
         f"through step {upto} of {len(margin)} (smallest CPU margin "
         f"{margin.min():.3g}); whole requests equal {same}; card "
         f"{t_gpu:.2f} s, CPU {t_cpu:.2f} s; launches {launches}")
    del geng, ceng, gpu, cpu
    torch.cuda.empty_cache()


def _train_setup(torch, layers, dtype, seed, device=None, make_opt=None,
                 cfg_kw=None, init=None, **step_kw):
    """``examples/llama_pretrain.py``'s model, criterion, optimizer and
    TrainStep at the full 1.1B width (``layers`` deep), parameters
    random from ``seed`` on the card (or built on ``device``, or left
    for a ``load_state_dict`` with ``init=False``).  ``cfg_kw`` adds
    config fields (a remat policy, the fused loss; the loss is then the
    model's own ``net(t, labels=l)[0]``).  The optimizer is the
    example's AdamW (fp32 moments, global-norm clip 1.0) unless
    ``make_opt(parameters)`` makes another."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig(vocab_size=TRAIN["vocab"], hidden_size=TRAIN["hidden"],
                      intermediate_size=TRAIN["inter"],
                      num_hidden_layers=layers,
                      num_attention_heads=TRAIN["heads"],
                      num_key_value_heads=TRAIN["kv_heads"],
                      max_position_embeddings=TRAIN["seq"], recompute=True,
                      **(cfg_kw or {}))
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype, seed=seed,
                             init=(device is None) if init is None else init)
    model.train()
    crit = LlamaPretrainingCriterion(cfg)
    if make_opt is None:
        opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True)
    else:
        opt = make_opt(model.parameters())
    if cfg_kw:
        loss_fn = lambda net, t, l: net(t, labels=l)[0]  # noqa: E731
    else:
        loss_fn = lambda net, t, l: crit(net(t), l)  # noqa: E731
    step = TrainStep(model, loss_fn, opt, **step_kw)
    return cfg, model, opt, step


def _train_batch(torch, cfg, batch, seq, seed, device):
    """Tokens then labels from one ``np.random.default_rng(seed)``, as
    ``examples/llama_pretrain.py:98-104`` makes them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return (torch.from_numpy(tokens).to(device),
            torch.from_numpy(labels).to(device))


def _finite_params(torch, model):
    for name, p in model.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"parameter {name} is not finite")


def phase_training(torch, seed, smi):
    """Phase 5.  Returns the kernels' launch counts of the 6 steps."""
    from paddle_tpu_torch.ops import KERNELS
    b, s, nl = TRAIN["batch"], TRAIN["seq"], TRAIN["layers"]
    t0 = time.perf_counter()
    cfg, model, opt, step = _train_setup(torch, nl, "bfloat16", seed)
    tokens, labels = _train_batch(torch, cfg, b, s, seed, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    _log(f"training model: {nl} layers at 1.1B width, bfloat16, "
         f"{n_params / 1e9:.3f} B params, built in "
         f"{time.perf_counter() - t0:.2f} s")
    per_step = _train_per_step(nl)
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(tokens, labels)]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    if launches != per_step:
        raise AssertionError(f"launches in one train step {launches} != "
                             f"expected {per_step}")
    n_timed = 5
    t0 = time.perf_counter()
    for _ in range(n_timed):
        losses.append(step(tokens, labels))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    launches = {name: k.launches for name, k in KERNELS.items()}
    want = {name: (n_timed + 1) * n for name, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"launches in {n_timed + 1} train steps "
                             f"{launches} != expected {want}")
    losses = [float(x) for x in losses]
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    _finite_params(torch, model)
    peak = torch.cuda.max_memory_allocated()
    n_embed = model.llama.embed_tokens.weight.numel()
    flops_per_token = (6.0 * (n_params - n_embed)
                       + 6.0 * nl * s * cfg.hidden_size)
    tok_s = b * s / step_s
    mfu = flops_per_token * tok_s / PEAK_OPS["bfloat16"]
    _log(f"training: losses {['%.4f' % x for x in losses]}; warm-up step "
         f"{warm:.3f} s; step {step_s * 1e3:.1f} ms over {n_timed} steps = "
         f"{tok_s:.1f} tokens/s; peak memory {peak / 2 ** 30:.2f} GiB; "
         f"launches {launches}")
    _log(f"training MFU {100 * mfu:.2f}% ({flops_per_token / 1e9:.3f} "
         f"GFLOP/token x {tok_s:.1f} tokens/s against 989 TFLOP/s bf16 "
         f"dense) on {smi}")
    _profile_train_step(torch, step, tokens, labels)
    del step, opt, model
    torch.cuda.empty_cache()
    return launches


def _profile_train_step(torch, step, tokens, labels):
    """Where a train step's time goes: one step under ``torch.profiler``
    (device busy time = sum of CUDA kernel durations over the host wall
    of the profiled step), the kernels that take most of it, and RoPE's
    and RMSNorm's share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tokens, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel, count = _profile_kernels(torch, prof)
    if not per_kernel:
        _log(f"train profile: wall {wall * 1e3:.1f} ms; device time not "
             f"measured (the profiler recorded no CUDA kernels)")
        return
    busy = sum(per_kernel.values()) / 1e3
    _log(f"train profile: 1 step, wall {wall * 1e3:.1f} ms profiled; device "
         f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of the "
         f"wall), {len(per_kernel)} distinct kernels")
    # busy time by origin: the port's kernels (the fused AdamW apart),
    # cuBLAS GEMMs, and PyTorch's own kernels (elementwise, reductions,
    # copies: the unfused optimizer update lands here)
    groups = {"port kernels": 0.0, "of which fused AdamW": 0.0,
              "cuBLAS GEMMs": 0.0, "other PyTorch kernels": 0.0}
    for name, us in per_kernel.items():
        if "(anonymous namespace)::" in name:
            groups["port kernels"] += us
            if "fused_adamw_kernel" in name:
                groups["of which fused AdamW"] += us
        elif name.startswith("nvjet") or "gemm" in name.lower():
            groups["cuBLAS GEMMs"] += us
        else:
            groups["other PyTorch kernels"] += us
    _log("  by origin: " + "; ".join(
        f"{k} {us / 1e3:.3f} ms ({100 * us / 1e3 / busy:.1f}%)"
        for k, us in groups.items()))
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        _log(f"  {us / 1e3:9.3f} ms  {100 * us / 1e3 / busy:5.1f}%  "
             f"{name[:90]}")
    for key in ("rope", "rms_norm"):
        ms, launches = _by_name(per_kernel, count, key)
        _log(f"  {key}: {ms:.3f} ms over {launches} launches "
             f"({100 * ms / busy:.2f}% of busy)")


def _warmup_cosine(peak=3e-4):
    """(make_opt, scheduler): the 1.1B recipe's AdamW with bf16 moments
    by stochastic rounding (``multi_precision=False``, the JAX package's
    default) under a linear warm-up over cosine decay."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(peak, T_max=100),
                            warmup_steps=1, start_lr=peak / 2, end_lr=peak)
    return (lambda params: AdamW(learning_rate=sched, parameters=params,
                                 grad_clip=ClipGradByGlobalNorm(1.0),
                                 multi_precision=False)), sched


ROUTE_FLAGS = {"FLAGS_flash_onepass_bwd": False,
               "FLAGS_use_fused_adamw_kernel": True}


def phase_training_routes(torch, seed, smi):
    """Phase 5b: the 1.1B model with the flag-selected routes (two-pass
    flash backward, fused AdamW with bf16 moments by stochastic
    rounding), an LR schedule and gradient merge over 2 calls; 6 calls
    (3 updates) with exact launch counts per call.  Returns the
    kernels' launch counts of the 6 calls."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import KERNELS
    b, s, nl = TRAIN["batch"], TRAIN["seq"], TRAIN["layers"]
    old_flags = ptt.get_flags(list(ROUTE_FLAGS))
    ptt.set_flags(ROUTE_FLAGS)
    try:
        t0 = time.perf_counter()
        make_opt, sched = _warmup_cosine()
        cfg, model, opt, step = _train_setup(torch, nl, "bfloat16", seed,
                                             make_opt=make_opt,
                                             accumulate_steps=2)
        tokens, labels = _train_batch(torch, cfg, b, s, seed, "cuda")
        torch.cuda.synchronize()
        n_tensors = len(step._params)
        n_params = sum(p.numel() for p in step._params)
        _log(f"training routes: {nl} layers at 1.1B width, bfloat16, "
             f"{n_tensors} parameter tensors, AdamW(multi_precision=False) "
             f"with LinearWarmup over CosineAnnealingDecay, "
             f"accumulate_steps=2, flags {ROUTE_FLAGS}; built in "
             f"{time.perf_counter() - t0:.2f} s")
        hold = {name: 0 for name in KERNELS}
        hold.update({"flash_attention_fwd": 2 * nl,
                     "flash_attention_bwd_dq": nl,
                     "flash_attention_bwd_dkv": nl,
                     "rope": 6 * nl, "rms_norm": 4 * nl + 1})
        fire = dict(hold, fused_adamw=n_tensors)
        for k in KERNELS.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, times, lrs = [], [], []
        for call in range(1, 7):
            before = {name: k.launches for name, k in KERNELS.items()}
            lrs.append(opt.get_lr())
            t0 = time.perf_counter()
            losses.append(float(step(tokens, labels)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = {name: k.launches - before[name]
                   for name, k in KERNELS.items()}
            want = fire if call % 2 == 0 else hold
            if got != want:
                raise AssertionError(f"training routes call {call}: "
                                     f"launches {got} != expected {want}")
            if call % 2 == 0:
                sched.step()
        launches = {name: k.launches for name, k in KERNELS.items()}
        if not all(x == x and abs(x) != float("inf") for x in losses):
            raise AssertionError(f"training routes: losses not finite: "
                                 f"{losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"training routes: loss did not fall: "
                                 f"{losses}")
        _finite_params(torch, model)
        if any(st["m"].dtype != torch.bfloat16 for st in step._state):
            raise AssertionError("training routes: moments are not bf16")
        peak = torch.cuda.max_memory_allocated()
        n_embed = model.llama.embed_tokens.weight.numel()
        flops_per_token = (6.0 * (n_params - n_embed)
                           + 6.0 * nl * s * cfg.hidden_size)
        call_s = sum(times[1:]) / 5
        tok_s = b * s / call_s
        mfu = flops_per_token * tok_s / PEAK_OPS["bfloat16"]
        _log(f"training routes: losses {['%.4f' % x for x in losses]}; lr "
             f"{['%.3g' % x for x in lrs]}; call times ms "
             f"{['%.1f' % (t * 1e3) for t in times]} (firing calls 2, 4, "
             f"6); mean of calls 2-6 {call_s * 1e3:.1f} ms = {tok_s:.1f} "
             f"tokens/s, MFU {100 * mfu:.2f}% on {smi}; peak memory "
             f"{peak / 2 ** 30:.2f} GiB; launches {launches}")
        step(tokens, labels)                 # call 7 holds; 8 fires
        _profile_train_step(torch, step, tokens, labels)
        del step, opt, model
        torch.cuda.empty_cache()
    finally:
        ptt.set_flags(old_flags)
    return launches


def phase_train_exactness(torch, seed, label="train exactness",
                          make_opt=None, flags=None,
                          launched=("flash_attention_bwd",),
                          not_launched=("flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv",
                                        "fused_adamw"),
                          accumulate_steps=1, cfg_kw=None, cpu_ref=None,
                          fwd_per_layer=2, layers=2):
    """Phase 6: 2 float32 train steps of a ``layers``-deep model (2 in
    phase 6 and under 6c's remat policies, ``TRAIN_EXACT_CUT_LAYERS``
    elsewhere) at 1.1B width, batch 1 x 256, on the card (kernels) and on the CPU (plain versions)
    from the same state dict and batch (2 updates: with
    ``accumulate_steps`` k, 2 k calls, each update merging k).  Bounds, set with room around
    what the run measures (float32 sums in other orders give a loss
    difference near 1e-7 relative and parameters within about 1e-5):
    losses within rtol 1e-6; parameters: at most 1e-6 of the elements
    past 1e-4, and none past lr (a gradient of the wrong sign puts a
    parameter about 2 lr off after one Adam step).  ``make_opt(params)``
    (once per side) returns (optimizer, scheduler or None); the
    scheduler steps after each step.  ``flags`` are set for the phase
    and restored after.  The kernels in ``launched`` must have run on
    the card, those in ``not_launched`` must not; the flash forward ran
    ``fwd_per_layer`` times a layer a call.  ``cfg_kw`` adds config
    fields (phase 6c: a remat policy, the fused loss).  ``cpu_ref``, the
    (losses, parameters) this function returned for another arm, stands
    in for the CPU run where the CPU's values are known to be the same
    (a remat policy changes no value on the CPU, bit for bit:
    ``tests/test_torch_remat.py``).  Returns the CPU's (losses,
    parameters)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import KERNELS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_steps, lr = 2 * accumulate_steps, 3e-4
    old_flags = ptt.get_flags(list(flags or {}))
    ptt.set_flags(flags or {})
    try:
        scheds = []

        def opt_for(params):
            opt, sched = make_opt(params)
            scheds.append(sched)
            return opt

        kw = {} if make_opt is None else dict(make_opt=opt_for)
        if accumulate_steps > 1:
            kw["accumulate_steps"] = accumulate_steps
        cfg, gpu, _, gstep = _train_setup(torch, layers, "float32",
                                          seed + 2, cfg_kw=cfg_kw, **kw)
        if cpu_ref is None:
            _, cpu, _, cstep = _train_setup(torch, layers, "float32",
                                            seed + 2, "cpu", cfg_kw=cfg_kw,
                                            **kw)
            cpu.load_state_dict({k: v.cpu()
                                 for k, v in gpu.state_dict().items()})
        tokens, labels = _train_batch(torch, cfg, 1, 256, seed + 2, "cpu")
        for k in KERNELS.values():
            k.launches = 0
        gl = []
        t0 = time.perf_counter()
        for _ in range(n_steps):
            gl.append(float(gstep(tokens, labels)))
            if scheds and scheds[0] is not None:
                scheds[0].step()
        launches = {name: k.launches for name, k in KERNELS.items()}
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        if cpu_ref is None:
            cl = []
            for _ in range(n_steps):
                cl.append(float(cstep(tokens, labels)))
                if scheds and scheds[1] is not None:
                    scheds[1].step()
            cparams = {n: p.detach() for n, p in cpu.named_parameters()}
            del cpu, cstep
        else:
            cl, cparams = cpu_ref
        t_cpu = time.perf_counter() - t0
    finally:
        ptt.set_flags(old_flags)
    for name in ("flash_attention_fwd", "rope", "rms_norm") + tuple(launched):
        if launches[name] == 0:
            raise AssertionError(f"{label}: {name} never launched")
    for name in not_launched:
        if launches[name] != 0:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times")
    if launches["flash_attention_fwd"] != fwd_per_layer * layers * n_steps:
        raise AssertionError(f"{label}: flash forward launched "
                             f"{launches['flash_attention_fwd']} times, "
                             f"expected {fwd_per_layer} a layer a call")
    rel = max(abs(g - c) / abs(c) for g, c in zip(gl, cl))
    if rel > 1e-6:
        raise AssertionError(f"{label}: card losses {gl} vs CPU "
                             f"{cl} (rel {rel:.3g})")
    worst, n_bad, n_all = 0.0, 0, 0
    for name, p in gpu.named_parameters():
        diff = (p.detach().cpu() - cparams[name]).abs()
        worst = max(worst, diff.max().item())
        n_bad += int((diff > 1e-4).sum())
        n_all += diff.numel()
    if worst > lr or n_bad > 1e-6 * n_all:
        raise AssertionError(
            f"{label}: parameters differ by up to {worst:.3g} "
            f"(bound {lr:.3g}), {n_bad} of {n_all} elements past 1e-4")
    src = " (the full arm's CPU run)" if cpu_ref else ""
    _log(f"{label}: {layers} layers at 1.1B width, float32, batch 1x256, "
         f"{n_steps} calls, accumulate_steps={accumulate_steps}: losses card {gl} CPU {cl} (max rel diff "
         f"{rel:.3g}); parameters max |diff| {worst:.3g}, {n_bad} of "
         f"{n_all} elements past 1e-4; card {t_gpu:.2f} s, CPU "
         f"{t_cpu:.2f} s{src}; "
         f"launches {launches}")
    del gpu, gstep
    torch.cuda.empty_cache()
    return cl, cparams


# the depth of phase 6b's runs, 6c's fused-loss arm and 6c's AMP check:
# 1 layer at 1.1B width, cut from phase 6's 2 for the smoke's time (each
# route and check is a layer's or the head's; phase 6 and 6c's remat
# policies keep 2 layers, where save_attn_mlp/2 alternates)
TRAIN_EXACT_CUT_LAYERS = 1


def phase_train_exactness_routes(torch, seed):
    """Phase 6b: phase 6 under the flag-selected routes (two-pass flash
    backward, fused AdamW) at ``TRAIN_EXACT_CUT_LAYERS``, first with Adam (coupled decay: the unfused
    update), then with AdamW under a warm-up/cosine schedule and gradient
    merge over 2 calls (the fused kernel on the card, its plain version
    on the CPU, fed the merged gradients)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Adam, AdamW, lr

    def adam(params):
        return Adam(learning_rate=3e-4, parameters=params, weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0),
                    multi_precision=True), None

    def adamw(params):
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=10),
                                warmup_steps=1, start_lr=1e-4, end_lr=3e-4)
        return AdamW(learning_rate=sched, parameters=params,
                     grad_clip=ClipGradByGlobalNorm(1.0),
                     multi_precision=True), sched

    # the unfused update's bf16 moment store (one noise tile per store,
    # broadcast over the rows): the card's bits must be the CPU's
    from paddle_tpu_torch.jit import train_step as tts
    gen = torch.Generator().manual_seed(seed + 6)
    x = torch.randn(TRAIN["inter"], TRAIN["hidden"], generator=gen) * 1e-3
    key = 0x9E3779B97F4A7C15 ^ seed
    card = tts._stochastic_round_bf16(x.cuda(), key).cpu()
    host = tts._stochastic_round_bf16(x, key)
    n_diff = int((card.view(torch.int16) != host.view(torch.int16)).sum())
    if n_diff:
        raise AssertionError(f"train exactness routes: tile-form stochastic "
                             f"rounding differs between card and CPU in "
                             f"{n_diff} of {x.numel()} elements")
    _log(f"train exactness routes: tile-form stochastic rounding of "
         f"{list(x.shape)} bit-identical on card and CPU")
    twopass = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    phase_train_exactness(torch, seed, "train exactness routes, Adam", adam,
                          ROUTE_FLAGS, twopass,
                          ("flash_attention_bwd", "fused_adamw"),
                          layers=TRAIN_EXACT_CUT_LAYERS)
    phase_train_exactness(torch, seed, "train exactness routes, AdamW + "
                          "schedule + merge", adamw, ROUTE_FLAGS,
                          twopass + ("fused_adamw",),
                          ("flash_attention_bwd",), accumulate_steps=2,
                          layers=TRAIN_EXACT_CUT_LAYERS)


def _train_per_step(nl, fwd_per_layer=2):
    """Kernel launches of one full-width train step (forward, backward
    and the recompute of every decoder layer): the flash forward
    ``fwd_per_layer`` times a layer (2: it runs again in the recompute;
    1 under a policy that keeps O and LSE), RoPE on q and k in the
    forward, the recompute and the backward, both RMSNorms of a layer in
    the forward and the recompute, and the final norm."""
    from paddle_tpu_torch.ops import KERNELS
    per = {name: 0 for name in KERNELS}
    per.update({"flash_attention_fwd": fwd_per_layer * nl,
                "flash_attention_bwd": nl, "rope": 6 * nl,
                "rms_norm": 4 * nl + 1})
    return per


def _flops_per_token(cfg, model, s):
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = model.llama.embed_tokens.weight.numel()
    return 6.0 * (n_params - n_embed) + 6.0 * cfg.num_hidden_layers * s \
        * cfg.hidden_size


def _finite(losses):
    return all(x == x and abs(x) != float("inf") for x in losses)


# phase 5c's arms: (name, LlamaConfig fields, flash forwards a layer)
POLICY_ARMS = (
    ("full", {}, 2),
    ("save_attn", dict(recompute_policy="save_attn"), 1),
    ("save_attn_mlp/2 alt save_attn", dict(
        recompute_policy="save_attn_mlp", recompute_policy_stride=2,
        recompute_policy_alt="save_attn"), 1),
    ("dots", dict(recompute_policy="dots"), 2),
    ("full + fused loss", dict(fused_linear_loss=True), 2))
# later losses of a policy arm against full's: one bf16 ulp relative
# (2^-8; the one-pass backward's dQ atomics make the updates differ in
# their last bits); the fused loss against full's: 1e-2 relative (full's
# loss is bf16 log-softmax values summed and rounded to bf16, 2^-8
# relative each; the fused loss keeps fp32 logits and an fp32 LSE)
POLICY_LOSS_RTOL = 2.0 ** -8
FUSED_LOSS_RTOL = 1e-2


def phase_training_policies(torch, seed, smi):
    """Phase 5c: the 1.1B model of phase 5 (bf16, batch 8 x 2048,
    ``TrainStep`` with AdamW) under each remat policy of
    ``POLICY_ARMS`` and with the fused loss, then full again, every arm
    from the same state dict: 1 warm-up and 3 timed steps each with exact launch
    counts; the policy arms' first loss bit-equal to full's (the same
    forward), later losses within ``POLICY_LOSS_RTOL``, the fused arm's
    within ``FUSED_LOSS_RTOL``; losses finite and falling; step time,
    tokens/s, MFU and peak memory per arm.  Returns the launches of all
    arms."""
    from paddle_tpu_torch.ops import KERNELS
    b, s, nl = TRAIN["batch"], TRAIN["seq"], TRAIN["layers"]
    t0 = time.perf_counter()
    cfg, model, _, _ = _train_setup(torch, nl, "bfloat16", seed)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    tokens, labels = _train_batch(torch, cfg, b, s, seed, "cuda")
    total = {name: 0 for name in KERNELS}
    ref = None
    # full again last: the first arm's step time against the last's is
    # the phase's own spread
    for name, cfg_kw, fwd in POLICY_ARMS + (("full, again", {}, 2),):
        cfg, model, _, step = _train_setup(
            torch, nl, "bfloat16", seed, cfg_kw=dict(cfg_kw) or
            dict(recompute_policy=None), init=False)
        model.load_state_dict(state)
        per_step = _train_per_step(nl, fwd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in KERNELS.values():
            k.launches = 0
        losses = [float(step(tokens, labels))]
        got = {n: k.launches for n, k in KERNELS.items()}
        if got != per_step:
            raise AssertionError(f"policies {name}: launches in one step "
                                 f"{got} != expected {per_step}")
        t1 = time.perf_counter()
        for _ in range(3):
            losses.append(step(tokens, labels))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / 3
        losses = [float(x) for x in losses]
        got = {n: k.launches for n, k in KERNELS.items()}
        if got != {n: 4 * c for n, c in per_step.items()}:
            raise AssertionError(f"policies {name}: launches in 4 steps "
                                 f"{got} != 4 x {per_step}")
        for n, c in got.items():
            total[n] += c
        if not _finite(losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"policies {name}: losses not finite and "
                                 f"falling: {losses}")
        if ref is None:
            ref = losses
        elif cfg_kw.get("fused_linear_loss"):
            bad = [(a, r) for a, r in zip(losses, ref)
                   if abs(a - r) > FUSED_LOSS_RTOL * abs(r)]
            if bad:
                raise AssertionError(f"policies {name}: losses {losses} "
                                     f"off full's {ref}: {bad}")
        else:
            if losses[0] != ref[0]:
                raise AssertionError(f"policies {name}: first loss "
                                     f"{losses[0]!r} != full's {ref[0]!r}")
            bad = [(a, r) for a, r in zip(losses, ref)
                   if abs(a - r) > POLICY_LOSS_RTOL * abs(r)]
            if bad:
                raise AssertionError(f"policies {name}: losses {losses} "
                                     f"off full's {ref}: {bad}")
        _finite_params(torch, model)
        peak = torch.cuda.max_memory_allocated()
        tok_s = b * s / step_s
        mfu = _flops_per_token(cfg, model, s) * tok_s / PEAK_OPS["bfloat16"]
        _log(f"policies {name}: losses {['%.6f' % x for x in losses]}; "
             f"step {step_s * 1e3:.1f} ms over 3 steps = {tok_s:.1f} "
             f"tokens/s, MFU {100 * mfu:.2f}%; peak memory "
             f"{peak / 2 ** 30:.2f} GiB; launches a step {per_step} "
             f"on {smi}")
        del step, model
        torch.cuda.empty_cache()
    del state
    torch.cuda.empty_cache()
    _log(f"policies: {len(POLICY_ARMS) + 1} arms in "
         f"{time.perf_counter() - t0:.1f} s")
    return total


def _eager_arm(torch, seed, smi, name, dtype, level, total,
               inf_step=False):
    """One eager loop of phase 5d: ``loss.backward(); opt.step();
    opt.clear_grad()`` for 3 steps (AMP ``level`` and a ``GradScaler``
    when given; O2 through ``decorate``), exact launches a step, losses
    finite and falling; with ``inf_step`` a fourth step whose gradient
    holds an inf must leave the parameters as they were and halve the
    scale."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import KERNELS
    from paddle_tpu_torch.optimizer import AdamW
    b, s, nl = TRAIN["batch"], TRAIN["seq"], TRAIN["layers"]
    cfg = LlamaConfig(vocab_size=TRAIN["vocab"], hidden_size=TRAIN["hidden"],
                      intermediate_size=TRAIN["inter"], num_hidden_layers=nl,
                      num_attention_heads=TRAIN["heads"],
                      num_key_value_heads=TRAIN["kv_heads"],
                      max_position_embeddings=s, recompute=True)
    model = LlamaForCausalLM(cfg, dtype=dtype, seed=seed)
    model.train()
    tokens, labels = _train_batch(torch, cfg, b, s, seed, "cuda")
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0),
                multi_precision=dtype == "bfloat16")
    if level == "O2":
        model, opt = amp.decorate(model, opt, level="O2")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15) if level else None

    def one_step():
        with amp.auto_cast(enable=level is not None, level=level or "O1"):
            loss = model(tokens, labels=labels)[0]
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
        opt.clear_grad()
        return loss.detach()

    per_step = _train_per_step(nl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k.launches = 0
    times, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(one_step()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = {n: k.launches for n, k in KERNELS.items()}
    if got != {n: 3 * c for n, c in per_step.items()}:
        raise AssertionError(f"eager {name}: launches in 3 steps {got} != "
                             f"3 x {per_step}")
    for n, c in got.items():
        total[n] += c
    if not _finite(losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"eager {name}: losses not finite and falling: "
                             f"{losses}")
    _finite_params(torch, model)
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times[1:]) / 2
    dtypes = sorted({str(p.dtype).replace("torch.", "")
                     for p in model.parameters()})
    _log(f"eager {name}: parameters {dtypes}, losses "
         f"{['%.4f' % x for x in losses]}; step times ms "
         f"{['%.1f' % (t * 1e3) for t in times]} (steps 2-3 "
         f"{step_s * 1e3:.1f} ms = {b * s / step_s:.1f} tokens/s); peak "
         f"memory {peak / 2 ** 30:.2f} GiB; launches a step {per_step} "
         f"on {smi}")
    if inf_step:
        with amp.auto_cast(level=level):
            loss = model(tokens, labels=labels)[0]
        scaler.scale(loss).backward()
        probe = model.llama.layers[0].mlp.down_proj.weight
        probe.grad[0, 0] = float("inf")
        before = [p.detach().clone() for p in model.parameters()]
        scale = float(scaler.get_loss_scaling())
        scaler.step(opt)
        skipped = scaler._found_inf
        scaler.update()
        opt.clear_grad()
        same = all(torch.equal(a, p.detach())
                   for a, p in zip(before, model.parameters()))
        new_scale = float(scaler.get_loss_scaling())
        if not (skipped and same and new_scale == scale / 2):
            raise AssertionError(
                f"eager {name}: the inf step did not skip (found_inf "
                f"{skipped}, parameters unchanged {same}, scale {scale} -> "
                f"{new_scale})")
        _log(f"eager {name}: an inf gradient skipped the update "
             f"(parameters unchanged) and the scale fell {scale:g} -> "
             f"{new_scale:g}")
    del opt, model, scaler
    torch.cuda.empty_cache()


def phase_eager_amp(torch, seed, smi):
    """Phase 5d: the twin of ``examples/llama_pretrain.py`` at its
    defaults with ``--steps 2`` (3 TrainStep calls, exact launches),
    then eager loops at the same width: bf16 parameters with
    AdamW(multi_precision=True); fp32 parameters under
    ``auto_cast("O1")`` with a ``GradScaler`` and one injected inf step;
    O2 through ``decorate``.  Returns the launches of all of it."""
    from paddle_tpu_torch.examples import llama_pretrain
    from paddle_tpu_torch.ops import KERNELS
    b, s, nl = TRAIN["batch"], TRAIN["seq"], TRAIN["layers"]
    total = {name: 0 for name in KERNELS}
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    losses = llama_pretrain.main(["--steps", "2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: k.launches for n, k in KERNELS.items()}
    want = {n: 3 * c for n, c in _train_per_step(nl).items()}
    if got != want:
        raise AssertionError(f"pretrain example: launches {got} != {want}")
    if not _finite(losses):
        raise AssertionError(f"pretrain example: losses {losses}")
    for n, c in got.items():
        total[n] += c
    _log(f"pretrain example (python -m paddle_tpu_torch.examples."
         f"llama_pretrain --steps 2): losses {['%.4f' % x for x in losses]}; "
         f"{wall:.1f} s with the model's build")
    _eager_arm(torch, seed, smi, "bf16 + AdamW(multi_precision)",
               "bfloat16", None, total)
    _eager_arm(torch, seed, smi, "fp32 + O1 + GradScaler", "float32", "O1",
               total, inf_step=True)
    _eager_arm(torch, seed, smi, "O2 through decorate + GradScaler",
               "float32", "O2", total)
    return total


def _optimizer_cases(torch):
    """Phase 6c (b): every eager optimizer, built over the given
    parameters."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.regularizer import L1Decay
    return {
        "SGD": lambda ps: O.SGD(0.1, parameters=ps, weight_decay=0.01),
        "Momentum": lambda ps: O.Momentum(0.05, parameters=ps,
                                          use_nesterov=True),
        "Adam": lambda ps: O.Adam(1e-3, parameters=ps, weight_decay=0.01),
        "AdamW": lambda ps: O.AdamW(
            1e-3, parameters=ps, grad_clip=ClipGradByGlobalNorm(1.0)),
        "Adamax": lambda ps: O.Adamax(1e-3, parameters=ps),
        "Lamb": lambda ps: O.Lamb(1e-3, parameters=ps),
        "RMSProp": lambda ps: O.RMSProp(1e-3, parameters=ps, momentum=0.5,
                                        centered=True),
        "Adagrad": lambda ps: O.Adagrad(0.01, parameters=ps),
        "Adadelta": lambda ps: O.Adadelta(1.0, parameters=ps,
                                          weight_decay=L1Decay(1e-4)),
        "LBFGS": lambda ps: O.LBFGS(0.1, parameters=ps, history_size=4),
    }


# phase 6c (b): eager updates card against CPU.  The same float32
# elementwise operations (sqrt and division correctly rounded on both);
# Lamb's norms and LBFGS's dots sum in other orders: 1e-5 of the larger
# of 1 and the value
OPT_TOL = 1e-5


def _optimizer_exactness(torch, seed):
    gen = torch.Generator().manual_seed(seed + 61)
    h, f, kv = TRAIN["hidden"], TRAIN["inter"], \
        TRAIN["kv_heads"] * TRAIN["head_dim"]
    shapes = [(h, h), (kv, h), (f, h), (h, f), (h,)]
    init = [torch.randn(sh, generator=gen) * 0.02 for sh in shapes]
    grads = [[torch.randn(sh, generator=gen) * 0.01 for sh in shapes]
             for _ in range(2)]
    t0 = time.perf_counter()
    worst_all = 0.0
    for name, make in _optimizer_cases(torch).items():
        sides = {}
        for dev in ("cuda", "cpu"):
            ps = [torch.nn.Parameter(x.to(dev, copy=True)) for x in init]
            opt = make(ps)
            for gs in grads:
                if name == "LBFGS":
                    def closure(ps=ps, gs=gs, dev=dev):
                        for p, g in zip(ps, gs):
                            p.grad = g.to(dev)
                        return torch.zeros(())
                    opt.step(closure)
                else:
                    for p, g in zip(ps, gs):
                        p.grad = g.to(dev)
                    opt.step()
            sides[dev] = [p.detach().cpu() for p in ps]
        worst = max(((a - b_).abs() / torch.clamp_min(b_.abs(), 1.0))
                    .max().item() for a, b_ in zip(sides["cuda"],
                                                   sides["cpu"]))
        if worst > OPT_TOL:
            raise AssertionError(f"optimizer exactness {name}: card and CPU "
                                 f"differ by {worst:.3g} (bound {OPT_TOL})")
        worst_all = max(worst_all, worst)
    _log(f"optimizer exactness: {len(_optimizer_cases(torch))} eager "
         f"optimizers, 2 steps over a layer's {len(shapes)} parameter "
         f"shapes at 1.1B width, card against CPU within {worst_all:.3g} "
         f"(bound {OPT_TOL}); {time.perf_counter() - t0:.1f} s")


# phase 6c (c): AMP O1 card against CPU.  bf16 GEMMs round their fp32
# sums to bf16 on both devices after other summation orders, and O1's
# cross entropy runs in bf16: the loss within 2 bf16 ulps (2^-6
# relative), each gradient within 5% of its norm
AMP_LOSS_RTOL = 2.0 ** -6
AMP_GRAD_RTOL = 0.05


def _amp_exactness(torch, seed):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import KERNELS
    torch.backends.cuda.matmul.allow_tf32 = False
    layers = TRAIN_EXACT_CUT_LAYERS
    cfg, gpu, _, _ = _train_setup(torch, layers, "float32", seed + 3)
    _, cpu, _, _ = _train_setup(torch, layers, "float32", seed + 3, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    tokens, labels = _train_batch(torch, cfg, 1, 256, seed + 3, "cpu")
    out = {}
    for k in KERNELS.values():
        k.launches = 0
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        with amp.auto_cast(level="O1"):
            loss = model(tokens.to(dev), labels=labels.to(dev))[0]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.float().cpu() for g in grads])
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    if abs(lg - lc) > AMP_LOSS_RTOL * abs(lc):
        raise AssertionError(f"amp exactness: O1 loss card {lg} CPU {lc}")
    worst = max(((a - b_).norm() / b_.norm().clamp_min(1e-30)).item()
                for a, b_ in zip(gg, gc))
    if worst > AMP_GRAD_RTOL:
        raise AssertionError(f"amp exactness: O1 gradients differ by "
                             f"{worst:.3g} of their norm")
    launched = {n: k.launches for n, k in KERNELS.items() if k.launches}
    for n in ("flash_attention_fwd", "flash_attention_bwd", "rope",
              "rms_norm"):
        if n not in launched:
            raise AssertionError(f"amp exactness: {n} never launched")
    _log(f"amp exactness: O1, {layers} layers at 1.1B width, fp32 parameters, "
         f"batch 1x256: loss card {lg} CPU {lc}; gradients within "
         f"{worst:.3g} of their norm (bound {AMP_GRAD_RTOL}); launches "
         f"{launched}")
    del gpu, cpu
    torch.cuda.empty_cache()


def _dropout_exactness(torch, seed):
    """Phase 6c (d): dropout masks from the threefry bits of one draw are
    integers: bit-equal card against CPU, for ``F.dropout`` and for the
    SDPA probabilities' mask; SDPA with dropout within float32's 1e-5."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core import generator as gen
    from paddle_tpu_torch.nn import functional as F
    x = torch.randn(8, 512, 1024, generator=torch.Generator().manual_seed(
        seed + 71))
    outs = {}
    for dev in ("cuda", "cpu"):
        ptt.seed(seed + 7)
        outs[dev] = F.dropout(x.to(dev), p=0.1).cpu()
    if not torch.equal(outs["cuda"], outs["cpu"]):
        raise AssertionError("dropout exactness: F.dropout differs between "
                             "card and CPU")
    b, sq, hq, hk, d = 2, 256, 8, 2, 64
    g = torch.Generator().manual_seed(seed + 72)
    q, k, v = (torch.randn(b, sq, hh, d, generator=g)
               for hh in (hq, hk, hk))
    key = gen.Generator(seed + 8).draw()
    masks = {dev: F._keep_mask(key, 0.8, (b, hq, sq, sq), dev).cpu()
             for dev in ("cuda", "cpu")}
    if not torch.equal(masks["cuda"], masks["cpu"]):
        raise AssertionError("dropout exactness: the SDPA mask differs "
                             "between card and CPU")
    att = {}
    for dev in ("cuda", "cpu"):
        ptt.seed(seed + 9)
        att[dev] = F.scaled_dot_product_attention(
            q.to(dev), k.to(dev), v.to(dev), dropout_p=0.2,
            is_causal=True).cpu()
    err = (att["cuda"] - att["cpu"]).abs().max().item()
    if err > 1e-5:
        raise AssertionError(f"dropout exactness: SDPA with dropout differs "
                             f"by {err:.3g}")
    _log(f"dropout exactness: F.dropout of {list(x.shape)} and the SDPA "
         f"mask of {[b, hq, sq, sq]} bit-equal card and CPU "
         f"({float(masks['cpu'].float().mean()):.4f} kept at 0.8); SDPA "
         f"with dropout within {err:.3g}")


def phase_train_exactness_policies(torch, seed, cpu_full):
    """Phase 6c: phase 6's 2-layer float32 model under each remat policy
    of phase 5c on the card against the CPU's full run (``cpu_full``,
    phase 6's: the CPU's values are the same under every policy), the
    fused loss against its own CPU run (``TRAIN_EXACT_CUT_LAYERS``), then
    (b) every eager optimizer, (c) AMP O1 (``TRAIN_EXACT_CUT_LAYERS``)
    and (d) dropout masks, card against CPU."""
    t0 = time.perf_counter()
    for name, cfg_kw, fwd in POLICY_ARMS[1:]:
        fused = bool(cfg_kw.get("fused_linear_loss"))
        phase_train_exactness(
            torch, seed, f"train exactness {name}", cfg_kw=dict(cfg_kw),
            cpu_ref=None if fused else cpu_full, fwd_per_layer=fwd,
            layers=TRAIN_EXACT_CUT_LAYERS if fused else 2)
    _optimizer_exactness(torch, seed)
    _amp_exactness(torch, seed)
    _dropout_exactness(torch, seed)
    _log(f"train exactness policies, optimizers, AMP, dropout: "
         f"{time.perf_counter() - t0:.1f} s")


# phase 3h: the dense generation programs at full 8B width: (a)
# generate() as a graph against the eager program, (b) LLMPredictor
# sessions, (c) the artifact round trip (depth cut to 1 layer: the file
# holds every weight)
DENSE = dict(prompt=512, new=64, lens=(512, 300, 77, 450))
DENSE_SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)
SESSION = dict(batch=8, prompt_len=512, max_cache_len=1024,
               steps_per_call=16)
SESSION_NEW = 33                     # the first token and two blocks


def _dense_cfg(kw):
    """The ``GenerationConfig`` ``generate(**kw)`` builds."""
    from paddle_tpu_torch.models import GenerationConfig
    keys = ("do_sample", "temperature", "top_k", "top_p", "num_beams",
            "length_penalty", "eos_token_id", "pad_token_id",
            "compute_dtype")
    return GenerationConfig(max_new_tokens=kw["max_new_tokens"],
                            **{k: kw[k] for k in keys if k in kw})


def _profiled(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: (device busy ms, the
    sum of kernel durations, or None when the profiler recorded no CUDA
    kernel; ``{kernel: us}``; ``{kernel: launches}``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel, count = _profile_kernels(torch, prof)
    busy = sum(per_kernel.values()) / 1e3 if per_kernel else None
    return busy, per_kernel, count


def _busy_ms(torch, fn):
    """Device busy ms of one call of ``fn`` (kernel durations in a
    profile), or None when the profiler recorded no CUDA kernel."""
    return _profiled(torch, fn)[0]


def _wall_ms(torch, fn, n=3):
    """The least of ``n`` synced host walls of ``fn``, in ms."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return min(walls)


def _launch_counts():
    from paddle_tpu_torch.ops import KERNELS
    return {k: v.launches for k, v in KERNELS.items() if v.launches}


def _fmt_busy(busy, wall):
    if busy is None:
        return "device busy not measured (no CUDA kernel in the profile)"
    return f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}% of wall)"


def _dense_generate(torch, seed, cfg, model, total):
    """3h (a): each case's graph against the eager program on the same
    inputs; returns the greedy B=4 tokens (the beam case takes its EOS
    from them)."""
    import numpy as np
    from paddle_tpu_torch.inference import threefry
    from paddle_tpu_torch.models.generation import generate_program
    rng = np.random.default_rng(seed + 16)
    s, m = DENSE["prompt"], DENSE["new"]
    dev = next(model.parameters()).device
    ids4 = rng.integers(0, cfg.vocab_size, (4, s)).astype(np.int32)
    lens4 = np.array(DENSE["lens"], np.int32)
    base = dict(max_new_tokens=m, compute_dtype="bfloat16")
    cases = [("greedy B=1", ids4[:1], None, dict(base)),
             ("greedy B=4 ragged", ids4, lens4, dict(base)),
             ("sampled B=4 ragged", ids4, lens4,
              dict(base, seed=seed + 3, **DENSE_SAMPLED))]
    greedy4 = None
    for i in range(len(cases) + 1):
        if i == len(cases):
            eos = int(greedy4[0, 8])
            tag, ids, lens, kw = ("beam K=4 B=2, length_penalty 1.0, EOS "
                                  f"{eos}", ids4[:2], lens4[:2],
                                  dict(base, num_beams=4,
                                       length_penalty=1.0,
                                       eos_token_id=eos))
        else:
            tag, ids, lens, kw = cases[i]
        b = ids.shape[0]
        gkw = dict(kw, seq_lens=lens, max_cache_len=s + m)
        gcfg = _dense_cfg(kw)
        ids_t = torch.from_numpy(ids).to(dev)
        lens_t = torch.from_numpy(lens if lens is not None else
                                  np.full(b, s, np.int32)).to(dev)
        key = threefry.as_key(threefry.prng_key(kw.get("seed", 0)), dev)
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            want = generate_program(model, gcfg, ids_t, lens_t, key, s + m)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        eager = _launch_counts()
        before = set(getattr(model, "_generate_graphs", {}))
        first = model.generate(ids, **gkw)
        new = [g for k, g in model._generate_graphs.items()
               if k not in before]
        if len(new) != 1:
            raise AssertionError(f"dense {tag}: {len(new)} graphs captured "
                                 f"by one call, want 1")
        cap_ms = new[0].prog.capture_s * 1e3
        _zero_launches()
        got = model.generate(ids, **gkw)
        torch.cuda.synchronize()
        replay = _launch_counts()
        _add_launches(total, replay)
        for name, out in (("capture call", first), ("replay", got)):
            if not torch.equal(out, want):
                raise AssertionError(f"dense {tag}: the graph's {name} "
                                     f"tokens differ from the eager "
                                     f"program's")
        if replay != eager or not eager:
            raise AssertionError(f"dense {tag}: launches per replay {replay} "
                                 f"!= the eager program's {eager}")
        wall = _wall_ms(torch, lambda: model.generate(ids, **gkw))
        busy = _busy_ms(torch, lambda: model.generate(ids, **gkw))
        _log(f"dense generate() {tag}, prompt {s}, {m} new: graph == eager "
             f"bit for bit; capture {cap_ms:.1f} ms; replay wall "
             f"{wall:.2f} ms ({b * m / wall * 1e3:.1f} tokens/s), "
             f"{_fmt_busy(busy, wall)}; eager program {eager_ms:.1f} ms; "
             f"launches per replay {replay}")
        if tag.startswith("greedy B=4"):
            greedy4 = got.cpu().numpy()
        if tag.startswith("beam") and not (got == kw["eos_token_id"]).any():
            _log(f"  (EOS {kw['eos_token_id']} not emitted by the best "
                 f"beams)")
    return ids4, lens4, greedy4


def _session_eager(torch, model, pred, ids, lens, n_blocks, seed):
    """The session's programs run eagerly on the card over a state of
    their own: the prefill's first token, then ``n_blocks`` blocks.
    Returns (tokens, the launches of the last block)."""
    import numpy as np
    from paddle_tpu_torch.inference.llm import (SessionState,
                                                session_block,
                                                session_prefill)
    from paddle_tpu_torch.inference import threefry
    st = SessionState(model, pred.cfg, pred.batch, pred.prompt_len,
                      pred.max_cache_len)
    st.ids.copy_(torch.from_numpy(ids))
    st.lens_in.copy_(torch.from_numpy(lens))
    st.key_in.copy_(threefry.as_key(threefry.prng_key(seed)))
    wq = pred._wq.context() if pred._wq is not None else None
    first = session_prefill(model, pred.cfg, st, wq)[0]
    blocks = []
    for _ in range(n_blocks):
        _zero_launches()
        blocks.append(session_block(model, pred.cfg, pred.steps_per_call,
                                    st, wq)[0])
    torch.cuda.synchronize()
    launches = _launch_counts()
    out = torch.cat([first[:, None]] + blocks, dim=1).cpu().numpy()
    del st
    return out.astype(np.int32), launches


def _dense_sessions(torch, seed, cfg, model, ids4, lens4, total):
    """3h (b): three 8-row session arms, then beam."""
    import numpy as np
    from paddle_tpu_torch.inference.llm import LLMPredictor
    rng = np.random.default_rng(seed + 17)
    b, p = SESSION["batch"], SESSION["prompt_len"]
    ids = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)
    lens = rng.integers(64, p + 1, b).astype(np.int32)
    lens[0] = p
    arms = [("greedy", {}, 0), ("sampled", DENSE_SAMPLED, seed + 5),
            ("int8 weights", dict(weight_dtype="int8"), 0)]
    for tag, extra, sseed in arms:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pred = LLMPredictor(model, compute_dtype="bfloat16", **SESSION,
                            **extra)
        torch.cuda.synchronize()
        cap_ms = (time.perf_counter() - t0) * 1e3
        _zero_launches()
        got = pred.generate(ids, seq_lens=lens, max_new_tokens=SESSION_NEW,
                            seed=sseed)
        torch.cuda.synchronize()
        _add_launches(total, _launch_counts())
        n_blocks = (SESSION_NEW - 1) // SESSION["steps_per_call"]
        _zero_launches()
        pred.start(ids, seq_lens=lens, seed=sseed)
        pred.decode(SESSION["steps_per_call"])
        torch.cuda.synchronize()
        _zero_launches()
        pred.decode(SESSION["steps_per_call"])
        torch.cuda.synchronize()
        replay = _launch_counts()
        want, eager = _session_eager(torch, model, pred, ids, lens, n_blocks,
                                     sseed)
        if not np.array_equal(got, want):
            raise AssertionError(f"session {tag}: the graphs' tokens differ "
                                 f"from the eager programs'")
        if replay != eager or not eager:
            raise AssertionError(f"session {tag}: launches per block replay "
                                 f"{replay} != the eager block's {eager}")
        if "weight_dtype" not in extra:
            gen = model.generate(ids, seq_lens=lens,
                                 max_new_tokens=SESSION_NEW,
                                 max_cache_len=SESSION["max_cache_len"],
                                 compute_dtype="bfloat16",
                                 seed=sseed, **extra).cpu().numpy()
            if not np.array_equal(got, gen):
                raise AssertionError(f"session {tag}: tokens differ from "
                                     f"generate()'s")
        pred.start(ids, seq_lens=lens, seed=sseed)
        split = np.concatenate([pred.decode(5), pred.decode(11)], axis=1)
        pred.start(ids, seq_lens=lens, seed=sseed)
        whole = pred.decode(16)
        if not np.array_equal(split, whole):
            raise AssertionError(f"session {tag}: decode(5) + decode(11) != "
                                 f"decode(16)")

        def block():
            pred.start(ids, seq_lens=lens, seed=sseed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.decode(SESSION["steps_per_call"])
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        wall = min(block() for _ in range(3))
        pred.start(ids, seq_lens=lens, seed=sseed)
        busy = _busy_ms(torch, lambda: pred.decode(SESSION["steps_per_call"]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = SESSION["steps_per_call"]
        _log(f"session {tag}: B={b}, prompt {p}, max_cache_len "
             f"{SESSION['max_cache_len']}, {steps} steps a block: graphs == "
             f"eager programs bit for bit"
             f"{'' if 'weight_dtype' in extra else ' and == generate()'}; "
             f"decode(5) + decode(11) == decode(16); construction (both "
             f"captures) {cap_ms:.1f} ms; block wall {wall:.2f} ms "
             f"({b * steps / wall * 1e3:.1f} tokens/s), "
             f"{_fmt_busy(busy, wall)}; peak memory {peak:.2f} GiB; "
             f"launches per block {replay}")
        del pred
    torch.cuda.empty_cache()
    # beam through the session: equal to generate()'s beam
    kw = dict(num_beams=4, length_penalty=1.0)
    pred = LLMPredictor(model, compute_dtype="bfloat16", batch=2,
                        prompt_len=DENSE["prompt"],
                        max_cache_len=SESSION["max_cache_len"],
                        steps_per_call=SESSION["steps_per_call"], **kw)
    _zero_launches()
    got = pred.generate(ids4[:2], seq_lens=lens4[:2],
                        max_new_tokens=DENSE["new"])
    torch.cuda.synchronize()
    _add_launches(total, _launch_counts())
    want = model.generate(ids4[:2], seq_lens=lens4[:2],
                          max_new_tokens=DENSE["new"],
                          max_cache_len=SESSION["max_cache_len"],
                          compute_dtype="bfloat16", **kw).cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError("session beam: tokens differ from generate()'s")
    _log(f"session beam K=4 B=2, {DENSE['new']} new tokens "
         f"({-(-(DENSE['new'] - 1) // SESSION['steps_per_call'])} blocks, "
         f"the last truncated on the host): == generate() bit for bit")
    del pred
    torch.cuda.empty_cache()


def _dense_artifact(torch, seed):
    """3h (c): save() / load() on the card, a 1-layer model at 8B width
    (bf16; the artifact holds every weight, about 2.5 GB)."""
    import tempfile
    import numpy as np
    from paddle_tpu_torch.inference.llm import ARTIFACT_SUFFIX, LLMPredictor
    cfg, small = _build_8b(torch, 1, "bfloat16", seed + 19)
    rng = np.random.default_rng(seed + 19)
    ids = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    pred = LLMPredictor(small, batch=2, prompt_len=64, max_cache_len=128,
                        steps_per_call=8, compute_dtype="bfloat16")
    want = pred.generate(ids, max_new_tokens=17)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        pred.save(os.path.join(td, "serve"))
        t_save = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(td, "serve") + ARTIFACT_SUFFIX)
        del pred, small
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loaded = LLMPredictor.load(os.path.join(td, "serve"))
        t_load = time.perf_counter() - t0
    got = [loaded.generate(ids, max_new_tokens=17) for _ in range(2)]
    for i, g in enumerate(got):
        if not np.array_equal(g, want):
            raise AssertionError(f"artifact: the loaded session's call {i} "
                                 f"differs from the saved one's tokens")
    _log(f"artifact (1 layer at 8B width, bf16): {size / 2 ** 30:.2f} GiB, "
         f"save {t_save:.2f} s, load {t_load:.2f} s (model and both "
         f"captures); two calls of the loaded session == the saved "
         f"session's tokens")
    del loaded
    torch.cuda.empty_cache()


def phase_dense_programs(torch, seed, cfg, model):
    """Phase 3h: the dense generation programs at full Llama-3-8B width
    (phase 3's model).  (a) ``generate()`` as one captured graph against
    the eager ``generate_program`` on the same inputs: greedy B=1 and B=4
    at ragged lengths (prompt 512, 64 new tokens), sampled (T=0.8,
    top_k=50, top_p=0.9, a seed) and beam (K=4, B=2, length penalty 1.0,
    an EOS from the greedy run): tokens bit-equal, each replay counting
    exactly the eager call's launches; capture ms, replay wall against
    device busy, tokens/s.  (b) ``LLMPredictor`` sessions of 8 rows
    (prompt 512, max_cache_len 1024, 16 steps a block): greedy, sampled
    and int8 weights, each's graphs against the eager session programs
    bit for bit with the eager block's launches per block replay, the
    greedy and sampled sessions equal to ``generate()``, ``decode(5) +
    decode(11) == decode(16)``; block wall against busy, tokens/s, peak
    memory; then beam (K=4, B=2) equal to ``generate()``.  (c) the
    artifact round trip on the card.  Returns the launch counts of the
    graph runs."""
    total = {}
    ids4, lens4, _greedy = _dense_generate(torch, seed, cfg, model, total)
    _dense_sessions(torch, seed, cfg, model, ids4, lens4, total)
    _dense_artifact(torch, seed)
    return total


# phase 3i: the engines of the router arms (phase 3's geometry), the
# shared-prefix traffic of (b) and (c) (prefixes of one chunk, 256
# tokens, so a prefix hit leaves the chunk grid where a miss has it),
# the disaggregation trace of (d) and the process replica of (e)
FLEET = dict(num_slots=8, prompt_len=512, chunk_len=256, max_cache_len=1024,
             block_len=16, compute_dtype="bfloat16")
FLEET_WAVES = ((0, 64, 24), (1, 96, 24), (0, 32, 20), (1, 128, 20),
               (0, 160, 16), (1, 48, 16), (0, 100, 12), (1, 200, 12))
FLEET_DISAGG = [(300, 24), (130, 32), (470, 16), (77, 28), (256, 20),
                (390, 12)]
FLEET_CHILD = dict(num_slots=4, prompt_len=256, chunk_len=128,
                   max_cache_len=512, block_len=16)
FLEET_CHILD_LAYERS = 2
FLEET_SOCKET_TRACE = [(230, 24), (150, 24), (200, 20), (256, 16)]
# the child's fault schedule: its engine request 0 is force-swapped to
# the host tier (the parcel ships to the proxy in that step's reply) with
# every later allocation failing, then the process exits
FLEET_FAULT = {"force_swap_rid": 0, "force_swap_step": 5,
               "park_allocs": True, "exit_at_step": 7}
FLEET_FACTORY = "chip_smoke:fleet_child_engine"


def _zero_clock():
    return 0.0


def fleet_child_engine(*, seed=0, layers=FLEET_CHILD_LAYERS,
                       with_fault_injector=False, device="cuda"):
    """The engine factory of phase 3i (e)'s process replica
    (``EngineProcess`` children import it as
    ``chip_smoke:fleet_child_engine``): ``layers`` layers at Llama-3-8B
    width in bf16 with weights from ``seed`` (the same bits in every
    process on the same card), the engine on a constant clock so the
    replies it sends (first-token and finish times) are the same bytes in
    every run."""
    import dataclasses

    from paddle_tpu_torch.inference import FaultInjector, ServingEngine
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_3_8b_config
    from paddle_tpu_torch.observability import MetricsRegistry
    cfg = dataclasses.replace(llama_3_8b_config(),
                              num_hidden_layers=int(layers))
    model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=int(seed),
                             device=device)
    return ServingEngine(model, compute_dtype="bfloat16", clock=_zero_clock,
                         registry=MetricsRegistry(), device=device,
                         fault_injector=(FaultInjector()
                                         if with_fault_injector else None),
                         **FLEET_CHILD)


def _fleet_launches(nl, stats, int8=False):
    """Phase 3i's launch formula over a fleet: phase 3's (RMSNorm 2L+1 per
    forward, the paged decode L per decode step) over the prefill chunks
    and decode steps of every engine in ``stats``; a handoff, a
    migration and a stream launch none."""
    return _serving_launches(nl, {
        "prefill_chunks": sum(s["prefill_chunks"] for s in stats),
        "decode_steps": sum(s["decode_steps"] for s in stats)}, int8)


def _fleet_take(torch, tag, total, nl, stats, int8=False):
    """Check the launches since the last ``_zero_launches`` against the
    fleet formula and add them to ``total``."""
    from paddle_tpu_torch.ops import KERNELS
    launches = {name: k.launches for name, k in KERNELS.items()}
    want = _fleet_launches(nl, stats, int8)
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != "
                             f"expected {want}")
    _add_launches(total, launches)
    return launches


def _drive(torch, rt, handles, max_steps=2000, now=None):
    """Step a router until every handle is terminal; returns (wall s,
    mean TTFT s measured at the router: first step after which a handle
    held a token)."""
    from paddle_tpu_torch.inference import TERMINAL_STATES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = {}
    steps = 0
    while any(h.state not in TERMINAL_STATES for h in handles):
        rt.step(now=now)
        t = time.perf_counter() - t0
        for h in handles:
            if h.router_id not in first and len(h.tokens):
                first[h.router_id] = t
        steps += 1
        if steps > max_steps:
            raise AssertionError(f"router did not drain in {max_steps} "
                                 f"steps: {[h.state for h in handles]}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, sum(first.values()) / max(len(first), 1)


def _fleet_prompts(np, cfg, seed):
    """(b) and (c)'s traffic: two 256-token system prompts, each request
    one of them plus its own tail; wave 1 is one request per prompt, wave
    2 the rest (it finds each prompt cached on one replica)."""
    rng = np.random.default_rng(seed + 17)
    systems = [rng.integers(0, cfg.vocab_size, 256) for _ in range(2)]
    out = []
    for k, tail, m in FLEET_WAVES:
        ids = np.concatenate([systems[k], rng.integers(0, cfg.vocab_size,
                                                       tail)])
        out.append((ids.astype(np.int32), m))
    return out


def _fleet_router_run(torch, cfg, model, prompts, inject=None):
    """(b)/(c): ``Router([e0, e1], affinity=True)`` over two engines that
    share ``model``, wave 1 drained before wave 2 arrives.  ``inject``
    (c): e1 carries a ``FaultInjector``; once it holds two decoding
    requests one is force-swapped (allocations failing, so it stays
    parked) and e1 is killed on its next step.  Returns the router, the
    engines, the handles, wall and TTFT, and the fault's record."""
    import numpy as np
    from paddle_tpu_torch.inference import (TERMINAL_STATES, FaultInjector,
                                            Router, ServingEngine)
    from paddle_tpu_torch.observability import MetricsRegistry
    inj = FaultInjector() if inject else None
    engs = [ServingEngine(model, registry=MetricsRegistry(), **FLEET),
            ServingEngine(model, registry=MetricsRegistry(),
                          fault_injector=inj, **FLEET)]
    rt = Router(engs, affinity=True, registry=MetricsRegistry())
    fault = {}
    if inject:
        seen = fault.setdefault("migrated_in", [])
        orig = engs[0].migrate_in

        def migrate_in(*a, **kw):
            # the bytes the failover hands e0's tier
            if kw.get("parcel") is not None:
                ent = engs[0]._host_tier.entry(kw["parcel"]["key"])
                seen.append([np.array(r, copy=True) for r in ent.rows])
            return orig(*a, **kw)
        engs[0].migrate_in = migrate_in
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w1 = [rt.submit(ids, max_new_tokens=m) for ids, m in prompts[:2]]
    wall1, ttft1 = _drive(torch, rt, w1)
    w2 = [rt.submit(ids, max_new_tokens=m) for ids, m in prompts[2:]]
    handles = w1 + w2
    if inject:
        for _ in range(400):
            rt.step()
            on1 = [h for h in w2 if h.engine == 1 and h.state == "decode"]
            if len(on1) >= 2:
                break
        else:
            raise AssertionError("failover: e1 never held two decoding "
                                 "requests")
        victim = on1[0]
        inj.force_swap(victim.request_id)
        inj.fail_allocs(None)
        rt.step()
        if victim.state != "swapped":
            raise AssertionError(f"failover: the victim is {victim.state}")
        ent = engs[1]._host_tier.entry(victim._req.swap.host_key)
        fault["parcel"] = [np.array(r, copy=True) for r in ent.rows]
        fault["blocks"] = victim._req.swap.n_blocks
        fault["in_flight"] = sum(
            1 for h in handles if h.engine == 1
            and h.state in ("prefill", "decode"))
        inj.kill_at_step(engs[1]._step_idx + 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rt.step()
        torch.cuda.synchronize()
        fault["recovery_s"] = time.perf_counter() - t1
        if rt.health[1] != "unhealthy":
            raise AssertionError("failover: e1 is still in the routing set")
        if any(h.state in TERMINAL_STATES and h.state != "finished"
               for h in handles):
            raise AssertionError("failover: a request ended unfinished")
    wall2, ttft2 = _drive(torch, rt, handles)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rt, engs, handles, wall, (ttft1 + ttft2) / 2, fault


def _alone_tokens(torch, model, prompts):
    """Each request of ``prompts`` served alone, one after another, on one
    fresh 1-slot engine (phase 3i's geometry otherwise)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.observability import MetricsRegistry
    eng = ServingEngine(model, registry=MetricsRegistry(),
                        **dict(FLEET, num_slots=1))
    outs = []
    for ids, m in prompts:
        r = eng.submit(ids, max_new_tokens=m)
        eng.run()
        outs.append(r.output.tolist())
    return outs, eng.stats()


def _fleet_streaming(torch, seed, cfg, model, total, serve_tokens):
    """(a): a depth-1 engine at phase 3's geometry serves phase 3's trace
    with every request streamed, beside the same trace not streamed."""
    from paddle_tpu_torch.inference import ServingEngine
    nl = cfg.num_hidden_layers
    torch.cuda.empty_cache()
    eng = ServingEngine(model, **FLEET)
    launches, plain, wall, n_req, n_tok, _rng, reqs = _serve_trace(
        torch, eng, cfg, seed)
    twin = [r.output.tolist() for r in reqs]
    del eng
    eng = ServingEngine(model, **FLEET)
    log = []
    launches, st, wall, n_req, n_tok, _rng, reqs = _serve_trace(
        torch, eng, cfg, seed, streams=log)
    _check_launches(launches, _serving_launches(nl, st, False), st)
    _add_launches(total, launches)
    cat = [[] for _ in reqs]
    flushes = [0] * len(reqs)
    points = 0
    for chunks, h in log:
        points += h
        for i, c in enumerate(chunks):
            if c:
                if h == 0:
                    raise AssertionError(
                        f"streaming: request {i} flushed {c} at a step "
                        f"with no harvest point")
                cat[i] += c
                flushes[i] += 1
    outs = [r.output.tolist() for r in reqs]
    if cat != outs or outs != twin or (serve_tokens is not None
                                       and outs != serve_tokens):
        raise AssertionError("streaming: a stream's concatenation differs "
                             "from the non-streamed outputs")
    if max(flushes) > points or min(flushes) < 2:
        raise AssertionError(f"streaming: flushes {flushes} for {points} "
                             f"harvest points")
    if st["async_syncs_by_reason"] != plain["async_syncs_by_reason"] or \
            st["async_harvests"] != plain["async_harvests"]:
        raise AssertionError(
            f"streaming: syncs {st['async_syncs_by_reason']} / harvests "
            f"{st['async_harvests']} != the unstreamed run's "
            f"{plain['async_syncs_by_reason']} / {plain['async_harvests']}")
    syncs = {k: v for k, v in st["async_syncs_by_reason"].items() if v}
    _log(f"fleet (a) streaming: {n_req} streamed requests, {n_tok} tokens "
         f"in {wall:.3f} s = {n_tok / wall:.2f} tokens/s; mean TTFT "
         f"{st['mean_ttft_s'] * 1e3:.2f} ms; flushes per stream {flushes} "
         f"over {points} harvest points in {len(log)} steps; every stream "
         f"equal to the unstreamed trace{' and phase 3' if serve_tokens else ''}; "
         f"syncs {syncs or 'none'} (the unstreamed run's); launches "
         f"{launches}")
    del eng


def _fleet_router(torch, seed, cfg, model, total):
    """(b) and (c)."""
    import numpy as np
    from paddle_tpu_torch.inference import Router, ServingEngine
    from paddle_tpu_torch.observability import FlightRecorder, MetricsRegistry
    nl = cfg.num_hidden_layers
    prompts = _fleet_prompts(np, cfg, seed)
    n_tok = sum(m for _, m in prompts)
    torch.cuda.empty_cache()
    _zero_launches()
    rt, engs, hs, wall, ttft, _f = _fleet_router_run(torch, cfg, model,
                                                     prompts)
    st = rt.stats()
    launches = _fleet_take(torch, "router", total, nl,
                           [e.stats() for e in engs])
    outs = [h.output.tolist() for h in hs]
    _finished_in_vocab(hs, [m for _, m in prompts], cfg.vocab_size,
                       "router")
    if st["routed_by_reason"]["prefix"] < 1 or \
            st["prefix_affinity_tokens"] < 256:
        raise AssertionError(f"router: no prefix affinity: {st}")
    _log(f"fleet (b) router: 2 replicas sharing the model, {len(hs)} "
         f"requests, {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} "
         f"tokens/s; mean TTFT at the router {ttft * 1e3:.2f} ms; routed "
         f"{st['routed_by_reason']}, prefix affinity tokens "
         f"{st['prefix_affinity_tokens']}, per replica "
         f"{[e.stats()['prefills'] for e in engs]} prefills, prefix hit "
         f"tokens {[e.stats()['prefix_hit_tokens'] for e in engs]}; "
         f"assignment {[h.engine for h in hs]}; launches {launches}")
    del rt, engs
    # each request alone on a fresh 1-slot engine
    torch.cuda.empty_cache()
    _zero_launches()
    alone, ast = _alone_tokens(torch, model, prompts)
    _fleet_take(torch, "router alone", total, nl, [ast])
    if alone != outs:
        raise AssertionError("router: tokens differ from the requests "
                             "served alone on a 1-slot engine")
    _log(f"fleet (b) router: every request's tokens equal it alone on a "
         f"fresh 1-slot engine")
    # a 1-replica router's flight record is the bare engine's
    recs = []
    for routed in (False, True):
        rec = FlightRecorder()
        eng = ServingEngine(model, registry=MetricsRegistry(),
                            flight_recorder=rec, **FLEET)
        _zero_launches()
        if routed:
            r1 = Router([eng], affinity=False, registry=MetricsRegistry())
            hs1 = [r1.submit(ids, max_new_tokens=m)
                   for ids, m in prompts[:3]]
            _drive(torch, r1, hs1)
        else:
            for ids, m in prompts[:3]:
                eng.submit(ids, max_new_tokens=m)
            eng.run()
        _fleet_take(torch, "router single", total, nl, [eng.stats()])
        recs.append(_strip_events(rec.events()))
        del eng
    if recs[0] != recs[1] or not recs[0]:
        raise AssertionError("router: a 1-replica router's flight record "
                             "differs from the bare engine's")
    _log(f"fleet (b) router: a 1-replica router's flight record equals the "
         f"bare engine's, {len(recs[0])} events")
    # (c) the same trace with e1 killed
    torch.cuda.empty_cache()
    _zero_launches()
    rt, engs, hs, wall, ttft, fault = _fleet_router_run(
        torch, cfg, model, prompts, inject=True)
    st = rt.stats()
    launches = _fleet_take(torch, "failover", total, nl,
                           [e.stats() for e in engs])
    fouts = [h.output.tolist() for h in hs]
    if fouts != outs:
        raise AssertionError("failover: tokens differ from the unfaulted "
                             "run's")
    row = engs[0].block_len * engs[0]._kv_row_bytes
    moved = fault["migrated_in"]
    if not (st["replica_faults"] == 1 and st["failed"] == 0
            and st["migrated_blocks"] == fault["blocks"] > 0
            and st["migrated_bytes"] == fault["blocks"] * row
            and len(moved) == 1 and fault["in_flight"] >= 1):
        raise AssertionError(f"failover: {st} {fault['blocks']} "
                             f"{len(moved)} {fault['in_flight']}")
    nbytes = 0
    for a, b in zip(fault["parcel"], moved[0]):
        if not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
            raise AssertionError("failover: the migrated parcel's bytes "
                                 "differ from the victim's parcel")
        nbytes += a.nbytes
    if nbytes != st["migrated_bytes"]:
        raise AssertionError(f"failover: {nbytes} parcel bytes, "
                             f"{st['migrated_bytes']} migrated")
    paths = {k: int(v) for k, v in
             rt._m.failover_requests._snap()["values"].items()}
    _log(f"fleet (c) failover: e1 killed holding 1 swapped and "
         f"{fault['in_flight']} in-flight requests; recovery step "
         f"{fault['recovery_s'] * 1e3:.1f} ms; migrated "
         f"{st['migrated_blocks']} blocks = {st['migrated_bytes']} bytes, "
         f"the parcel's bytes exactly; recovered by path {paths}; "
         f"{len(hs)} requests, {n_tok} tokens in {wall:.3f} s = "
         f"{n_tok / wall:.2f} tokens/s; mean TTFT at the router "
         f"{ttft * 1e3:.2f} ms; tokens equal the unfaulted run's; launches "
         f"{launches}")
    del rt, engs


def _timed(torch, fn, log, kind):
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        log.append((kind, time.perf_counter() - t0))
        return out
    return run


def _fleet_disagg(torch, seed, cfg, model, total):
    """(d): a prefill-role and a decode-role engine against the
    monolithic engine, over a bf16 and then an int8 KV cache."""
    import numpy as np
    from paddle_tpu_torch.inference import Router, ServingEngine
    from paddle_tpu_torch.observability import MetricsRegistry
    nl = cfg.num_hidden_layers
    rng = np.random.default_rng(seed + 23)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
               for n, m in FLEET_DISAGG]
    n_tok = sum(m for _, m in prompts)
    for kv in (None, "int8"):
        tag = f"fleet (d) disaggregation ({kv or 'bf16'} KV)"
        torch.cuda.empty_cache()
        # the monolithic engine: each request's prompt rows as it enters
        # decode
        mono = ServingEngine(model, registry=MetricsRegistry(),
                             kv_cache_dtype=kv, **FLEET)
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [mono.submit(ids, max_new_tokens=m) for ids, m in prompts]
        rows, copy_s = {}, 0.0
        while any(r.state != "finished" for r in reqs):
            mono.step()
            for r in reqs:
                if r.state == "decode" and r.request_id not in rows:
                    t1 = time.perf_counter()
                    ids = torch.tensor(r.blocks, dtype=torch.long,
                                       device=mono.device)
                    rows[r.request_id] = [
                        a.index_select(0, ids).cpu() for a in mono._arenas]
                    copy_s += time.perf_counter() - t1
        mono.run()
        torch.cuda.synchronize()
        # the monolithic wall without the copies of the rows
        mono_wall = time.perf_counter() - t0 - copy_s
        _fleet_take(torch, tag + " monolithic", total, nl, [mono.stats()],
                    kv == "int8")
        want = [r.output.tolist() for r in reqs]
        del mono
        torch.cuda.empty_cache()
        pre = ServingEngine(model, registry=MetricsRegistry(), role="prefill",
                            kv_cache_dtype=kv, **FLEET)
        dec = ServingEngine(model, registry=MetricsRegistry(), role="decode",
                            kv_cache_dtype=kv, **FLEET)
        rt = Router([pre, dec], registry=MetricsRegistry())
        picked, times = [], []
        take = pre.take_handoffs

        def take_handoffs(_take=take):
            out = _take()
            for r in out:
                ent = pre._host_tier.entry(r.swap.host_key)
                picked.append((r.request_id, r.swap.n_blocks, r.seq_len,
                               ent))
            return out
        pre.take_handoffs = take_handoffs
        pre._handoff_out = _timed(torch, pre._handoff_out, times, "gather")
        pre._host_tier.transfer = _timed(torch, pre._host_tier.transfer,
                                         times, "transfer")
        rt._stage.transfer = _timed(torch, rt._stage.transfer, times,
                                    "transfer")
        dec._scatter_rows = _timed(torch, dec._scatter_rows, times,
                                   "scatter")
        _zero_launches()
        hs = [rt.submit(ids, max_new_tokens=m) for ids, m in prompts]
        wall, ttft = _drive(torch, rt, hs)
        sp, sd = pre.stats(), dec.stats()
        launches = _fleet_take(torch, tag, total, nl, [sp, sd], kv == "int8")
        got = [h.output.tolist() for h in hs]
        if got != want:
            raise AssertionError(f"{tag}: tokens differ from the monolithic "
                                 f"run's")
        if not (sp["handoffs"] == len(prompts) == len(picked)
                and sd["prefills"] == 0 and sd["handoffs"] == 0):
            raise AssertionError(f"{tag}: {sp} {sd}")
        for rid, nb, seq_len, ent in picked:
            for x, a in zip(ent.rows, rows[rid]):
                flat = torch.from_numpy(np.ascontiguousarray(x)).view(
                    a.dtype).reshape((nb * FLEET["block_len"],)
                                     + tuple(a.shape[2:]))
                mine = a.reshape((-1,) + tuple(a.shape[2:]))
                if not torch.equal(flat[:seq_len].view(torch.uint8),
                                   mine[:seq_len].view(torch.uint8)):
                    raise AssertionError(
                        f"{tag}: request {rid}'s parcel rows differ from "
                        f"the monolithic engine's arena rows")
        secs = {k: sum(t for kk, t in times if kk == k)
                for k in ("gather", "transfer", "scatter")}
        _log(f"{tag}: {len(hs)} requests, {n_tok} tokens in {wall:.3f} s = "
             f"{n_tok / wall:.2f} tokens/s (the monolithic engine "
             f"{n_tok / mono_wall:.2f}); mean TTFT at the router "
             f"{ttft * 1e3:.2f} ms; {sp['handoffs']} handoffs, "
             f"{sp['handoff_blocks']} blocks = "
             f"{sp['handoff_bytes'] / 2 ** 20:.1f} MiB, gather "
             f"{secs['gather'] * 1e3:.1f} ms + transfer "
             f"{secs['transfer'] * 1e3:.1f} ms + scatter "
             f"{secs['scatter'] * 1e3:.1f} ms (each between device syncs); "
             f"every parcel's prompt rows byte-equal to the monolithic "
             f"engine's arena rows; tokens equal the monolithic run's; "
             f"zero prefills on the decode replica; launches {launches}")
        del rt, pre, dec


class _FrameLog:
    """A ``SocketTransport._exchange`` wrapper keeping every frame."""

    def __init__(self, transport):
        self.frames = []
        self._ex = transport._exchange
        transport._exchange = self

    def __call__(self, buf):
        out = self._ex(buf)
        self.frames.append((buf, out))
        return out


def _frame_keys(frames):
    """Each frame decoded, the welcome's process-local registry key
    dropped: (kind, seq, canonical payload, plane bytes)."""
    from paddle_tpu_torch.inference.transport import decode_frame
    out = []
    for pair in frames:
        for buf in pair:
            kind, seq, obj, planes, _n = decode_frame(buf)
            if kind == "welcome":
                obj = {k: v for k, v in obj.items() if k != "registry_key"}
            out.append((kind, seq, json.dumps(obj, sort_keys=True),
                        [p.tobytes() for p in planes]))
    return out


def _fleet_socket_run(torch, proc, local, trace, total, nl):
    """One socket run of (e): ``Router([child, local])`` round-robin, the
    child's fault schedule armed; returns outputs, stats, frames, wall,
    TTFT."""
    from paddle_tpu_torch.inference import Router
    from paddle_tpu_torch.inference.transport import (RemoteReplica,
                                                      SocketTransport)
    from paddle_tpu_torch.observability import MetricsRegistry
    transport = SocketTransport(proc, registry=MetricsRegistry(),
                                connect_timeout_s=300.0, rpc_timeout_s=300.0)
    frames = _FrameLog(transport)
    rep = RemoteReplica(transport)
    # the dead child stays out of the routing set (no probe), so the run
    # never waits on the respawned generation
    rt = Router([rep, local], affinity=False, probe_interval=10 ** 6,
                registry=MetricsRegistry())
    try:
        _zero_launches()
        hs = [rt.submit(ids, max_new_tokens=m, arrival_time=0.0)
              for ids, m in trace]
        wall, ttft = _drive(torch, rt, hs, now=0.0)
        _fleet_take(torch, "fleet (e) socket", total, nl, [local.stats()])
        st = rt.stats()
        return ([h.output.tolist() for h in hs], st,
                _frame_keys(frames.frames), wall, ttft, rep)
    finally:
        transport.close()


def _fleet_socket(torch, seed, procs, total):
    """(e): one ``EngineProcess`` child on the card per run behind a
    ``SocketTransport``; its requests fail over onto an in-process
    replica of the same depth."""
    import numpy as np
    from paddle_tpu_torch.inference import Router
    from paddle_tpu_torch.observability import MetricsRegistry
    nl = FLEET_CHILD_LAYERS
    # the unfaulted reference: two in-process replicas from the factory
    ref_a = fleet_child_engine(seed=seed)
    vocab = ref_a._model.config.vocab_size
    rng = np.random.default_rng(seed + 29)
    trace = [(rng.integers(0, vocab, n).astype(np.int32), m)
             for n, m in FLEET_SOCKET_TRACE]
    n_tok = sum(m for _, m in trace)
    ref_b = type(ref_a)(ref_a._model, compute_dtype="bfloat16",
                        clock=_zero_clock, registry=MetricsRegistry(),
                        **FLEET_CHILD)
    rt = Router([ref_a, ref_b], affinity=False, registry=MetricsRegistry())
    _zero_launches()
    hs = [rt.submit(ids, max_new_tokens=m, arrival_time=0.0)
          for ids, m in trace]
    _drive(torch, rt, hs, now=0.0)
    _fleet_take(torch, "fleet (e) reference", total, nl,
                [ref_a.stats(), ref_b.stats()])
    want = [h.output.tolist() for h in hs]
    del rt, ref_b
    runs = []
    for proc in procs:
        local = type(ref_a)(ref_a._model, compute_dtype="bfloat16",
                            clock=_zero_clock, registry=MetricsRegistry(),
                            **FLEET_CHILD)
        try:
            runs.append(_fleet_socket_run(torch, proc, local, trace, total,
                                          nl))
        finally:
            proc.kill()
        del local
    for outs, st, frames, wall, ttft, rep in runs:
        if outs != want:
            raise AssertionError("socket replica: tokens differ from the "
                                 "unfaulted run's")
        if not (st["replica_faults"] == 1 and st["migrated_blocks"] > 0
                and st["failed"] == 0 and st["health"][0] == "unhealthy"):
            raise AssertionError(f"socket replica: {st}")
    if runs[0][2] != runs[1][2]:
        diff = [i for i, (x, y) in enumerate(zip(runs[0][2], runs[1][2]))
                if x != y]
        raise AssertionError(f"socket replica: the two runs' frame "
                             f"sequences differ ({len(runs[0][2])} and "
                             f"{len(runs[1][2])} frames, first differing "
                             f"{diff[:3]})")
    outs, st, frames, wall, ttft, rep = runs[0]
    kinds = {}
    for kind, *_ in frames:
        kinds[kind] = kinds.get(kind, 0) + 1
    tstats = {k: v for k, v in rep.transport_stats().items()
              if k != "frames"}
    _log(f"fleet (e) socket replica: an EngineProcess child "
         f"({FLEET_CHILD_LAYERS} layers at Llama-3-8B width, bf16) behind "
         f"SocketTransport beside an in-process replica of the same depth; "
         f"the child swapped its request 0 to the proxy at step "
         f"{FLEET_FAULT['force_swap_step']} and exited at step "
         f"{FLEET_FAULT['exit_at_step']}; migrated {st['migrated_blocks']} "
         f"staged blocks, recovered {st['failover_requests']} requests; "
         f"{len(trace)} requests, {n_tok} tokens in {wall:.3f} s = "
         f"{n_tok / wall:.2f} tokens/s; mean TTFT at the router "
         f"{ttft * 1e3:.2f} ms; tokens equal the unfaulted in-process "
         f"run's; two runs moved identical frame sequences "
         f"({len(frames)} frames, by kind {kinds}); proxy transport "
         f"{tstats}")
    del ref_a


def phase_fleet(torch, seed, cfg, model, serve_tokens=None):
    """Phase 3i: the fleet layer at full Llama-3-8B width (phase 3's
    model).  (a) streaming: phase 3's trace with every request submitted
    ``stream=True`` through a depth-1 engine; every stream's flushes
    concatenate to the unstreamed run's outputs (and phase 3's), each
    flush lands on a step with a harvest point, no stream flushes more
    often than there are harvest points, and the forced syncs are the
    unstreamed run's.  (b) ``Router([e0, e1], affinity=True)`` over two
    engines sharing ``model``, shared-prefix traffic in two waves: a
    prefix-affinity routing, each request's tokens equal to it served
    alone on a fresh 1-slot engine, and a 1-replica router's flight
    record equal to the bare engine's.  (c) the same trace with e1
    killed by the ``FaultInjector`` while it holds one swapped and at
    least one in-flight request: tokens equal (b)'s, the migrated bytes
    the parcel's bytes.  (d) a prefill-role and a decode-role engine, bf16
    then int8 KV: every handoff parcel's prompt rows byte-equal to the
    monolithic engine's arena rows, tokens equal the monolithic run's.
    (e) an ``EngineProcess`` child on the card (``fleet_child_engine``)
    behind ``SocketTransport``, killed by its ``exit_at_step`` schedule
    after a force-swap: tokens equal an unfaulted in-process run's, and
    two runs move identical frames; the children are killed in a
    ``finally``.  Every arm holds the fleet launch formula and logs
    tokens/s and TTFT.  Returns the launch counts of all arms."""
    from paddle_tpu_torch.inference.procserve import (EngineProcess,
                                                      TCPStoreLite)
    total = {}
    stores, procs = [], []
    t0 = time.perf_counter()
    try:
        # the children start now and build their models while (a)-(d)
        # run; each run of (e) takes one, under the same label (each
        # with its own rendezvous store), so their frames can be equal
        kw = {"seed": seed, "fault_spec": FLEET_FAULT}
        for _ in range(2):
            stores.append(TCPStoreLite.serve())
            procs.append(EngineProcess("fleet", FLEET_FACTORY, kw,
                                       stores[-1][0]))
        _fleet_streaming(torch, seed, cfg, model, total, serve_tokens)
        _fleet_router(torch, seed, cfg, model, total)
        _fleet_disagg(torch, seed, cfg, model, total)
        _fleet_socket(torch, seed, procs, total)
    finally:
        for p in procs:
            p.kill()
        for _addr, close in stores:
            close()
        torch.cuda.empty_cache()
    for name in ("paged_decode_attention", "paged_decode_attention_int8",
                 "rms_norm"):
        if not total.get(name):
            raise AssertionError(f"fleet: {name} never launched: {total}")
    _log(f"fleet: phase 3i took {time.perf_counter() - t0:.1f} s; launches "
         f"{total}")
    return total


# phase 4h: a K-th / (K+1)-th candidate score gap (log-probability) at
# or below this, at any step of a row's CPU beam run (or a best-vs-second
# gap at the pick), leaves that row undecided between card and CPU
BEAM_MARGIN = 1e-3


# ---- phase 3j: LoRA serving and fair share at 8B width ----

# three adapters over two arena slots (at least one demotion and swap-in)
LORA_ADAPTERS = (("chat_a", 8), ("chat_b", 16), ("batch_c", 16))
# N(0, LORA_SCALE) A and B: at 8B width a rank-r delta moves a projection's
# output by about 64 sqrt(r) LORA_SCALE^2 of the base output's scale
# (0.29 at r = 8, 0.41 at r = 16): tokens change, logits stay finite
LORA_SCALE = 0.04
# phase 3's 8 requests in submission order, (adapter, tenant): the 8th
# shares the first's 256-token prefix, so both stay on the base model
# (the prefix cache keys blocks by tokens alone, in the JAX package too)
LORA_ASSIGN = ((None, "chat"), ("chat_a", "chat"), ("chat_a", "chat"),
               ("chat_b", "chat"), ("chat_b", "chat"),
               ("batch_c", "batch"), ("batch_c", "batch"), (None, "chat"))
LORA_WEIGHTS = {"chat": 2.0, "batch": 1.0}
# the decode profile's 8 slots: two adapters and base rows
LORA_PROFILE = ("chat_a", "chat_b", None, "chat_a", "chat_b", None,
                "chat_a", "chat_b")
# the composed engine's spec row rides a weak fourth adapter (name, rank,
# scale: a delta about 0.02 of the base output's scale), so the base
# model's drafts are often accepted
LORA_SPEC_ADAPTER = ("spec_d", 8, 0.01)
# a bf16 position is decisive when its top-2 margin is above 0.01 and
# above twice the measured logit gap between the two paths compared, or,
# where no gap is measured, above BF16_ULPS ulps of the top logit
BF16_ULPS = 4


def _lora_store(torch, model, seed, registry=None, device=None):
    """Phase 3j's ``AdapterStore(slots=2, max_rank=16)`` at the model's
    dtype with the three adapters of ``LORA_ADAPTERS`` registered."""
    from paddle_tpu_torch.device import dtype_name
    from paddle_tpu_torch.inference import AdapterStore, LoraAdapter
    dt = dtype_name(next(model.parameters()).dtype)
    store = AdapterStore(model, slots=2, max_rank=16, dtype=dt,
                         registry=registry, device=device)
    ads = {}
    for i, (name, rank) in enumerate(LORA_ADAPTERS):
        ads[name] = LoraAdapter.random(model.config, name, rank=rank,
                                       seed=seed + 100 + i, scale=LORA_SCALE)
        store.register(ads[name])
    return store, ads


def _adapter_swap_watch(torch, store, log):
    """Time every adapter swap-in of ``store`` (its in-place uploads from
    pinned memory) between two device syncs into ``log`` as (name, bytes,
    s).  The wrapper holds the store weakly."""
    import weakref
    me, cls = weakref.ref(store), type(store)

    def timed_upload(a, slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cls._upload(me(), a, slot)
        torch.cuda.synchronize()
        log.append((a.name, a.nbytes, time.perf_counter() - t0))
    store._upload = timed_upload


def _lora_dispatch_watch(eng, log):
    """Record, for every dispatch of ``eng``, whether a riding row carried
    an adapter (read from the rows ``_build_lora`` is given)."""
    import weakref
    me, cls = weakref.ref(eng), type(eng)

    def watched(reqs):
        log.append(any(r is not None and r.adapter is not None
                       for r in reqs))
        return cls._build_lora(me(), reqs)
    eng._build_lora = watched


def _decisive(torch, lg, gap=None, tol=0.01):
    """Per position of teacher-forced logits ``lg`` [T, V]: the top-2
    margin is above ``tol`` and above twice ``gap`` [T], the largest
    logit difference measured there between the two paths compared (no
    perturbation that small can move the argmax); without a measured
    gap, above ``BF16_ULPS`` bf16 ulps of the top logit."""
    import numpy as np
    top2 = lg.topk(2, dim=-1).values.numpy()
    margin = top2[:, 0] - top2[:, 1]
    if gap is not None:
        return margin > np.maximum(tol, 2 * gap)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(top2[:, 0]), 1e-30)))
                  - 7)
    return margin > np.maximum(tol, BF16_ULPS * ulp)


def _hold_upto(tag, got, want, decisive):
    """``got`` equals ``want`` up to the first non-decisive position;
    returns how many positions were compared."""
    import numpy as np
    bad = np.flatnonzero(~decisive)
    upto = int(bad[0]) if bad.size else len(want)
    if not np.array_equal(np.asarray(got)[:upto], np.asarray(want)[:upto]):
        raise AssertionError(f"{tag}: tokens {list(got)} != {list(want)} "
                             f"before the first non-decisive position "
                             f"{upto}")
    return upto


def _row_planes(torch, store, name):
    """One row's adapter planes: ``name`` acquired (pinned) in ``store``;
    release it after use."""
    slot = store.acquire(name)
    return dict(store.arena_planes(), ids=torch.tensor(
        [slot], dtype=torch.int32, device=store.device))


def _lora_delta_groups(lora, base):
    """The LoRA decode step's device time beyond the base step's, ms per
    step by kernel group (gathers: the index_select kernels; elementwise:
    the adds; the rest: the batched products): each kernel name's us per
    step in the LoRA window less the base window's, where positive."""
    out = {"gather": 0.0, "gemm": 0.0, "elementwise": 0.0}
    for name, us in lora["per_kernel"].items():
        d = us / lora["steps"] - base["per_kernel"].get(name, 0.0) \
            / base["steps"]
        if d <= 0:
            continue
        low = name.lower()
        g = ("gather" if "index" in low else
             "elementwise" if "elementwise" in low else "gemm")
        out[g] += d / 1e3
    return out


def _lora_cpu_admissions(torch, seed, cfg):
    """Phase 3j's trace, tenants and adapters on the CPU through a 1-layer
    float32 model of the same vocabulary and the card engine's geometry
    (scheduling does not read the tokens: no EOS): the admission order
    the deficit-weighted round-robin gives."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import FlightRecorder, MetricsRegistry
    tiny = LlamaConfig(vocab_size=cfg.vocab_size, hidden_size=64,
                       intermediate_size=128, num_hidden_layers=1,
                       num_attention_heads=4, num_key_value_heads=2)
    model = LlamaForCausalLM(tiny, device="cpu", seed=seed)
    reg, fr = MetricsRegistry(), FlightRecorder()
    store, _ads = _lora_store(torch, model, seed, reg, device="cpu")
    eng = ServingEngine(model, adapter_store=store,
                        tenant_weights=LORA_WEIGHTS, registry=reg,
                        flight_recorder=fr, device="cpu",
                        **dict(FLEET, compute_dtype="float32"))
    _l, st, _w, _n, _t, _r, _reqs = _serve_trace(
        torch, eng, tiny, seed,
        assign=[dict(adapter=a, tenant=t) for a, t in LORA_ASSIGN])
    return ([e.request for e in fr.events() if e.kind == "admit"],
            st["fair_reorders"], st["tenant_served_tokens"])


def _forward_logits(torch, model, prompt, out, lora=None):
    """Teacher-forced logits of one causal forward of ``model`` over
    ``prompt`` then ``out[:-1]`` (with ``lora`` planes of one row, its
    adapter's gathered delta): the [len(out), vocab] float32 rows that
    predict ``out``, on the CPU."""
    import numpy as np
    from paddle_tpu_torch.models.lora import gather_lora, lora_context
    dev = next(model.parameters()).device
    ids = np.concatenate([prompt, np.asarray(out[:-1], np.int32)])
    with torch.no_grad(), lora_context(
            None if lora is None else gather_lora(lora)):
        lg = model(torch.from_numpy(ids[None]).to(dev))[0]
    return lg[len(prompt) - 1:].float().cpu()


def _lora_oracles(torch, model, ads, reqs, store):
    """Check (b): each adapter row of ``reqs`` against a fresh 1-slot
    engine without a store that runs the request alone over
    ``merged_adapter`` weights, up to the first non-decisive position
    (``_decisive`` of the merged model's teacher-forced logits along the
    oracle's tokens, one causal forward each, the gap being the logit gap
    to the gathered path through ``store`` there).  Returns (compared,
    total, largest gap)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.lora import merged_adapter
    from paddle_tpu_torch.observability import MetricsRegistry
    compared = total = 0
    worst = 0.0
    for name, ad in ads.items():
        rows = [r for r, (a, _t) in zip(reqs, LORA_ASSIGN) if a == name]
        with merged_adapter(model, ad):
            one = ServingEngine(model, registry=MetricsRegistry(),
                                **dict(FLEET, num_slots=1))
            alone = []
            for r in rows:
                o = one.submit(r.prompt[:r.seq_len],
                               max_new_tokens=r.max_new_tokens)
                one.run()
                alone.append(o.output)
            del one
            merged = [_forward_logits(torch, model, r.prompt[:r.seq_len], o)
                      for r, o in zip(rows, alone)]
        planes = _row_planes(torch, store, name)
        try:
            for r, o, lg in zip(rows, alone, merged):
                lg_g = _forward_logits(torch, model, r.prompt[:r.seq_len],
                                       o, lora=planes)
                gap = (lg - lg_g).abs().amax(dim=-1).numpy()
                worst = max(worst, float(gap.max()))
                compared += _hold_upto(
                    f"lora (b) request {r.request_id} ({name})", r.output, o,
                    _decisive(torch, lg, gap))
                total += len(o)
        finally:
            store.release(name)
    return compared, total, worst


def _lora_composed(torch, seed, cfg, model, ads_seed):
    """The composed engine of phase 3j: int8 KV, int8 weights,
    ``async_depth=2``, a ``ModelDrafter`` over the (base) target; a greedy
    spec row on ``LORA_SPEC_ADAPTER`` (a weak adapter, so the base
    drafter's drafts are often accepted) and a sampled row on
    ``batch_c``.  Every request finishes with the spec launch formula and
    acceptance above 0; the greedy spec row equals the same engine's
    non-spec run of it up to the first non-decisive position, the gap
    measured between the engine's decode and verify paths teacher-forced
    along the non-spec tokens (int8 planes, the row's adapter).  Returns
    the launches."""
    import numpy as np
    from paddle_tpu_torch.inference import (LoraAdapter, ModelDrafter,
                                            ServingEngine)
    from paddle_tpu_torch.inference.sampling import SamplingParams
    from paddle_tpu_torch.ops import KERNELS
    nl = cfg.num_hidden_layers
    torch.cuda.empty_cache()
    store, _ads = _lora_store(torch, model, ads_seed)
    spec_name, rank, scale = LORA_SPEC_ADAPTER
    store.register(LoraAdapter.random(cfg, spec_name, rank=rank,
                                      seed=ads_seed + 110, scale=scale))
    eng = ServingEngine(model, adapter_store=store, kv_cache_dtype="int8",
                        weight_dtype="int8", async_depth=2,
                        tenant_weights=LORA_WEIGHTS,
                        drafter=ModelDrafter(model, max_context=SPEC[
                            "max_context"], max_draft=SPEC["k"],
                            compute_dtype="bfloat16"), **FLEET)
    rng = np.random.default_rng(seed + 31)
    p_spec = rng.integers(0, cfg.vocab_size, 200).astype(np.int32)
    p_samp = rng.integers(0, cfg.vocab_size, 150).astype(np.int32)
    _zero_launches()
    t0 = time.perf_counter()
    r_spec = eng.submit(p_spec, max_new_tokens=24, spec_decode=SPEC["k"],
                        adapter=spec_name, tenant="chat")
    r_samp = eng.submit(p_samp, max_new_tokens=24, adapter="batch_c",
                        tenant="batch", sampling=SamplingParams(
                            temperature=0.8, top_k=50, top_p=0.9,
                            seed=seed + 7))
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    launches = {name: k.launches for name, k in KERNELS.items()}
    _check_launches(launches, _spec_launches(nl, st, nl, quant=True), st)
    _finished_in_vocab([r_spec, r_samp], [24, 24], cfg.vocab_size,
                       "lora composed")
    if not (st["spec_accepted_tokens"] > 0 and st["lora_dispatches"]):
        raise AssertionError(f"lora composed: no accepted draft or no "
                             f"adapter dispatch: {st}")
    r_plain = eng.submit(p_spec, max_new_tokens=24, adapter=spec_name,
                         tenant="chat")
    eng.run()
    planes = _row_planes(torch, store, spec_name)
    try:
        lg = _teacher_forced(torch, model, eng._wq_ctx, p_spec,
                             r_plain.output[:-1], store.device,
                             kv_dtype=torch.int8, lora=planes)
        lg_v = _teacher_forced(torch, model, eng._wq_ctx, p_spec,
                               r_plain.output[:-1], store.device,
                               kv_dtype=torch.int8, lora=planes,
                               verify_width=SPEC["k"] + 1)
    finally:
        store.release(spec_name)
    gap = (lg - lg_v).abs().amax(dim=-1).numpy()
    upto = _hold_upto("lora composed: spec row vs its non-spec run",
                      r_spec.output, r_plain.output,
                      _decisive(torch, lg, gap))
    store.check()
    _log(f"lora composed (int8 KV + int8 weights, async_depth=2, spec "
         f"{SPEC['k']} with a ModelDrafter over the target): 2 adapter rows "
         f"(greedy spec on {spec_name}, sampled) finished in {wall:.3f} s; "
         f"acceptance "
         f"{st['spec_acceptance_rate']:.3f} over "
         f"{st['spec_verify_steps']} verifies; lora dispatches "
         f"{st['lora_dispatches']}; the spec row equals its non-spec run "
         f"over {upto} of {len(r_plain.output)} positions (decisive; "
         f"largest decode-vs-verify logit gap {gap.max():.4f}); "
         f"launches {launches}")
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_lora(torch, seed, cfg, model, serve_tokens):
    """Phase 3j: multi-tenant LoRA serving and fair share at full
    Llama-3-8B width, on phase 3's model, geometry and trace.  An
    ``AdapterStore(slots=2, max_rank=16)`` holds three adapters
    (``LORA_ADAPTERS``, ranks 8, 16, 16 over the four attention
    projections, ``LORA_SCALE``); phase 3's 8 requests ride them as
    ``LORA_ASSIGN`` says, in two tenants weighted ``LORA_WEIGHTS``.  The
    LoRA engine and phase 3's depth-1 engine run in turns (LoRA, base,
    base, LoRA).  Checks: (a) base rows equal phase 3's tokens (and the
    base arm all of them); (b) each adapter row equals a fresh 1-slot
    engine over merged weights up to the first non-decisive position;
    (c) phase 3's launch formula (the delta launches no port kernel);
    (d) ``serving.lora.gathers`` equals the dispatches that carried an
    adapter row; (e) after the drain the store audit is clean and every
    resident slot's rows are byte-equal to its registration parcel, after
    at least one demotion and swap-in; (f) the admission order equals the
    CPU replay's (``_lora_cpu_admissions``).  Each run logs tokens/s,
    TTFT, peak memory and each swap-in's ms and GB/s; each arm's first
    run a decode window (wall against busy, idle share) and the LoRA run
    the delta's device ms per step by group and the lora-on graph's
    capture ms.  Then the composed engine (``_lora_composed``).  Returns
    the launch counts of the LoRA runs and the composed engine."""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.lora import LORA_TARGETS
    from paddle_tpu_torch.observability import FlightRecorder, MetricsRegistry
    nl = cfg.num_hidden_layers
    assign = [dict(adapter=a, tenant=t) for a, t in LORA_ASSIGN]
    t_phase = time.perf_counter()
    cpu_order, cpu_reorders, cpu_served = _lora_cpu_admissions(torch, seed,
                                                               cfg)
    _log(f"lora (f): the CPU replay admits {cpu_order} in "
         f"{time.perf_counter() - t_phase:.1f} s")
    total, profs, checked = {}, {}, False
    for turn, arm in enumerate(("lora", "base", "base", "lora")):
        # earlier phases' engines may still wait for the cyclic collector:
        # the peak of each run is its own
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        swaps, rides = [], []
        if arm == "lora":
            reg, fr = MetricsRegistry(), FlightRecorder()
            store, ads = _lora_store(torch, model, seed, reg)
            _adapter_swap_watch(torch, store, swaps)
            eng = ServingEngine(model, adapter_store=store,
                                tenant_weights=LORA_WEIGHTS, registry=reg,
                                flight_recorder=fr, **FLEET)
            _lora_dispatch_watch(eng, rides)
        else:
            eng = ServingEngine(model, **FLEET)
        launches, st, wall, n_req, n_tok, rng, reqs = _serve_trace(
            torch, eng, cfg, seed, assign=assign if arm == "lora" else None)
        peak = torch.cuda.max_memory_allocated()
        _check_launches(launches, _serving_launches(nl, st, False), st)
        outs = [r.output.tolist() for r in reqs]
        extra = ""
        if arm == "base":
            if outs != serve_tokens:
                raise AssertionError("lora: the base arm's tokens differ "
                                     "from phase 3's")
        else:
            _add_launches(total, launches)
            # (a) base rows
            base_rows = [i for i, (a, _t) in enumerate(LORA_ASSIGN)
                         if a is None]
            for i in base_rows:
                if outs[i] != serve_tokens[i]:
                    r = reqs[i]
                    lg = _teacher_forced(
                        torch, model, None, r.prompt[:r.seq_len],
                        np.asarray(serve_tokens[i][:-1]), store.device,
                        kv_dtype=torch.bfloat16)
                    n = _hold_upto(f"lora (a) request {i}", outs[i],
                                   serve_tokens[i], _decisive(torch, lg))
                    _log(f"lora (a): base request {i} equals phase 3 over "
                         f"{n} of {len(outs[i])} positions (decisive)")
            changed = sum(outs[i] != serve_tokens[i]
                          for i in range(len(outs)) if i not in base_rows)
            if not changed:
                raise AssertionError("lora: no adapter changed a token")
            # (d) gathers against the dispatches that carried an adapter
            gathers = reg.get("serving.lora.gathers").value()
            if not gathers == sum(rides) == st["lora_dispatches"] > 0:
                raise AssertionError(
                    f"lora (d): gathers {gathers} != adapter dispatches "
                    f"{sum(rides)} of {len(rides)} (stats "
                    f"{st['lora_dispatches']})")
            # (e) the store after the drain
            store.check()
            if len(swaps) < len(LORA_ADAPTERS):
                raise AssertionError(f"lora (e): {len(swaps)} swap-ins, "
                                     f"no demotion")
            for name in store.hbm_resident():
                a = store.state(name)
                for t in LORA_TARGETS:
                    got = store.arena_row(t, a.slot)
                    if any(g.tobytes() != w.tobytes()
                           for g, w in zip(got, a.rows[t])):
                        raise AssertionError(
                            f"lora (e): adapter {name}'s slot {a.slot} "
                            f"rows of {t} differ from its parcel")
            # (f) admission order
            order = [e.request for e in fr.events() if e.kind == "admit"]
            if (order, st["fair_reorders"], st["tenant_served_tokens"]) != \
                    (cpu_order, cpu_reorders, cpu_served):
                raise AssertionError(
                    f"lora (f): admissions {order} (reorders "
                    f"{st['fair_reorders']}) != the CPU's {cpu_order} "
                    f"({cpu_reorders})")
            cap = [round(p.prog.capture_s * 1e3, 1)
                   for k, p in eng._blocks.items() if k[2]
                   and hasattr(p, "prog")]
            swap_txt = "; ".join(
                f"{n} {b / 2 ** 20:.1f} MiB {s_ * 1e3:.3f} ms = "
                f"{b / s_ / 1e9:.2f} GB/s" for n, b, s_ in swaps)
            extra = (f"lora dispatches {st['lora_dispatches']} of "
                     f"{len(rides)}; admissions {order} (reorders "
                     f"{st['fair_reorders']}, served "
                     f"{st['tenant_served_tokens']}); lora-on graph "
                     f"capture {cap} ms; swap-ins {swap_txt}; ")
            if not checked:
                t_b = time.perf_counter()
                comp, tot, worst = _lora_oracles(torch, model, ads, reqs,
                                                 store)
                _log(f"lora (b): adapter rows equal their merged-weights "
                     f"1-slot runs over {comp} of {tot} positions "
                     f"(decisive; largest merged-vs-gathered logit gap "
                     f"{worst:.4f}) in {time.perf_counter() - t_b:.1f} s")
                checked = True
        _log_serving(f"lora [{arm}, turn {turn + 1}]", n_req, n_tok, wall,
                     st, launches, extra + f"peak memory "
                     f"{peak / 2 ** 30:.2f} GiB; ")
        if arm not in profs:
            profs[arm] = _profile_decode(
                torch, eng, rng, cfg.vocab_size,
                adapters=list(LORA_PROFILE) if arm == "lora" else None)
        del eng
    if profs["lora"] is not None and profs["base"] is not None:
        groups = _lora_delta_groups(profs["lora"], profs["base"])
        _log(f"lora: decode step {profs['lora']['wall_ms']:.3f} ms (busy "
             f"{profs['lora']['busy_ms']:.3f}, idle "
             f"{100 * profs['lora']['idle']:.1f}%) against the base "
             f"{profs['base']['wall_ms']:.3f} ms (busy "
             f"{profs['base']['busy_ms']:.3f}, idle "
             f"{100 * profs['base']['idle']:.1f}%); the delta's device ms "
             f"per step by group: " + ", ".join(
                 f"{k} {v:.3f}" for k, v in groups.items())
             + f" = {sum(groups.values()):.3f}")
    torch.cuda.empty_cache()
    t_c = time.perf_counter()
    _add_launches(total, _lora_composed(torch, seed, cfg, model, seed))
    _log(f"lora: the composed engine took {time.perf_counter() - t_c:.1f} s, "
         f"phase 3j {time.perf_counter() - t_phase:.1f} s")
    return total


# ---- phase 4j: LoRA exactness, card against CPU ----

# the CPU test's LoRA fixture (tests/test_torch_lora.py): (prompt seed,
# length, new tokens, adapter, spec_decode)
LORA_EXACT = ((10, 4, 6, "a", None), (11, 5, 6, "b", None),
              (12, 4, 6, None, None), (13, 3, 5, "c", None),
              (14, 4, 5, "a", None), (15, 6, 6, "b", 2))
# the fixture's 0.2 at width 64, scaled to width 4096 (0.2 / 8)
LORA_EXACT_SCALE = 0.025


def _lora_exact_run(torch, cfg, model, device):
    import numpy as np
    from paddle_tpu_torch.inference import (AdapterStore, LoraAdapter,
                                            ServingEngine)
    from paddle_tpu_torch.models.lora import LORA_TARGETS
    from paddle_tpu_torch.observability import MetricsRegistry
    reg = MetricsRegistry()
    store = AdapterStore(model, slots=2, max_rank=4, dtype="float32",
                         registry=reg, device=device)
    ads = {n: LoraAdapter.random(cfg, n, rank=3, seed=s,
                                 scale=LORA_EXACT_SCALE)
           for n, s in (("a", 7), ("b", 8), ("c", 9))}
    for ad in ads.values():
        store.register(ad)
    eng = ServingEngine(model, num_slots=2, prompt_len=6, max_cache_len=32,
                        steps_per_call=3, compute_dtype="float32",
                        adapter_store=store, registry=reg, device=device)
    reqs = []
    for ps, n, m, a, k in LORA_EXACT:
        ids = np.random.default_rng(ps).integers(
            0, cfg.vocab_size, n).astype(np.int32)
        reqs.append((ids, eng.submit(ids, max_new_tokens=m, adapter=a,
                                     spec_decode=k,
                                     tenant=None if a is None
                                     else f"tenant_{a}")))
    eng.run()
    store.check()
    st = eng.stats()
    keys = ("tenant_served_tokens", "fair_reorders", "lora_dispatches",
            "adapters_resident", "finished", "spec_verify_steps")
    rows = {(t, s): tuple(x.tobytes() for x in store.arena_row(t, s))
            for t in LORA_TARGETS for s in range(store.slots + 1)}
    return ([(ids, r.output) for ids, r in reqs], {k: st[k] for k in keys},
            rows, reg.get("serving.lora.swap_ins").value(), ads)


def phase_lora_exactness(torch, seed):
    """Phase 4j: a 1-layer float32 model at 8B width, TF32 off,
    serves the CPU test's LoRA fixture (``LORA_EXACT``: two concurrent
    adapters, a base row in the same dispatches, a demotion and swap-in,
    slot reuse with a changed adapter, a spec row) on the card and, from
    the same state dict, on the CPU: tokens equal up to each row's first
    position whose CPU teacher-forced top-2 margin (its adapter merged)
    is <= 0.01, and the ``stats()`` LoRA and tenant keys, the swap-ins and
    every arena row equal.  Returns the card run's launches."""
    from contextlib import nullcontext

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.lora import merged_adapter
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, gpu = _build_8b(torch, EXACT_CPU_LAYERS, "float32", seed + 1)
    cpu = LlamaForCausalLM(cfg, device="cpu", init=False)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    _zero_launches()
    t0 = time.perf_counter()
    card = _lora_exact_run(torch, cfg, gpu, None)
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    _launched("lora exactness", ("rms_norm", "paged_decode_attention"))
    launches = _launch_counts()
    t0 = time.perf_counter()
    host = _lora_exact_run(torch, cfg, cpu, "cpu")
    cwall = time.perf_counter() - t0
    compared = total = 0
    for (ids, got), (_ids, want), (_ps, _n, _m, a, _k) in zip(
            card[0], host[0], LORA_EXACT):
        with merged_adapter(cpu, host[4][a]) if a else nullcontext():
            lg = _teacher_forced(torch, cpu, None, ids, want[:-1], "cpu",
                                 kv_dtype=torch.float32)
        top2 = lg.topk(2, dim=-1).values.numpy()
        compared += _hold_upto(f"lora exactness ({a})", got, want,
                               top2[:, 0] - top2[:, 1] > 0.01)
        total += len(want)
    if card[1:4] != host[1:4]:
        raise AssertionError(f"lora exactness: card {card[1]} (swap-ins "
                             f"{card[3]}) != CPU {host[1]} ({host[3]}), or "
                             f"the arena rows differ")
    _log(f"lora exactness: the CPU test's LoRA trace on the card "
         f"({gwall:.2f} s) and the CPU ({cwall:.2f} s), "
         f"{cfg.num_hidden_layers} layers float32 "
         f"at 8B width: tokens equal over {compared} of {total} positions "
         f"(decisive), stats {card[1]}, {card[3]:.0f} swap-ins and every "
         f"arena row equal; launches {launches}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


def _beam_gaps(torch, run):
    """Run ``run()`` (a CPU beam ``generate()``) recording, per batch row,
    the smallest gap between the K-th and (K+1)-th candidate scores of
    every top-K (the prefill's expansion and each step) and between the
    best and second beam at the pick.  Returns (tokens, gaps [B])."""
    from paddle_tpu_torch.models import generation as gen
    top_k, pick = gen.top_k_desc, gen.beam_pick
    gaps = []

    def top_rec(x, k):
        vals = torch.sort(x, dim=-1, descending=True, stable=True).values
        gaps.append((vals[..., k - 1] - vals[..., k]).float())
        return top_k(x, k)

    def pick_rec(seqs, lp, blen, penalty):
        score = lp / (blen.float() ** float(penalty)) if penalty else lp
        top2 = torch.sort(score, dim=-1, descending=True).values
        gaps.append(top2[..., 0] - top2[..., 1])
        return pick(seqs, lp, blen, penalty)

    gen.top_k_desc, gen.beam_pick = top_rec, pick_rec
    try:
        out = run()
    finally:
        gen.top_k_desc, gen.beam_pick = top_k, pick
    return out, torch.stack(gaps).min(dim=0).values.numpy()


def phase_dense_exactness(torch, seed):
    """Phase 4h: the 4-layer float32 model of phase 4 (8B width) on the
    card and, from the same state dict, on the CPU.  Greedy
    ``generate()`` (B=2, ragged) and an ``LLMPredictor`` session (B=2, 4
    steps a block): each row's tokens equal up to its first position
    whose CPU teacher-forced top-two margin is <= 0.01 (the PR-16 rule).
    Beam ``generate()`` (K=4, B=8, length penalty 1.0): every row whose
    CPU run keeps each K-th / (K+1)-th candidate gap and its pick's
    best-vs-second gap above ``BEAM_MARGIN`` equal token for token, and
    at least one row such."""
    import numpy as np
    from paddle_tpu_torch.inference.llm import LLMPredictor
    from paddle_tpu_torch.models import LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, gpu = _build_8b(torch, 4, "float32", seed + 1)
    cpu = LlamaForCausalLM(cfg, device="cpu", init=False)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(seed + 21)
    s, m = 40, 10
    ids = rng.integers(0, cfg.vocab_size, (8, s)).astype(np.int32)
    lens = rng.integers(8, s + 1, 8).astype(np.int32)
    lens[0] = s
    kw = dict(max_cache_len=64, compute_dtype="float32")

    def held(tag, g_out, c_out):
        compared = 0
        for r in range(g_out.shape[0]):
            lg = _teacher_forced(torch, cpu, None, ids[r, :lens[r]],
                                 c_out[r, :-1], "cpu",
                                 kv_dtype=torch.float32)
            top2 = lg.topk(2, dim=-1).values
            upto = _upto((top2[:, 0] - top2[:, 1]).numpy())
            if not np.array_equal(g_out[r, :upto], c_out[r, :upto]):
                raise AssertionError(f"dense exactness, {tag}, row {r}: card "
                                     f"{g_out[r]} != CPU {c_out[r]} before "
                                     f"position {upto}")
            compared += upto
        _log(f"dense exactness, {tag}: card tokens equal the CPU's at "
             f"{compared} of {g_out.size} positions (each row up to its "
             f"first CPU margin <= 0.01); whole rows equal "
             f"{[bool(np.array_equal(a, b)) for a, b in zip(g_out, c_out)]}")

    _zero_launches()
    g = gpu.generate(ids[:2], seq_lens=lens[:2], max_new_tokens=m,
                     **kw).cpu().numpy()
    launched = _launched("dense exactness", ("flash_attention_fwd", "rope",
                                             "rms_norm", "decode_attention"))
    c = cpu.generate(ids[:2], seq_lens=lens[:2], max_new_tokens=m,
                     **kw).numpy()
    held(f"greedy generate() B=2, {m} new tokens (launches {launched})",
         g, c)
    preds = [LLMPredictor(net, batch=2, prompt_len=s, max_cache_len=64,
                          steps_per_call=4, compute_dtype="float32")
             for net in (gpu, cpu)]
    g, c = (p.generate(ids[:2], seq_lens=lens[:2], max_new_tokens=m)
            for p in preds)
    held(f"LLMPredictor session B=2, {m} new tokens, 4 steps a block", g, c)
    del preds
    bkw = dict(kw, max_new_tokens=6, num_beams=4, length_penalty=1.0)
    g = gpu.generate(ids, seq_lens=lens, **bkw).cpu().numpy()
    c, gaps = _beam_gaps(torch, lambda: cpu.generate(
        ids, seq_lens=lens, **bkw).numpy())
    decisive = np.flatnonzero(gaps > BEAM_MARGIN)
    if decisive.size == 0:
        raise AssertionError(f"dense exactness, beam: no row decisive (gaps "
                             f"{gaps})")
    for r in decisive:
        if not np.array_equal(g[r], c[r]):
            raise AssertionError(f"dense exactness, beam row {r} (smallest "
                                 f"gap {gaps[r]:.3g}): card {g[r]} != CPU "
                                 f"{c[r]}")
    _log(f"dense exactness, beam K=4 B=8, 6 new tokens, length penalty 1.0: "
         f"{decisive.size} of 8 rows decisive (every gap > {BEAM_MARGIN:g}; "
         f"smallest gaps {np.round(gaps, 5).tolist()}), each equal card vs "
         f"CPU; whole rows equal "
         f"{[bool(np.array_equal(a, b)) for a, b in zip(g, c)]}")
    del gpu, cpu
    torch.cuda.empty_cache()


# ---- the NLP model zoo (GPT and ERNIE/BERT) ----

# phase 2's new geometries: GPT's multi-head attention runs every grouped
# decode kernel at G = 1 (GPT-3 13B: 40 heads of D = 128; GPT-2 small:
# 12 of D = 64); the quantized matmul's bias epilogue at GPT-3 13B's
# projections (qkv, out, fc_in, fc_out); the flash kernels at GPT-2
# small's training shape
GPT_DECODE_GEOMS = ((40, 1, 128), (12, 1, 64))
GPT_QMM_KN = ((5120, 15360), (5120, 5120), (5120, 20480), (20480, 5120))
GPT_FLASH = (1024, 12, 12, 64)          # S, Hq, Hkv, D (GPT-2 small)
# ---- phase 3l: quantization at 8B width, phase 4l: its exactness ----

# phase 3l's sessions: phase 3h's geometry in blocks of 8 steps, 64 new
# tokens a row
QSESSION = dict(batch=8, prompt_len=512, max_cache_len=1024,
                steps_per_call=8)
QSESSION_NEW = 64
QUANT_PER_LAYER = 7                  # q, k, v, o, gate, up, down
# flag off against flag on, teacher-forced along the flag-on tokens: at
# every position the largest logit difference is within this many bf16
# ulps of the position's largest logit (the two routes round each weight
# or each product once in other orders; a wrong dequantize, scales on the
# wrong axis, moves logits by whole units)
QUANT_ROUTE_ULPS = 4
# and at least this share of the 512 positions is decisive (margin above
# 0.01 and twice the gap) for the argmax check to mean something: random
# 8B bf16 logits have close top-2 pairs (254 of 512 were decisive in a
# run on an H100)
QUANT_MIN_DECISIVE = 1 / 3


def _skip_head(name, layer):
    return name == "lm_head"


def _int8_flag(on):
    from paddle_tpu_torch.core.flags import set_flags
    set_flags({"FLAGS_use_int8_matmul_kernel": bool(on)})


def _quant_arm(torch, tag, model, ids, lens, total, per_forward, flag=False,
               **extra):
    """One phase-3l session arm under ``FLAGS_use_int8_matmul_kernel =
    flag``: an 8-row ``LLMPredictor`` (``QSESSION``, bf16) generates
    ``QSESSION_NEW`` tokens a row (its launches into ``total``); then a
    prefill and one block with their quantized-matmul launches asserted
    (``per_forward`` a forward), the least of three unprofiled block
    walls, one profiled block's busy and kernels, and the peak memory of
    the arm.  Returns (tokens, the step's record)."""
    from paddle_tpu_torch.inference.llm import LLMPredictor
    steps = QSESSION["steps_per_call"]
    _int8_flag(flag)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pred = LLMPredictor(model, compute_dtype="bfloat16", **QSESSION,
                            **extra)
        torch.cuda.synchronize()
        cap_ms = (time.perf_counter() - t0) * 1e3
        _zero_launches()
        got = pred.generate(ids, seq_lens=lens, max_new_tokens=QSESSION_NEW)
        torch.cuda.synchronize()
        _add_launches(total, _launch_counts())
        _zero_launches()
        pred.start(ids, seq_lens=lens)
        torch.cuda.synchronize()
        pre = _launch_counts().get("quantized_matmul", 0)
        _zero_launches()
        pred.decode(steps)
        torch.cuda.synchronize()
        blk = _launch_counts().get("quantized_matmul", 0)
        if (pre, blk) != (per_forward, per_forward * steps):
            raise AssertionError(
                f"quantization {tag}: quantized matmul launches {pre} a "
                f"prefill and {blk} a block of {steps} steps, want "
                f"{per_forward} a forward")

        def block():
            pred.start(ids, seq_lens=lens)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.decode(steps)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        wall = min(block() for _ in range(3))
        pred.start(ids, seq_lens=lens)
        busy, per_kernel, count = _profiled(torch,
                                            lambda: pred.decode(steps))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del pred
    finally:
        _int8_flag(False)
    rec = dict(step_ms=wall / steps, tokens_s=ids.shape[0] * steps / wall
               * 1e3, busy_ms=None if busy is None else busy / steps,
               peak_gib=peak, capture_ms=cap_ms,
               ms={k: us / 1e3 / steps for k, us in per_kernel.items()},
               launches={k: n / steps for k, n in count.items()})
    _log(f"quantization {tag}: B={ids.shape[0]}, prompt {ids.shape[1]}, "
         f"{QSESSION_NEW} new tokens; construction (both captures) "
         f"{cap_ms:.1f} ms; block of {steps} steps {wall:.3f} ms "
         f"({rec['step_ms']:.3f} ms a step, {rec['tokens_s']:.1f} "
         f"tokens/s), {_fmt_busy(busy, wall)}; peak memory {peak:.2f} GiB; "
         f"quantized matmul {pre} a prefill, {blk // steps} a decode step")
    return got, rec


# 3l's kernel groups of a decode step, by name, first match wins
QUANT_GROUPS = (("quantized matmul", ("qmm",)),
                ("decode attention", ("decode",)),
                ("cuBLAS GEMMs", ("nvjet", "gemm", "cutlass")),
                ("other port kernels", ("(anonymous namespace)::",)))


def _quant_groups(ms):
    out = {g: 0.0 for g, _ in QUANT_GROUPS}
    out["other PyTorch kernels"] = 0.0
    for name, v in ms.items():
        g = next((g for g, keys in QUANT_GROUPS
                  if any(k in name for k in keys)), "other PyTorch kernels")
        out[g] += v
    return out


def _quant_split(recs, qmodel, per_forward):
    """Where a decode step's device time goes in each 3l arm (ms a step by
    kernel group, from the arm's profiled block), and the flag-off
    route's two costs measured apart: the dequantize, the kernels that
    are not GEMMs and launch at least ``per_forward`` times a step (one
    a projection; no other kernel of the step launches that often),
    their ms and launches beyond the flag-on arm's (which may run a
    kernel of the same name for another op), against the bytes it must
    move (each code read, each bf16 weight written, each scale read),
    and the cuBLAS GEMMs, against the bf16 weights they read."""
    from paddle_tpu_torch.nn.quant import QuantizedLinearInfer
    groups = {tag: _quant_groups(r["ms"]) for tag, r in recs.items()}
    _log("quantization kernel split, ms a step (" + " | ".join(groups)
         + "): " + "; ".join(
             f"{g} " + " | ".join(f"{groups[t][g]:.3f}" for t in groups)
             for g in next(iter(groups.values()))))
    off, on = recs["flag off"], recs["flag on"]
    gemm = QUANT_GROUPS[2][1]
    deq = {k: (off["ms"][k] - on["ms"].get(k, 0.0),
               off["launches"][k] - on["launches"].get(k, 0.0))
           for k in off["ms"] if not any(g in k for g in gemm)
           and off["launches"][k] >= per_forward}
    layers = [m for m in qmodel.modules()
              if isinstance(m, QuantizedLinearInfer)]
    codes = sum(m.qweight.numel() for m in layers)
    deq_bytes = 3 * codes + sum(4 * m.weight_scale.numel() for m in layers)
    deq_ms = sum(v for v, _n in deq.values())
    gemm_ms = groups["flag off"]["cuBLAS GEMMs"]

    def rate(nbytes, ms):
        return (f"{nbytes / ms / 1e9:.3f} TB/s" if ms > 0 else
                "rate not measured (no such kernel in the profile)")
    _log(f"quantization flag off: the dequantize {deq_ms:.3f} ms a step "
         f"over {sum(n for _v, n in deq.values()):.0f} launches "
         f"({deq_bytes / 1e9:.2f} GB a step: {codes / 1e9:.2f} G codes "
         f"read, bf16 written) = {rate(deq_bytes, deq_ms)}; "
         f"cuBLAS GEMMs {gemm_ms:.3f} ms a step over the bf16 weights "
         f"({2 * codes / 1e9:.2f} GB read) = "
         f"{rate(2 * codes, gemm_ms)}, flag on "
         f"{groups['flag on']['cuBLAS GEMMs']:.3f} ms (lm_head); "
         f"the dequantize's kernels: "
         + "; ".join(f"{k[:110]} {v:.3f} ms, {n:.0f} launches beyond "
                     f"flag on's {on['launches'].get(k, 0.0):.0f}"
                     for k, (v, n) in deq.items()))
    for k, v in sorted(off["ms"].items(), key=lambda kv: -kv[1])[:6]:
        _log(f"  flag off {v:8.3f} ms/step {off['launches'][k]:6.0f} "
             f"launches/step  {k[:100]}")


def _tf_rows(torch, model, ids, lens, outs, flag):
    """Teacher-forced logits (``_forward_logits``) of every row of
    ``outs`` under ``FLAGS_use_int8_matmul_kernel = flag``."""
    _int8_flag(flag)
    try:
        return [_forward_logits(torch, model, ids[r, :lens[r]], outs[r])
                for r in range(len(outs))]
    finally:
        _int8_flag(False)


def phase_quantization(torch, seed, cfg, model):
    """Phase 3l: the quantization slice at full Llama-3-8B width, on phase
    3's bf16 model, where it is used for the last time.  (a) the
    reference arm: an ``LLMPredictor(weight_dtype="int8")`` session
    (``QSESSION``) on 8 seeded ragged prompts, 64 new tokens; (b)
    ``weight_only_quantize(model, inplace=True)`` with ``lm_head``
    skipped: 224 ``QuantizedLinearInfer`` layers, the memory it freed;
    (c) the converted model's session with
    ``FLAGS_use_int8_matmul_kernel`` off (dequantize + cuBLAS: 0
    quantized-matmul launches) and on (the kernel: 224 a forward, 7
    projections x 32 layers).  Each arm: tokens/s, the unprofiled block
    wall per step, busy and idle share from a profile, peak memory.
    Holds: the flag-on tokens against the reference arm's (the same
    codes, kernel and M: equal, or the first difference is reported with
    its top-2 margin, and they must agree up to each row's first
    position within ``BF16_ULPS`` bf16 ulps of its top logit); flag off
    against flag on, teacher-forced along the flag-on tokens: the logits
    within ``QUANT_ROUTE_ULPS`` bf16 ulps of each position's largest
    logit, the argmax equal at every decisive position (at least
    ``QUANT_MIN_DECISIVE`` of them), and the sessions' tokens equal up to each row's first
    non-decisive position (``_decisive``, the gap being the two routes'
    logit gap there).  Logs each arm's kernel split and the flag-off
    route's dequantize and GEMMs apart (``_quant_split``).  Returns the
    launch counts of the three sessions' runs."""
    import numpy as np
    from paddle_tpu_torch.nn.quant import QuantizedLinearInfer
    from paddle_tpu_torch.quantization import weight_only_quantize
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 29)
    b, p = QSESSION["batch"], QSESSION["prompt_len"]
    ids = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)
    lens = rng.integers(p // 8, p + 1, b).astype(np.int32)
    lens[0] = p
    per_forward = QUANT_PER_LAYER * cfg.num_hidden_layers
    total = {}
    recs = {}
    ref, recs["int8 plan"] = _quant_arm(
        torch, "(a) weight_dtype='int8' session", model, ids, lens, total,
        per_forward, weight_dtype="int8")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    qmodel = weight_only_quantize(model, inplace=True, skip=_skip_head)
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    n_conv = sum(isinstance(m, QuantizedLinearInfer)
                 for m in qmodel.modules())
    if qmodel is not model or n_conv != per_forward:
        raise AssertionError(f"quantization (b): {n_conv} converted layers, "
                             f"want {per_forward}")
    wbytes = sum(t.numel() * t.element_size() for t in
                 list(qmodel.parameters()) + list(qmodel.buffers()))
    _log(f"quantization (b): weight_only_quantize in place, {n_conv} "
         f"QuantizedLinearInfer layers (lm_head kept bf16) in {conv_s:.2f} "
         f"s; freed {(before - after) / 2 ** 30:.2f} GiB of device memory; "
         f"the converted model's weights {wbytes / 2 ** 30:.2f} GiB")
    off, recs["flag off"] = _quant_arm(
        torch, "(c) converted, flag off (dequantize + cuBLAS)", qmodel, ids,
        lens, total, 0, flag=False)
    on, recs["flag on"] = _quant_arm(
        torch, "(c) converted, flag on (the kernel)", qmodel, ids, lens,
        total, per_forward, flag=True)
    _quant_split(recs, qmodel, per_forward)
    lg_on = _tf_rows(torch, qmodel, ids, lens, on, True)
    same = np.array_equal(on, ref)
    if same:
        first = "equal token for token"
    else:
        r = int(np.flatnonzero((on != ref).any(axis=1))[0])
        pos = int(np.flatnonzero(on[r] != ref[r])[0])
        lg_ref = _tf_rows(torch, qmodel, ids, lens, ref, True)
        top2 = lg_ref[r][pos].topk(2).values
        first = (f"first difference at row {r} position {pos} (top-2 "
                 f"margin there {float(top2[0] - top2[1]):.4g})")
        for r in range(b):
            _hold_upto(f"quantization flag on vs int8 plan, row {r}", on[r],
                       ref[r], _decisive(torch, lg_ref[r]))
    lg_off = _tf_rows(torch, qmodel, ids, lens, on, False)
    compared = agree = 0
    worst = worst_ulps = 0.0
    for r in range(b):
        gap = (lg_on[r] - lg_off[r]).abs().amax(dim=-1).numpy()
        top = lg_on[r].abs().amax(dim=-1).numpy()
        ulps = gap / 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
        worst = max(worst, float(gap.max()))
        worst_ulps = max(worst_ulps, float(ulps.max()))
        if worst_ulps > QUANT_ROUTE_ULPS:
            pos = int(ulps.argmax())
            raise AssertionError(
                f"quantization flag off vs on, row {r}: the teacher-forced "
                f"logits differ by {gap[pos]:.4g} at position {pos}, "
                f"{ulps[pos]:.2f} bf16 ulps of its largest logit "
                f"{top[pos]:.4g} (limit {QUANT_ROUTE_ULPS})")
        dec = _decisive(torch, lg_on[r], gap)
        compared += _hold_upto(f"quantization flag off vs on, row {r}",
                               off[r], on[r], dec)
        a_on, a_off = lg_on[r].argmax(-1).numpy(), lg_off[r].argmax(-1).numpy()
        bad = np.flatnonzero(dec & (a_on != a_off))
        if bad.size:
            raise AssertionError(
                f"quantization flag off vs on, row {r}: the two routes' "
                f"teacher-forced argmax differ at decisive positions "
                f"{bad.tolist()}")
        agree += int(dec.sum())
    if agree < QUANT_MIN_DECISIVE * b * QSESSION_NEW:
        raise AssertionError(f"quantization flag off vs on: only {agree} of "
                             f"{b * QSESSION_NEW} positions decisive (at "
                             f"least {QUANT_MIN_DECISIVE:.3g} wanted; "
                             f"largest gap {worst_ulps:.2f} bf16 ulps)")
    _log(f"quantization: flag-on tokens vs the int8-plan session: {first}; "
         f"flag off vs on: teacher-forced logits within {worst:.4g} "
         f"({worst_ulps:.2f} bf16 ulps of the position's largest logit; "
         f"limit {QUANT_ROUTE_ULPS}), argmax equal at all {agree} decisive "
         f"of {b * QSESSION_NEW} positions, sessions' tokens equal at "
         f"{compared} (up to each row's first non-decisive position); "
         f"phase 3l {time.perf_counter() - t_phase:.1f} s")
    return total


def _quant_llama_exactness(torch, seed):
    """4l (a): a 2-layer float32 model at 8B width on the card and, from
    the same state dict, on the CPU, both converted by
    ``weight_only_quantize`` (``lm_head`` kept float): codes bit-equal;
    under each flag value the card's 16 greedy ``generate()`` tokens of 2
    prompts (a captured graph, one per flag; the quantized matmul 14 a
    forward with the flag on, none off) are the CPU's greedy tokens up
    to each row's first non-decisive position: one teacher-forced CPU
    forward along the card's tokens, its argmax equal to them there and
    its logits within ``QUANT_LOGIT_ATOL`` of the card's (so the CPU's
    own greedy run would emit the same tokens, without 16 incremental
    CPU forwards); then one ``LLMPredictor`` on the card whose flag is
    toggled between sessions: its tokens equal ``generate()``'s under
    each value (a graph pair each).  Returns the card's launches."""
    import numpy as np
    from paddle_tpu_torch.inference.llm import LLMPredictor
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.quantization import weight_only_quantize
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, gpu = _build_8b(torch, 2, "float32", seed + 23)
    cpu = LlamaForCausalLM(cfg, device="cpu", init=False)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    for m in (gpu, cpu):
        weight_only_quantize(m, skip=_skip_head)
    for (name, g), c in zip(gpu.named_buffers(), cpu.buffers()):
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"quant layers (a): {name} differs card vs "
                                 f"CPU")
    rng = np.random.default_rng(seed + 23)
    ids = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    lens = [32, 32]
    per_forward = QUANT_PER_LAYER * cfg.num_hidden_layers
    total, toks, notes = {}, {}, []
    t_cpu = 0.0
    for flag in (False, True):
        _int8_flag(flag)
        try:
            _zero_launches()
            g = gpu.generate(ids, max_new_tokens=16,
                             compute_dtype="float32").cpu().numpy()
            torch.cuda.synchronize()
            run = _launch_counts()
        finally:
            _int8_flag(False)
        _add_launches(total, run)
        want = per_forward * 16 if flag else 0
        if run.get("quantized_matmul", 0) != want:
            raise AssertionError(f"quant layers (a) flag={flag}: quantized "
                                 f"matmul {run.get('quantized_matmul', 0)} "
                                 f"launches, want {want}")
        t0 = time.perf_counter()
        lg_c = _tf_rows(torch, cpu, ids, lens, g, flag)
        t_cpu += time.perf_counter() - t0
        lg_g = _tf_rows(torch, gpu, ids, lens, g, flag)
        upto, worst = [], 0.0
        for r in range(2):
            gap = (lg_g[r] - lg_c[r]).abs().amax(dim=-1)
            worst = max(worst, gap.max().item())
            if worst > QUANT_LOGIT_ATOL:
                raise AssertionError(f"quant layers (a) flag={flag}: card "
                                     f"logits differ from the CPU's by "
                                     f"{worst:.3g}")
            upto.append(_hold_upto(
                f"quant layers (a) flag={flag} row {r} (card tokens vs the "
                f"CPU's teacher-forced argmax)", g[r],
                lg_c[r].argmax(-1).numpy(),
                _decisive(torch, lg_c[r], gap.numpy())))
        toks[flag] = g
        notes.append(f"flag {'on' if flag else 'off'}: largest logit gap "
                     f"{worst:.3g}, tokens equal through {upto} of 16")
    pred = LLMPredictor(gpu, batch=2, prompt_len=32, max_cache_len=64,
                        steps_per_call=8, compute_dtype="float32")
    for flag in (False, True):
        _int8_flag(flag)
        try:
            got = pred.generate(ids, max_new_tokens=16)
        finally:
            _int8_flag(False)
        if not np.array_equal(got, toks[flag]):
            raise AssertionError(f"quant layers (a): the session's tokens "
                                 f"under flag={flag} differ from "
                                 f"generate()'s")
    if len(pred._graphs) != 2:
        raise AssertionError(f"quant layers (a): the session holds "
                             f"{len(pred._graphs)} graph pairs, want 2")
    _log(f"quant layers (a): 2 layers at 8B width, float32, converted "
         f"(lm_head float): codes bit-equal card vs CPU; {'; '.join(notes)} "
         f"(bound {QUANT_LOGIT_ATOL}); CPU forwards {t_cpu:.2f} s; a "
         f"session toggled between flags equals generate() under each "
         f"(two graph pairs)")
    del pred, gpu, cpu
    torch.cuda.empty_cache()
    return total


def _quant_epilogues(torch, seed):
    """4l (b): ``nn.Sequential(Linear(4096, 16384), GELU, Linear(16384,
    4096), ReLU, Linear(4096, 4096))`` with random biases, converted and
    its GELU and ReLU folded (``fuse_act_into_quant_linear``: 2), at
    M=256 in bf16 and float32 with the flag on: each fused layer's
    output against ``quantized_matmul_plain`` with its bias and act on the
    same input, the unfused layer's product against the plain product
    (the layer adds its bias after it), at the kernel table's
    tolerances; 3 launches a forward."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.nn.quant import QuantizedLinearInfer
    from paddle_tpu_torch.ops.quantized_matmul import (
        quantized_matmul, quantized_matmul_plain)
    from paddle_tpu_torch.quantization import (fuse_act_into_quant_linear,
                                               weight_only_quantize)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 31)
    total = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        net = tnn.Sequential(tnn.Linear(4096, 16384, dtype=dtype), tnn.GELU(),
                             tnn.Linear(16384, 4096, dtype=dtype), tnn.ReLU(),
                             tnn.Linear(4096, 4096, dtype=dtype))
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, torch.nn.Linear):
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape,
                                                   generator=gen,
                                                   device="cuda"))
        weight_only_quantize(net)
        if fuse_act_into_quant_linear(net) != 2:
            raise AssertionError("quant layers (b): fused pairs != 2")
        x = torch.randn(256, 4096, generator=gen, device="cuda").to(dt)
        _int8_flag(True)
        try:
            with torch.no_grad():
                _zero_launches()
                out = net(x)
                torch.cuda.synchronize()
                run = _launch_counts()
                h = x
                for i, layer in enumerate(net):
                    if not isinstance(layer, QuantizedLinearInfer):
                        h = layer(h)
                        continue
                    out_i = layer(h)
                    if layer._fused_act:
                        got = out_i
                        want = quantized_matmul_plain(
                            h, layer.qweight, layer.weight_scale,
                            bias=layer.bias, act=layer._fused_act)
                    else:
                        # the kernel's product; the layer adds the bias
                        # after it, in x's dtype
                        got = quantized_matmul(h, layer.qweight,
                                               layer.weight_scale)
                        want = quantized_matmul_plain(
                            h, layer.qweight, layer.weight_scale)
                        if not torch.equal(out_i, got + layer.bias.to(dt)):
                            raise AssertionError(
                                f"quant layers (b) layer {i} {dtype}: the "
                                f"layer is not the kernel plus its bias")
                    _check(torch, f"quant layers (b) layer {i} "
                           f"({layer._fused_act or 'no act'}) {dtype}",
                           got, want, dtype, tol=QMM_TOL[dtype])
                    h = out_i
        finally:
            _int8_flag(False)
        if not torch.equal(h, out) or run.get("quantized_matmul") != 3:
            raise AssertionError(f"quant layers (b) {dtype}: the forward "
                                 f"differs from its layers' or launched "
                                 f"{run}")
        _add_launches(total, run)
        del net, x, out, h
    torch.cuda.empty_cache()
    return total


def _quant_convnet(torch, seed):
    """4l (c): a small conv net (Conv2D 3->16, ReLU, pool, Linear 16->10)
    on the card and, from the same state dict, on the CPU, float32: PTQ
    (``AbsmaxObserver``, 3 calibration batches) with codes bit-equal and
    scales within 1e-6; QAT (fake quanters on activations and weights,
    3 SGD steps, each from the card's state on both sides) with losses
    within 1e-5, the card's trained state loaded into the CPU's before
    ``convert``; each converted model's
    ``QuantizedConv2DInfer`` and ``QuantizedLinearInfer`` outputs card
    against CPU within 1e-4 of the largest entry."""
    import numpy as np
    from paddle_tpu_torch import nn as tnn, optimizer as topt
    from paddle_tpu_torch import quantization as tq
    from paddle_tpu_torch.nn.quant import (QuantizedConv2DInfer,
                                           QuantizedLinearInfer)

    def build(dev):
        return tnn.Sequential(
            tnn.Conv2D(3, 16, 3, padding=1, device=dev), tnn.ReLU(),
            tnn.AdaptiveAvgPool2D(1), tnn.Flatten(),
            tnn.Linear(16, 10, device=dev))

    rng = np.random.default_rng(seed + 37)
    xs = [rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
          for _ in range(3)]
    y = rng.integers(0, 10, 8).astype(np.int64)
    errs = []

    def layers_agree(tag, g, c, x):
        hg, hc = torch.from_numpy(x).cuda(), torch.from_numpy(x)
        with torch.no_grad():
            for lg, lc in zip(g, c):
                og, oc = lg(hg), lc(hc)
                if isinstance(lg, (QuantizedConv2DInfer,
                                   QuantizedLinearInfer)):
                    errs.append(_card_cpu(torch, f"{tag} "
                                          f"{type(lg).__name__}", og, oc,
                                          1e-4))
                hg, hc = og, oc

    gpu, cpu = _pair_models(torch, build)
    convs = []
    for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
        ptq = tq.PTQ(tq.QuantConfig(activation=tq.AbsmaxObserver))
        q = ptq.quantize(m, inplace=False)
        for x in xs:
            q(torch.from_numpy(x).to(dev))
        convs.append(ptq.convert(q))
    for k in (0, 4):
        g, c = convs[0][k], convs[1][k]
        if not (torch.equal(g.qweight.cpu(), c.qweight) and torch.allclose(
                g._act_scale.cpu(), c._act_scale, rtol=1e-6, atol=0)):
            raise AssertionError(f"quant layers (c): PTQ layer {k} codes or "
                                 f"scales differ card vs CPU")
    layers_agree("quant layers (c) PTQ", convs[0], convs[1], xs[0])
    gpu, cpu = _pair_models(torch, build)
    qats = []
    for m in (gpu, cpu):
        qat = tq.QAT(tq.QuantConfig(
            activation=tq.FakeQuanterWithAbsMaxObserver,
            weight=tq.FakeQuanterChannelWiseAbsMaxObserver))
        qm = qat.quantize(m)
        qm.train()
        qats.append((qat, qm, topt.SGD(learning_rate=0.05,
                                       parameters=qm.parameters())))
    (gqat, gq, gopt), (cqat, cq, copt) = qats
    losses = []
    for _ in range(3):
        # each step from the same state on both sides: a fake-quant code
        # that float32 noise tips across a rounding boundary would
        # otherwise part the two runs for good
        cq.load_state_dict({k: v.cpu() for k, v in gq.state_dict().items()})
        step = []
        for qm, opt, dev in ((gq, gopt, "cuda"), (cq, copt, "cpu")):
            loss = tnn.functional.cross_entropy(
                qm(torch.from_numpy(xs[0]).to(dev)),
                torch.from_numpy(y).to(dev))
            loss.backward()
            opt.step()
            opt.clear_grad()
            step.append(float(loss.detach()))
        losses.append(step)
    if max(abs(a - b) for a, b in losses) > 1e-5:
        raise AssertionError(f"quant layers (c): QAT losses (card, CPU) "
                             f"{losses}")
    cq.load_state_dict({k: v.cpu() for k, v in gq.state_dict().items()})
    gi, ci = gqat.convert(gq), cqat.convert(cq)
    gi.eval()
    ci.eval()
    layers_agree("quant layers (c) QAT", gi, ci, xs[1])
    _log(f"quant layers (c): conv net PTQ and QAT (3 steps, each from the "
         f"card's state on both sides: losses (card, CPU) {losses}): "
         f"converted layers card vs CPU within {max(errs):.3g} of the "
         f"largest entry (limit 1e-4)")


def phase_quant_exactness_layers(torch, seed):
    """Phase 4l: the quantization slice's exactness on the card against
    the CPU (``_quant_llama_exactness``, ``_quant_epilogues``,
    ``_quant_convnet``).  Returns the launch counts of (a) and (b)."""
    t0 = time.perf_counter()
    total = _quant_llama_exactness(torch, seed)
    _add_launches(total, _quant_epilogues(torch, seed))
    _quant_convnet(torch, seed)
    _log(f"quant layers: phase 4l {time.perf_counter() - t0:.1f} s")
    return total


# phase 3k: GPT-3 13B at full width through phase 3's engine geometry, at
# 6 of its 40 layers (the smoke's time: ROADMAP.md)
GPT_SERVE_LAYERS = 6
GPT_ENGINE = dict(num_slots=8, prompt_len=512, chunk_len=256,
                  max_cache_len=1024, block_len=16, compute_dtype="bfloat16")
GPT_DENSE = dict(prompt=512, new=64)    # 3k (d): B=8 generate()
GPT_ARMS = (("lockstep", dict(async_dispatch=False)), ("depth 1", {}))
GPT_TURNS = (0, 1, 1, 0)
# phase 4k: a 4-layer float32 GPT with D = 64
GPT_EXACT = dict(hidden_size=512, num_hidden_layers=4,
                 num_attention_heads=8, intermediate_size=2048,
                 vocab_size=1024, max_position_embeddings=512)
# phases 5k and 5e: GPT-2 small pretraining and ERNIE-base fine-tuning
GPT_TRAIN = dict(batch=8, seq=1024, lr=3e-4)
ERNIE_TRAIN = dict(batch=32, seq=128, lr=5e-5, classes=2)


def phase_gpt_kernels(torch, seed):
    """Phase 2's cases at the new geometries of the GPT paths, each held
    against its plain version as phase 2 holds Llama's (rows bit-equal
    alone, beside an all-trash row and across batches; a row's bits
    equal at every M with bias) and timed beside its bound and its
    library call.  Returns ``{kernel: [row, ...]}``."""
    import numpy as np
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 19)
    rng = np.random.default_rng(seed + 19)
    rows = {k: [] for k in (
        "paged_decode_attention", "paged_decode_attention_int8",
        "paged_decode_attention_multi", "paged_decode_attention_multi_int8",
        "decode_attention", "quantized_matmul", "flash_attention_fwd",
        "flash_attention_bwd")}
    dtype = "bfloat16"
    for geom in GPT_DECODE_GEOMS:
        rows["paged_decode_attention"].append(
            _decode_case(torch, dtype, gen, rng, geom))
        rows["paged_decode_attention_int8"].append(
            _decode_int8_case(torch, dtype, gen, rng, geom))
        rows["paged_decode_attention_multi"] += _multi_case(
            torch, dtype, gen, rng, False, geom)[:1]
        rows["paged_decode_attention_multi_int8"] += _multi_case(
            torch, dtype, gen, rng, True, geom)[:1]
    rows["decode_attention"].append(
        _dense_case(torch, dtype, gen, GPT_DECODE_GEOMS[0]))
    torch.cuda.empty_cache()
    for bits in (8, 4):
        for k, n in GPT_QMM_KN:
            for m in QMM_ROW_MS:
                rows["quantized_matmul"].append(
                    _qmm_case(torch, dtype, bits, m, k, n, gen, bias=True))
            _qmm_rows_case(torch, bits, gen, k=k, n=n)
            torch.cuda.empty_cache()
    for fdt, b in (("bfloat16", GPT_TRAIN["batch"]), ("float32", 2)):
        fwd, bwd = _flash_case(torch, fdt, b, gen, geom=GPT_FLASH)
        rows["flash_attention_fwd"].append(fwd)
        rows["flash_attention_bwd"].append(bwd)
        torch.cuda.empty_cache()
    for name, cases in rows.items():
        for c in cases:
            lib = c["library_ms"]
            _log(f"{name} {c['shape']} {c['dtype']}: "
                 f"max_abs_err={c['max_abs_err']:.3g} "
                 f"kernel_ms={c['ms']:.4f} bound_ms={c['bound_ms']:.4f} "
                 f"({c['bound_by']}) plain_ms={c['plain_ms']:.4f} "
                 f"library_ms=" + ("none" if lib is None else f"{lib:.4f}"))
    return rows


def _build_gpt(torch, cfg, dtype, seed, device=None, tag="model"):
    from paddle_tpu_torch.models import GPTForCausalLM
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=device, dtype=dtype, seed=seed)
    if device is None:
        torch.cuda.synchronize()
    _log(f"{tag}: GPT {cfg.num_hidden_layers} layers, hidden "
         f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, D "
         f"{cfg.head_dim}, vocab {cfg.vocab_size}, {dtype}, "
         f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
         f"built in {time.perf_counter() - t0:.2f} s")
    return model


def _gpt_serving_launches(nl, st, int8=False, quant=False):
    """Phase 3k's launch formula: the paged decode (float or int8) L per
    decode step, the quantized matmul 4L per forward (qkv, out, fc_in,
    fc_out; quantized weights only), nothing else: GPT has no RMSNorm and
    no RoPE, and the prefill chunk's attention is no kernel."""
    from paddle_tpu_torch.ops import KERNELS
    want = {name: 0 for name in KERNELS}
    want["paged_decode_attention" + ("_int8" if int8 else "")] = \
        nl * st["decode_steps"]
    if quant:
        want["quantized_matmul"] = 4 * nl * (st["prefill_chunks"]
                                             + st["decode_steps"])
    return want


def _gpt_spec_launches(nl, nd, st):
    """Phase 3k (c): the K-wide verify L per verify forward, the paged
    decode L per decode step, and the drafter's ``generate()``: the flash
    forward ``nd`` per prefill (one a proposal), the dense decode ``nd``
    per decode step (``k - 1`` a proposal)."""
    from paddle_tpu_torch.ops import KERNELS
    proposals = st["spec_draft_hits"] + st["spec_draft_misses"]
    want = {name: 0 for name in KERNELS}
    want.update({
        "paged_decode_attention": nl * st["decode_steps"],
        "paged_decode_attention_multi": nl * st["spec_verify_steps"],
        "flash_attention_fwd": nd * proposals,
        "decode_attention": nd * (SPEC["k"] - 1) * proposals})
    return want


def _gpt_serving_arms(torch, seed, cfg, model, total):
    """3k (a): the lockstep and the default arm in turns, twice each."""
    from paddle_tpu_torch.inference import ServingEngine
    nl = cfg.num_hidden_layers
    tokens = first = None
    for turn, ai in enumerate(GPT_TURNS):
        tag, arm = GPT_ARMS[ai]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(model, **GPT_ENGINE, **arm)
        launches, st, wall, n_req, n_tok, rng, reqs = _serve_trace(
            torch, eng, cfg, seed)
        peak = torch.cuda.max_memory_allocated()
        _check_launches(launches, _gpt_serving_launches(nl, st), st)
        _add_launches(total, launches)
        outs = [r.output.tolist() for r in reqs]
        if tokens is None:
            tokens, first = outs, tag
        elif outs != tokens:
            raise AssertionError(f"gpt serving: the {tag} arm's tokens "
                                 f"differ from the {first} arm's")
        g = st["decode_graphs"]
        _log_serving(f"gpt serving [{tag}, turn {turn + 1}]", n_req, n_tok,
                     wall, st, launches,
                     f"decode graphs {g['captures']} captured in "
                     f"{g['capture_seconds'] * 1e3:.1f} ms, {g['replays']} "
                     f"replays; peak memory {peak / 2 ** 30:.2f} GiB; ")
        if GPT_TURNS.index(ai) == turn:
            prof = _profile_decode(torch, eng, rng, cfg.vocab_size)
            if prof is not None:
                _log(f"gpt serving [{tag}]: decode step {prof['wall_ms']:.3f}"
                     f" ms unprofiled, device busy {prof['busy_ms']:.3f} ms, "
                     f"idle {100 * prof['idle']:.1f}%")
        del eng
    torch.cuda.empty_cache()
    _log(f"gpt serving: {len(GPT_TURNS)} runs of {len(GPT_ARMS)} arms gave "
         f"equal tokens")
    return tokens


def _gpt_quant_arms(torch, seed, cfg, model, total):
    """3k (b): int8 KV with int8, then int4, weights (each projection's
    bias in the kernel's epilogue)."""
    from paddle_tpu_torch.inference import ServingEngine
    nl = cfg.num_hidden_layers
    for wd in ("int8", "int4"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServingEngine(model, kv_cache_dtype="int8", weight_dtype=wd,
                            **GPT_ENGINE)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        launches, st, wall, n_req, n_tok, rng, _reqs = _serve_trace(
            torch, eng, cfg, seed)
        peak = torch.cuda.max_memory_allocated()
        _check_launches(launches, _gpt_serving_launches(
            nl, st, int8=True, quant=True), st)
        _add_launches(total, launches)
        _log_serving(f"gpt serving [int8 KV + {wd} weights]", n_req, n_tok,
                     wall, st, launches,
                     f"plan built in {plan_s:.2f} s; modeled weight bytes a "
                     f"forward {eng._weight_sweep_bytes / 2 ** 30:.3f} GiB; "
                     f"peak memory {peak / 2 ** 30:.2f} GiB; ")
        prof = _profile_decode(torch, eng, rng, cfg.vocab_size)
        if prof is not None:
            _log(f"gpt serving [int8 KV + {wd} weights]: decode step "
                 f"{prof['wall_ms']:.3f} ms unprofiled, device busy "
                 f"{prof['busy_ms']:.3f} ms, idle {100 * prof['idle']:.1f}%")
        del eng
    torch.cuda.empty_cache()


def _gpt_spec_arm(torch, seed, cfg, model, total):
    """3k (c): spec_decode=4 with a ModelDrafter over a 2-layer GPT of
    the same width from another seed."""
    import dataclasses
    from paddle_tpu_torch.inference import ModelDrafter, ServingEngine
    nl = cfg.num_hidden_layers
    other = _build_gpt(torch, dataclasses.replace(cfg, num_hidden_layers=2),
                       "bfloat16", seed + 5, tag="gpt drafter")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, drafter=ModelDrafter(
        other, max_context=SPEC["max_context"], max_draft=SPEC["k"],
        compute_dtype="bfloat16"), **GPT_ENGINE)
    launches, st, wall, n_tok, rng = _spec_trace(torch, eng, cfg, seed,
                                                 SPEC_TRACE_SHORT)
    peak = torch.cuda.max_memory_allocated()
    _check_launches(launches, _gpt_spec_launches(nl, 2, st), st)
    _add_launches(total, launches)
    rate = st["spec_acceptance_rate"]
    if not rate < 1 or st["blocks_in_use"] != 0:
        raise AssertionError(f"gpt spec: acceptance {rate}, blocks in use "
                             f"{st['blocks_in_use']}")
    _log(f"gpt spec serving (drafter: 2-layer GPT at 13B width): "
         f"{len(SPEC_TRACE_SHORT)} requests, {n_tok} tokens in {wall:.3f} s "
         f"= {n_tok / wall:.2f} tokens/s; mean TTFT "
         f"{st['mean_ttft_s'] * 1e3:.2f} ms; verify step "
         f"{st['verify_seconds'] / st['spec_verify_steps'] * 1e3:.3f} ms "
         f"over {st['spec_verify_steps']} verifies; acceptance {rate:.3f}; "
         f"drafts {st['spec_draft_tokens']}; decode steps "
         f"{st['decode_steps']}; peak memory {peak / 2 ** 30:.2f} GiB; "
         f"drafter graph captures {_capture_ms(other)} ms; launches "
         f"{launches}")
    _profile_verify(torch, eng, rng, cfg.vocab_size)
    del eng, other
    torch.cuda.empty_cache()


def _gpt_dense_arms(torch, seed, cfg, model, total):
    """3k (d): greedy ``generate()`` at B=8 (prompt 512, 64 new, ragged)
    as a captured graph against its eager program, and an 8-row
    ``LLMPredictor`` whose session graphs (prefill, a 16-step block)
    equal its eager programs and ``generate()``; launches per replay
    equal to the eager program's."""
    import numpy as np
    from paddle_tpu_torch.inference import threefry
    from paddle_tpu_torch.inference.llm import LLMPredictor
    from paddle_tpu_torch.models.generation import generate_program
    rng = np.random.default_rng(seed + 16)
    b, s, m = 8, GPT_DENSE["prompt"], GPT_DENSE["new"]
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lens = rng.integers(64, s + 1, b).astype(np.int32)
    lens[0] = s
    kw = dict(seq_lens=lens, max_new_tokens=m, max_cache_len=s + m,
              compute_dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    with torch.no_grad():
        want = generate_program(
            model, _dense_cfg(dict(max_new_tokens=m,
                                   compute_dtype="bfloat16")),
            torch.from_numpy(ids).cuda(), torch.from_numpy(lens).cuda(),
            threefry.as_key(threefry.prng_key(0), torch.device("cuda")),
            s + m)
    torch.cuda.synchronize()
    eager = _launch_counts()
    first = model.generate(ids, **kw)
    cap = _capture_ms(model)
    _zero_launches()
    got = model.generate(ids, **kw)
    torch.cuda.synchronize()
    replay = _launch_counts()
    _add_launches(total, replay)
    if not (torch.equal(first, want) and torch.equal(got, want)):
        raise AssertionError("gpt generate(): the graph's tokens differ from "
                             "the eager program's")
    if replay != eager or not eager:
        raise AssertionError(f"gpt generate(): launches per replay {replay} "
                             f"!= the eager program's {eager}")
    wall = _wall_ms(torch, lambda: model.generate(ids, **kw))
    busy = _busy_ms(torch, lambda: model.generate(ids, **kw))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _log(f"gpt generate() greedy B={b}, prompt {s} (ragged), {m} new: graph "
         f"== eager bit for bit; capture {cap} ms; replay wall {wall:.2f} ms "
         f"({b * m / wall * 1e3:.1f} tokens/s), {_fmt_busy(busy, wall)}; "
         f"peak memory {peak:.2f} GiB; launches per replay {replay}")
    model.__dict__.pop("_generate_graphs", None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = LLMPredictor(model, compute_dtype="bfloat16", **SESSION)
    torch.cuda.synchronize()
    cap_ms = (time.perf_counter() - t0) * 1e3
    _zero_launches()
    got = pred.generate(ids, seq_lens=lens, max_new_tokens=SESSION_NEW)
    torch.cuda.synchronize()
    _add_launches(total, _launch_counts())
    pred.start(ids, seq_lens=lens)
    _zero_launches()
    pred.decode(SESSION["steps_per_call"])
    torch.cuda.synchronize()
    replay = _launch_counts()
    n_blocks = (SESSION_NEW - 1) // SESSION["steps_per_call"]
    want, eager = _session_eager(torch, model, pred, ids, lens, n_blocks, 0)
    if not np.array_equal(got, want):
        raise AssertionError("gpt session: the graphs' tokens differ from "
                             "the eager programs'")
    if replay != eager or not eager:
        raise AssertionError(f"gpt session: launches per block replay "
                             f"{replay} != the eager block's {eager}")
    gen = model.generate(ids, seq_lens=lens, max_new_tokens=SESSION_NEW,
                         max_cache_len=SESSION["max_cache_len"],
                         compute_dtype="bfloat16").cpu().numpy()
    if not np.array_equal(got, gen):
        raise AssertionError("gpt session: tokens differ from generate()'s")

    def block():
        pred.start(ids, seq_lens=lens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.decode(SESSION["steps_per_call"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    bwall = min(block() for _ in range(3))
    pred.start(ids, seq_lens=lens)
    busy = _busy_ms(torch, lambda: pred.decode(SESSION["steps_per_call"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = SESSION["steps_per_call"]
    _log(f"gpt session B={b}, prompt {s}, {steps} steps a block: graphs == "
         f"eager programs == generate() bit for bit; construction (both "
         f"captures) {cap_ms:.1f} ms; block wall {bwall:.2f} ms "
         f"({b * steps / bwall * 1e3:.1f} tokens/s), "
         f"{_fmt_busy(busy, bwall)}; peak memory {peak:.2f} GiB; launches "
         f"per block {replay}")
    del pred
    model.__dict__.pop("_generate_graphs", None)
    torch.cuda.empty_cache()


def phase_gpt_serving(torch, seed):
    """Phase 3k: GPT-3 13B at full width (``GPT_SERVE_LAYERS`` of its 40
    layers, hidden 5120, 40 heads of D = 128, ffn 20480, vocab 50304,
    2048 positions; bf16 random weights from ``seed``) through phase 3's
    engine geometry and trace: (a) the lockstep and the default arm in
    turns, twice each, tokens equal; (b) int8 KV with int8, then int4, weights; (c)
    ``spec_decode=4`` with a 2-layer GPT drafter; (d) ``generate()`` and
    ``LLMPredictor`` as captured graphs.  Every run holds its launch
    formula.  Returns the launches of each path."""
    import dataclasses
    from paddle_tpu_torch.models import gpt3_13b_config
    cfg = dataclasses.replace(gpt3_13b_config(),
                              num_hidden_layers=GPT_SERVE_LAYERS)
    t0 = time.perf_counter()
    model = _build_gpt(torch, cfg, "bfloat16", seed, tag="gpt serving")
    by_path = {k: {} for k in ("gpt_serving", "gpt_quant", "gpt_speculative",
                               "gpt_dense")}
    _gpt_serving_arms(torch, seed, cfg, model, by_path["gpt_serving"])
    _gpt_quant_arms(torch, seed, cfg, model, by_path["gpt_quant"])
    _gpt_spec_arm(torch, seed, cfg, model, by_path["gpt_speculative"])
    _gpt_dense_arms(torch, seed, cfg, model, by_path["gpt_dense"])
    del model
    torch.cuda.empty_cache()
    _log(f"gpt serving: phase 3k in {time.perf_counter() - t0:.1f} s")
    return by_path


def phase_gpt_exactness(torch, seed):
    """Phase 4k: a 4-layer float32 GPT (hidden 512, 8 heads of D = 64,
    vocab 1024, 512 positions) on the card and, from the same weights, on
    the CPU.  A mixed trace through a 2-slot engine equals each request
    alone on a 1-slot engine, token for token, in float32 and with int8
    KV + int8 weights; a spec engine (ModelDrafter over the target)
    equals the non-spec engine up to each request's first non-decisive
    position (teacher-forced top-2 margin <= 0.01); the card's tokens
    equal the CPU's up to there."""
    import numpy as np
    from paddle_tpu_torch.inference import ModelDrafter, ServingEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**GPT_EXACT)
    model = _build_gpt(torch, cfg, "float32", seed + 1, tag="gpt exactness")
    cpu = GPTForCausalLM(cfg, device="cpu", init=False)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(seed + 1)
    specs = [(40, 12), (17, 5), (64, 9), (33, 7), (5, 10)]
    trace = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for n, m in specs]
    base = dict(prompt_len=64, chunk_len=32, max_cache_len=128,
                block_len=16, compute_dtype="float32")

    def serve(net, n_slots, kw, spec=None, drafter=None, dev=None):
        eng = ServingEngine(net, num_slots=n_slots, drafter=drafter,
                            device=dev, **kw)
        reqs = [eng.submit(ids, max_new_tokens=m, spec_decode=spec)
                for ids, m in trace]
        eng.run()
        return reqs, eng.stats()

    notes = []
    _zero_launches()
    for quant in ({}, dict(kv_cache_dtype="int8", weight_dtype="int8")):
        kw = dict(base, **quant)
        mixed, _st = serve(model, 2, kw)
        for r, (ids, m) in zip(mixed, trace):
            one = ServingEngine(model, num_slots=1, **kw)
            alone = one.submit(ids, max_new_tokens=m)
            one.run()
            if not np.array_equal(r.output, alone.output):
                raise AssertionError(
                    f"gpt exactness: request {r.request_id} mixed "
                    f"{r.output} != alone {alone.output} "
                    f"({quant or 'float'})")
        notes.append(f"{'int8 KV + int8 W' if quant else 'float32'}: "
                     f"2-slot == 1-slot for {len(trace)} requests")
    launched = _launched("gpt exactness", (
        "paged_decode_attention", "paged_decode_attention_int8",
        "quantized_matmul"))
    plain, _ = serve(model, 2, base)
    margins = _margins_on_card(torch, model, trace,
                               [r.output for r in plain], torch.float32)
    dkw = dict(max_context=96, max_draft=SPEC["k"], compute_dtype="float32")
    spec, st = serve(model, 2, base, SPEC["k"],
                     ModelDrafter(model, **dkw))
    cpu_out, _ = serve(cpu, 2, base, dev="cpu")
    compared = total = 0
    for r, p, c, mg in zip(spec, plain, cpu_out, margins):
        u = _upto(mg)
        total += len(mg)
        compared += u
        if not np.array_equal(r.output[:u], p.output[:u]):
            raise AssertionError(f"gpt exactness: spec {r.output} != "
                                 f"non-spec {p.output} before {u}")
        if not np.array_equal(c.output[:u], p.output[:u]):
            raise AssertionError(f"gpt exactness: card {p.output} != CPU "
                                 f"{c.output} before {u}")
    _log(f"gpt exactness: 4 layers, hidden 512, D 64, float32: "
         + "; ".join(notes) + f"; spec (target drafter, acceptance "
         f"{st['spec_acceptance_rate']:.3f}) == non-spec and card == CPU "
         f"over {compared} of {total} positions (up to each request's "
         f"first margin <= 0.01; smallest margin "
         f"{min(float(mg.min()) for mg in margins):.4g}); launches "
         f"{launched}")
    del model, cpu
    torch.cuda.empty_cache()


def _gpt_train_setup(torch, layers, dtype, seed, device=None, init=None,
                     **cfg_kw):
    """GPT-2 small (``layers`` deep) with AdamW (fp32 moments,
    ``GPT_TRAIN['lr']``) under ``TrainStep``; the loss is the model's
    own criterion."""
    import dataclasses
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small_config
    from paddle_tpu_torch.optimizer import AdamW
    cfg = dataclasses.replace(gpt2_small_config(**cfg_kw),
                              num_hidden_layers=layers)
    model = GPTForCausalLM(cfg, device=device, dtype=dtype, seed=seed,
                           init=(device is None) if init is None else init)
    model.train()
    opt = AdamW(learning_rate=GPT_TRAIN["lr"], parameters=model.parameters(),
                multi_precision=True)
    step = TrainStep(model, lambda net, t, l: net(t, labels=l)[0], opt)
    return cfg, model, step


def _ernie_train_setup(torch, layers, seed, device=None, init=None,
                       amp_level=None):
    """ERNIE-base (``layers`` deep) with a 2-class head, AdamW at 5e-5
    under ``TrainStep``; with ``amp_level`` the loss runs under
    ``amp.auto_cast`` at that level (bf16)."""
    import dataclasses
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         ernie_base_config)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = dataclasses.replace(ernie_base_config(), num_hidden_layers=layers)
    model = ErnieForSequenceClassification(
        cfg, ERNIE_TRAIN["classes"], device=device, seed=seed,
        init=(device is None) if init is None else init)
    model.train()
    opt = AdamW(learning_rate=ERNIE_TRAIN["lr"],
                parameters=model.parameters())

    def loss_fn(net, ids, types, labels):
        with amp.auto_cast(enable=amp_level is not None,
                           level=amp_level or "O1"):
            return net(ids, types, labels=labels)[0]
    return cfg, model, TrainStep(model, loss_fn, opt)


def _ernie_batch(torch, cfg, b, s, seed, device):
    """Token ids with a ragged pad tail per row (pad id 0), token types
    0 then 1, labels in {0, 1}."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int64)
    for i, n in enumerate(rng.integers(s // 4, s + 1, b)):
        ids[i, n:] = cfg.pad_token_id
    types = (np.arange(s)[None, :] >= s // 2).astype(np.int64).repeat(b, 0)
    labels = rng.integers(0, ERNIE_TRAIN["classes"], b).astype(np.int64)
    return tuple(torch.from_numpy(a).to(device) for a in (ids, types, labels))


def _timed_steps(torch, step, batch, n=3):
    """One warm-up call, then ``n`` timed calls: (losses, warm-up s,
    mean step s, launches of the warm-up call, of all calls)."""
    from paddle_tpu_torch.ops import KERNELS
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(*batch)]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    first = {name: k.launches for name, k in KERNELS.items()}
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(step(*batch))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    losses = [float(x) for x in losses]
    if not _finite(losses):
        raise AssertionError(f"training losses not finite: {losses}")
    return losses, warm, step_s, first, {name: k.launches
                                         for name, k in KERNELS.items()}


def phase_gpt_training(torch, seed, smi):
    """Phase 5k: GPT-2 small at full width (124M parameters, 12 layers, 12
    heads of D = 64, vocab 50304), bf16, batch 8 x 1024, AdamW under
    ``TrainStep``, 1 + 3 steps an arm: (i) attention-probability dropout
    0 (the hidden dropouts 0.1): the flash forward and the one-pass
    backward 12 times a step each, exactly; (ii) the published dropouts:
    attention on the masked math path with threefry masks, no flash
    launch.  Returns the launches of both arms."""
    from paddle_tpu_torch.ops import KERNELS
    b, s = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
    total = {}
    for tag, kw in (("i: attention dropout 0",
                     dict(attention_probs_dropout_prob=0.0)),
                    ("ii: published dropouts", {})):
        cfg, model, step = _gpt_train_setup(torch, 12, "bfloat16", seed,
                                            **kw)
        nl = cfg.num_hidden_layers
        tokens, labels = _train_batch(torch, cfg, b, s, seed, "cuda")
        losses, warm, step_s, first, launches = _timed_steps(
            torch, step, (tokens, labels))
        per = {name: 0 for name in KERNELS}
        if kw:
            per.update({"flash_attention_fwd": nl, "flash_attention_bwd": nl})
        if first != per or launches != {n: 4 * c for n, c in per.items()}:
            raise AssertionError(f"gpt training ({tag}): launches {first} "
                                 f"a step, {launches} in 4, want {per} a "
                                 f"step")
        _add_launches(total, launches)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"gpt training ({tag}): loss did not fall: "
                                 f"{losses}")
        _finite_params(torch, model)
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in model.parameters())
        n_embed = model.gpt.wte.weight.numel() + model.gpt.wpe.weight.numel()
        flops = 6.0 * (n_params - n_embed) + 6.0 * nl * s * cfg.hidden_size
        tok_s = b * s / step_s
        _log(f"gpt training ({tag}): GPT-2 small, {n_params / 1e6:.1f} M "
             f"params, bf16, batch {b}x{s}: losses "
             f"{['%.4f' % x for x in losses]}; warm-up {warm:.3f} s; step "
             f"{step_s * 1e3:.1f} ms over 3 = {tok_s:.1f} tokens/s; MFU "
             f"{100 * flops * tok_s / PEAK_OPS['bfloat16']:.2f}% "
             f"(6 x {(n_params - n_embed) / 1e6:.1f} M non-embedding params "
             f"+ 6 x {nl} layers x {s} x {cfg.hidden_size} = "
             f"{flops / 1e9:.3f} GFLOP/token against 989 TFLOP/s bf16); peak "
             f"memory {peak / 2 ** 30:.2f} GiB; launches a step {first} on "
             f"{smi}")
        if kw:
            _profile_train_step(torch, step, tokens, labels)
        del step, model
        torch.cuda.empty_cache()
    return total


def phase_ernie_finetune(torch, seed, smi):
    """Phase 5e: ERNIE-base fine-tuning at full width
    (``ErnieForSequenceClassification``, 2 classes, 12 layers, hidden
    768), batch 32 x 128 with ragged pad tails, AdamW at 5e-5 under
    ``amp.auto_cast`` O1 bf16, 1 + 3 steps: losses finite, and no kernel
    launched (the pad mask keeps attention on the math path, as in the
    reference)."""
    from paddle_tpu_torch.ops import KERNELS
    b, s = ERNIE_TRAIN["batch"], ERNIE_TRAIN["seq"]
    cfg, model, step = _ernie_train_setup(torch, 12, seed, amp_level="O1")
    batch = _ernie_batch(torch, cfg, b, s, seed, "cuda")
    losses, warm, step_s, first, launches = _timed_steps(torch, step, batch)
    if any(launches.values()):
        raise AssertionError(f"ernie fine-tune: kernels launched {launches}; "
                             f"the masked attention must stay off flash")
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    _log(f"ernie fine-tune: ERNIE-base, {n_params / 1e6:.1f} M params, "
         f"fp32 under auto_cast O1 bf16, batch {b}x{s}: losses "
         f"{['%.4f' % x for x in losses]}; warm-up {warm:.3f} s; step "
         f"{step_s * 1e3:.1f} ms over 3 = {b * s / step_s:.1f} tokens/s; "
         f"peak memory {peak / 2 ** 30:.2f} GiB; flash launches "
         f"{launches['flash_attention_fwd']}, every kernel 0 (of "
         f"{len(KERNELS)}) on {smi}")
    del step, model
    torch.cuda.empty_cache()
    return launches


def _record_grads(step):
    """Wrap ``step``'s update so that every call's gradients are kept
    (one list a call, in ``step._params`` order); returns that list."""
    seen = []
    apply = step._apply_update

    def rec(grads, lr, key):
        seen.append([g.detach().clone() for g in grads])
        return apply(grads, lr, key)

    step._apply_update = rec
    return seen


def _adamw_replay(torch, p0, grads, hp, lr):
    """AdamW (``jit/train_step.py:_functional_adam``, decoupled decay) in
    float64 from ``p0`` over the per-step gradients ``grads``: the
    parameter those gradients give."""
    b1, b2, eps, wd = hp["beta1"], hp["beta2"], hp["epsilon"], hp["wd"]
    p = p0.double()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for t, g in enumerate(grads, 1):
        g = g.double()
        p = p * (1.0 - lr * wd)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p = p - lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
    return p


def _key_bias(name, n):
    """The elements of a parameter that are an attention key bias (GPT's
    ``qkv_proj.bias`` key third, ERNIE's ``k_proj.bias``), as a slice of
    its ``n`` flat elements, or None."""
    if name.endswith("qkv_proj.bias"):
        return slice(n // 3, 2 * n // 3)
    if name.endswith("k_proj.bias"):
        return slice(0, n)
    return None


def _held(torch, tag, gl, cl, gpu, cpu, p0, ggrads, cgrads, hp, lr):
    """Card against CPU after ``len(gl)`` AdamW steps from one state:
    - losses within the test files' rtol 1e-5;
    - the first step's gradients (both sides at the same parameters)
      within 1e-5 of each tensor's largest (float32 sums in two orders);
    - every parameter within the test files' atol 1e-5 of the CPU's, or,
      where it is not, its difference within 1e-5 of the one AdamW makes
      of the two sides' recorded gradients (``_adamw_replay``).  The
      cause, read on an NVIDIA H100 80GB HBM3 at 700 W:
      an element whose first gradient is float32 noise near zero, |g| of
      a few 1e-9 on both sides; Adam's first update lr g / (|g| + eps)
      has the slope lr / eps there, so a noise-level gap moves it by a
      good part of lr;
    - an attention key bias (its gradient zero in exact arithmetic,
      float32 noise on both sides) within 2 lr steps, as the test files
      hold it."""
    steps = len(gl)
    rel = max(abs(g - c) / abs(c) for g, c in zip(gl, cl))
    if rel > 1e-5:
        raise AssertionError(f"{tag}: card losses {gl} vs CPU {cl}")
    worst = worst_kb = worst_res = worst_g = 0.0
    n_past = n_all = 0
    at = None
    cpar = dict(cpu.named_parameters())
    for i, (name, p) in enumerate(gpu.named_parameters()):
        d = (p.detach().cpu() - cpar[name].detach()).flatten()
        g1 = ggrads[0][i].cpu().flatten()
        c1 = cgrads[0][i].flatten()
        keep = torch.ones(d.numel(), dtype=torch.bool)
        kb = _key_bias(name, d.numel())
        if kb is not None:
            worst_kb = max(worst_kb, d[kb].abs().max().item())
            keep[kb] = False
        if not keep.any():
            continue
        gap = ((g1 - c1).abs()[keep].max() /
               c1.abs()[keep].max().clamp_min(1e-30)).item()
        worst_g = max(worst_g, gap)
        if gap > 1e-5:
            raise AssertionError(f"{tag}: {name}'s first gradients differ by "
                                 f"{gap:.3g} of the tensor's largest")
        worst = max(worst, d[keep].abs().max().item())
        n_all += int(keep.sum())
        idx = ((d.abs() > 1e-5) & keep).nonzero().flatten()
        if not len(idx):
            continue
        n_past += len(idx)
        q0 = p0[name].flatten()[idx]
        pred = (_adamw_replay(torch, q0, [g[i].cpu().flatten()[idx]
                                          for g in ggrads], hp, lr) -
                _adamw_replay(torch, q0, [g[i].flatten()[idx]
                                          for g in cgrads], hp, lr))
        res = (d[idx].double() - pred).abs()
        j = int(res.argmax())
        if res[j].item() > worst_res:
            worst_res = res[j].item()
        k = int(d[idx].abs().argmax())
        if at is None or abs(d[idx[k]].item()) > abs(at[1]):
            e = int(idx[k])
            at = (f"{name}[{e}]", d[e].item(), pred[k].item(),
                  [f"{g[i].flatten()[e].item():.4g}" for g in ggrads],
                  [f"{g[i].flatten()[e].item():.4g}" for g in cgrads])
    if worst_res > 1e-5 or worst_kb > 2 * lr * steps:
        raise AssertionError(
            f"{tag}: parameters differ by up to {worst:.3g}, {n_past} of "
            f"{n_all} past 1e-5, up to {worst_res:.3g} from AdamW's replay "
            f"of the recorded gradients (largest {at}); key biases "
            f"{worst_kb:.3g} (bound {2 * lr * steps:.3g})")
    largest = "" if at is None else (
        f"; largest {at[0]}: {at[1]:.4g} against the replay's {at[2]:.4g}, "
        f"gradients card {at[3]} CPU {at[4]}")
    _log(f"{tag}: losses card {gl} CPU {cl} (max rel diff {rel:.3g}); "
         f"first gradients within {worst_g:.3g} of each tensor's largest; "
         f"parameters max |diff| {worst:.3g}, {n_past} of {n_all} elements "
         f"past 1e-5, each within {worst_res:.3g} of AdamW's replay of "
         f"the recorded gradients{largest}; key biases max |diff| "
         f"{worst_kb:.3g} (bound {2 * lr * steps:.3g})")


def phase_zoo_train_exactness(torch, seed):
    """Phase 6k: phases 5k (arm i) and 5e at 2 layers, float32, TF32 off,
    3 ``TrainStep`` calls on the card and on the CPU from one state dict
    and one batch (GPT 2 x 256; ERNIE 8 x 128, AMP off), each side's
    gradients recorded: losses, first gradients and parameters held as
    ``_held`` sets out."""
    import paddle_tpu_torch as ptt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = 3
    for name in ("gpt", "ernie"):
        if name == "gpt":
            cfg, gpu, gstep = _gpt_train_setup(
                torch, 2, "float32", seed + 2,
                attention_probs_dropout_prob=0.0)
            _, cpu, cstep = _gpt_train_setup(
                torch, 2, "float32", seed + 2, device="cpu",
                attention_probs_dropout_prob=0.0)
            batch = _train_batch(torch, cfg, 2, 256, seed + 2, "cpu")
            lr = GPT_TRAIN["lr"]
        else:
            cfg, gpu, gstep = _ernie_train_setup(torch, 2, seed + 2)
            _, cpu, cstep = _ernie_train_setup(torch, 2, seed + 2,
                                               device="cpu")
            batch = _ernie_batch(torch, cfg, 8, ERNIE_TRAIN["seq"], seed + 2,
                                 "cpu")
            lr = ERNIE_TRAIN["lr"]
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        p0 = {n: p.detach().clone() for n, p in cpu.named_parameters()}
        ggrads, cgrads = _record_grads(gstep), _record_grads(cstep)
        _zero_launches()
        ptt.seed(seed + 3)
        gl = [float(gstep(*(t.cuda() for t in batch))) for _ in range(steps)]
        launched = _launch_counts()
        ptt.seed(seed + 3)
        cl = [float(cstep(*batch)) for _ in range(steps)]
        _held(torch, f"zoo train exactness ({name}, 2 layers at full width, "
              f"float32, {steps} steps; card launches {launched})", gl, cl,
              gpu, cpu, p0, ggrads, cgrads, gstep._hypers, lr)
        if name == "gpt" and not launched.get("flash_attention_bwd"):
            raise AssertionError(f"zoo train exactness: the GPT card run "
                                 f"launched no flash backward: {launched}")
        del gpu, cpu, gstep, cstep, ggrads, cgrads, p0
        torch.cuda.empty_cache()


# ---- the vision and OCR paths (phases 7a-7d) ----

VISION = dict(batch=128, image=224, classes=1000, lr=0.1, momentum=0.9,
              warm=2, steps=5, eval_steps=5)
OCR_DET = dict(batch=8, size=640, post_images=2)
OCR_REC = dict(batch=512, width=320)
OCR_TRAIN = dict(rec_batch=64, rec_width=320, det_batch=4, det_size=640,
                 lr=1e-3, steps=4)
# card against CPU, float32: (relative to the reference's largest entry)
VISION_REL = 1e-4
# ResNet-50's train-mode forward at 2x64x64 normalizes 8 values a channel
# in its last stage; the CPU tests hold it at 1e-3 for the same reason
VISION_REL_R50_TRAIN = 1e-3


def _conv_flops(torch, model, x):
    """Forward multiply-add FLOPs (2 x MACs) of ``model``'s convolutions,
    transposed convolutions and Linear layers on ``x``, from each layer's
    input and output shapes in one eval forward."""
    from paddle_tpu_torch.nn.conv import _ConvNd
    total = [0]

    def hook(m, inp, out):
        if isinstance(m, _ConvNd):
            k = 1
            for d in m.kernel_size:
                k *= d
            if type(m).__name__.endswith("Transpose"):
                macs = inp[0].numel() * (m.out_channels // m.groups) * k
            else:
                macs = out.numel() * (m.in_channels // m.groups) * k
        else:
            macs = out.numel() * m.in_features
        total[0] += 2 * macs

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (_ConvNd, torch.nn.Linear))]
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        model.train(was)
        for h in hooks:
            h.remove()
    return total[0]


# kernel groups of a vision profile, by name, first match wins
VISION_GROUPS = (("conv dgrad", ("dgrad",)),
                 ("conv wgrad", ("wgrad", "splitkreduce")),
                 ("conv forward", ("fprop", "implicit_convolve", "conv")),
                 ("layout transposes", ("nchwtonhwc", "nhwctonchw",
                                        "transpose")),
                 ("batch norm", ("batch_norm", "batchnorm", "bn_")),
                 ("LSTM", ("lstm", "rnn")),
                 ("GEMM", ("gemm", "nvjet", "cutlass")),
                 ("pooling", ("pool",)))


def _vision_groups(per_kernel):
    out = {g: 0.0 for g, _ in VISION_GROUPS}
    out["elementwise and other"] = 0.0
    for name, us in per_kernel.items():
        n = name.lower()
        for g, keys in VISION_GROUPS:
            if any(k in n for k in keys):
                out[g] += us / 1e3
                break
        else:
            out["elementwise and other"] += us / 1e3
    return out


def _profile_busy(torch, tag, fn, wall_ms=None):
    """One call of ``fn`` under ``torch.profiler``: logs device busy (the
    union of device intervals), the idle share of the profiled wall, busy
    ms by ``VISION_GROUPS`` and the top kernels; returns (busy ms, wall
    ms, groups)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_kernel, count = _profile_kernels(torch, prof)
    if not per_kernel:
        _log(f"  {tag}: profiled wall {wall:.3f} ms; device busy not "
             f"measured (the profiler recorded no CUDA kernel)")
        return None, wall, {}
    union_us, _span = _union_us(torch, prof)
    busy = union_us / 1e3
    groups = _vision_groups(per_kernel)
    _log(f"  {tag}: profiled wall {wall:.3f} ms, device busy {busy:.3f} "
         f"ms, idle {100 * (1 - busy / wall):.1f}%, "
         f"{sum(count.values())} kernels; by group: " + "; ".join(
             f"{g} {ms:.3f}" for g, ms in groups.items() if ms))
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        _log(f"    {us / 1e3:9.3f} ms x{count[name]:<4d} {name[:100]}")
    return busy, wall, groups


def _zero_kernels(tag):
    """Raise unless no port kernel launched since the counts were set to
    0; returns the (all-zero) counts of every kernel."""
    from paddle_tpu_torch.ops import KERNELS
    counts = {n: k.launches for n, k in KERNELS.items()}
    if any(counts.values()):
        raise AssertionError(f"{tag}: port kernels launched: "
                             f"{ {n: c for n, c in counts.items() if c} }")
    return counts


def phase_vision_training(torch, seed, smi):
    """Phase 7a (see the module docstring); returns the launches of every
    port kernel over the phase (all 0, asserted)."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    b, s, v = VISION["batch"], VISION["image"], VISION
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True       # this run's choice only
    _zero_launches()
    try:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn((b, 3, s, s), generator=gen,
                        device="cuda").to(torch.bfloat16)
        y = torch.randint(0, v["classes"], (b,), generator=gen,
                          device="cuda")
        arms = {}
        for df in ("NCHW", "NHWC"):
            net = resnet50(num_classes=v["classes"], data_format=df,
                           seed=seed).to(torch.bfloat16)
            net.train()
            opt = Momentum(learning_rate=v["lr"], momentum=v["momentum"],
                           parameters=net.parameters())
            step = TrainStep(net, lambda n, a, c: F.cross_entropy(n(a), c)
                             .mean(), opt)
            arms[df] = (net, step, {n: t.clone()
                                    for n, t in net.named_buffers()})
        flops = _conv_flops(torch, arms["NCHW"][0], x)
        per_img = flops / b
        n_params = sum(p.numel() for p in arms["NCHW"][0].parameters())
        res = {df: [] for df in arms}
        losses = {df: [] for df in arms}
        for df in ("NCHW", "NHWC", "NHWC", "NCHW"):
            net, step, _ = arms[df]
            torch.cuda.reset_peak_memory_stats()
            for _ in range(v["warm"]):
                losses[df].append(step(x, y))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(v["steps"]):
                losses[df].append(step(x, y))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / v["steps"] * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            res[df].append((ms, peak))
        for df, (net, step, buf0) in arms.items():
            ls = [float(t) for t in losses[df]]
            if not _finite(ls):
                raise AssertionError(f"resnet50 {df}: losses not finite: "
                                     f"{ls}")
            moved = 0
            for name, t in net.named_buffers():
                if not torch.isfinite(t.float()).all():
                    raise AssertionError(f"resnet50 {df}: buffer {name} "
                                         f"not finite")
                moved += int(not torch.equal(t, buf0[name]))
            if moved != len(buf0):
                raise AssertionError(f"resnet50 {df}: {len(buf0) - moved} "
                                     f"of {len(buf0)} buffers did not move")
            tries = "; ".join(
                f"{ms:.2f} ms = {b / ms * 1e3:.1f} images/s, conv MFU "
                f"{100 * 3 * per_img * b / (ms * 1e-3) / PEAK_OPS['bfloat16']:.2f}%, "
                f"peak {pk:.2f} GiB" for ms, pk in res[df])
            _log(f"resnet50 training ({df}): {n_params / 1e6:.1f} M params, "
                 f"bf16, batch {b}x3x{s}x{s}, Momentum lr {v['lr']}: "
                 f"losses {['%.4f' % x_ for x_ in ls]}; {len(buf0)} buffers "
                 f"moved, finite; two tries of {v['steps']} steps after "
                 f"{v['warm']} warm-up: {tries}; forward "
                 f"{per_img / 1e9:.3f} GFLOP/image (convs and fc, 2 x MACs "
                 f"from the layer shapes), conv MFU = 3 x that x images/s / "
                 f"989 TFLOP/s; on {smi}")
            _profile_busy(torch, f"resnet50 train step ({df}), profiled",
                          lambda: step(x, y))
            grads = [torch.zeros_like(p) for p in step._params]
            lr = step._prepare()

            def update():
                with torch.no_grad():
                    step._apply_update(grads, lr, 0)

            _profile_busy(torch, f"resnet50 Momentum update alone ({df}, "
                                 f"{len(grads)} parameters)", update)
            net.eval()
            with torch.no_grad():
                for _ in range(2):
                    net(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(v["eval_steps"]):
                    out = net(x)
                torch.cuda.synchronize()
                ev = (time.perf_counter() - t0) / v["eval_steps"] * 1e3
            net.train()
            if not torch.isfinite(out.float()).all() or \
                    tuple(out.shape) != (b, v["classes"]):
                raise AssertionError(f"resnet50 {df} eval: bad output")
            _log(f"resnet50 eval forward ({df}): B={b}, {ev:.2f} ms = "
                 f"{b / ev * 1e3:.1f} images/s")
        del arms
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = prev
    return _zero_kernels("phase 7a")


def phase_ocr_inference(torch, seed, smi):
    """Phase 7b (see the module docstring); returns the launches (all
    0, asserted)."""
    from paddle_tpu_torch.models import (CRNN, DBNet, PPOCRSystem,
                                         ctc_greedy_decode, db_postprocess)
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    _zero_launches()
    try:
        system = PPOCRSystem(DBNet(seed=seed), CRNN(seed=seed + 1))
        system = system.to(torch.bfloat16).eval()
        det, rec = system.det, system.rec
        gen = torch.Generator(device="cuda").manual_seed(seed)
        db, ds = OCR_DET["batch"], OCR_DET["size"]
        rb, rw = OCR_REC["batch"], OCR_REC["width"]
        dx = torch.rand((db, 3, ds, ds), generator=gen,
                        device="cuda").to(torch.bfloat16)
        rx = torch.rand((rb, 3, 32, rw), generator=gen,
                        device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            maps = system(dx)["maps"]
            if tuple(maps.shape) != (db, 1, ds, ds) or not (
                    (maps >= 0) & (maps <= 1)).all():
                raise AssertionError(f"ocr det: maps {tuple(maps.shape)} "
                                     f"not in [0, 1]")
            det_ms = _time_ms(torch, lambda: system(dx), warmup=2, iters=10)
            feats = det.backbone(dx)
            neck = det.neck(feats)
            parts = {"backbone": _time_ms(torch, lambda: det.backbone(dx),
                                          warmup=2, iters=10),
                     "neck (DBFPN)": _time_ms(torch, lambda: det.neck(feats),
                                              warmup=2, iters=10),
                     "head": _time_ms(torch, lambda: det.head(neck),
                                      warmup=2, iters=10)}
            det_flops = _conv_flops(torch, det, dx) / db
            _log(f"ocr detection: DBNet (scale 0.5, 96 FPN channels), bf16, "
                 f"{db}x3x{ds}x{ds}: {det_ms:.3f} ms = "
                 f"{db / det_ms * 1e3:.1f} images/s (CUDA events); parts "
                 + "; ".join(f"{k} {ms:.3f} ms" for k, ms in parts.items())
                 + f"; {det_flops / 1e9:.3f} GFLOP/image; on {smi}")
            _profile_busy(torch, "ocr detection forward, profiled",
                          lambda: system(dx))
            n_post = OCR_DET["post_images"]
            t0 = time.perf_counter()
            boxes = db_postprocess(maps[:n_post])
            post_ms = (time.perf_counter() - t0) * 1e3
            _log(f"ocr db_postprocess (host flood fill): {n_post} of {db} "
                 f"maps, {post_ms:.1f} ms = {post_ms / n_post:.1f} ms an "
                 f"image; boxes {[len(bx) for bx in boxes]}")
            logits = system.recognize_crops(rx)
            t_steps = rw // 4
            if tuple(logits.shape) != (rb, t_steps, 97) or \
                    not torch.isfinite(logits.float()).all():
                raise AssertionError(f"ocr rec: logits "
                                     f"{tuple(logits.shape)} not finite")
            rec_ms = _time_ms(torch, lambda: system.recognize_crops(rx),
                              warmup=2, iters=10)
            feat = rec.convs(rx)
            bb, c, h, w = feat.shape
            seq = feat.permute(0, 3, 1, 2).reshape(bb, w, c * h)
            enc, _ = rec.encoder(seq)
            rparts = {"convolutions": _time_ms(torch, lambda: rec.convs(rx),
                                               warmup=2, iters=10),
                      "BiLSTM": _time_ms(torch, lambda: rec.encoder(seq),
                                         warmup=2, iters=10),
                      "classifier": _time_ms(torch, lambda: rec.fc(enc),
                                             warmup=2, iters=10)}
            rec_flops = _conv_flops(torch, rec, rx) / rb
            _log(f"ocr recognition: CRNN (hidden 96, 97 classes), bf16, "
                 f"{rb}x3x32x{rw} ({t_steps} time steps): {rec_ms:.3f} ms = "
                 f"{rb / rec_ms * 1e3:.1f} images/s (CUDA events); parts "
                 + "; ".join(f"{k} {ms:.3f} ms" for k, ms in rparts.items())
                 + f"; convs and fc {rec_flops / 1e9:.3f} GFLOP/image")
            _profile_busy(torch, "ocr recognition forward, profiled",
                          lambda: system.recognize_crops(rx))
            t0 = time.perf_counter()
            texts = ctc_greedy_decode(logits)
            dec_ms = (time.perf_counter() - t0) * 1e3
            if len(texts) != rb:
                raise AssertionError("ocr rec: decode lost rows")
            _log(f"ocr ctc_greedy_decode (host): {rb} rows x {t_steps} "
                 f"steps in {dec_ms:.1f} ms; mean length "
                 f"{sum(map(len, texts)) / rb:.1f}")
        del system, det, rec, feats, neck, feat, seq, enc
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = prev
    return _zero_kernels("phase 7b")


def _ocr_train_run(torch, tag, model, loss_fn, batch, smi, shape):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Adam
    model = model.to(torch.bfloat16).train()
    opt = Adam(learning_rate=OCR_TRAIN["lr"], parameters=model.parameters())
    step = TrainStep(model, loss_fn, opt)
    torch.cuda.reset_peak_memory_stats()
    losses = [step(*batch)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OCR_TRAIN["steps"]):
        losses.append(step(*batch))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / OCR_TRAIN["steps"] * 1e3
    ls = [float(x) for x in losses]
    if not _finite(ls) or not ls[-1] < ls[0]:
        raise AssertionError(f"{tag}: losses not finite and falling: {ls}")
    _log(f"{tag}: bf16, {shape}, Adam lr {OCR_TRAIN['lr']} (unfused), "
         f"repeated batch: losses {['%.4f' % x for x in ls]}; step "
         f"{ms:.2f} ms over {OCR_TRAIN['steps']}; peak "
         f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {smi}")
    _profile_busy(torch, f"{tag} step, profiled", lambda: step(*batch))


def phase_ocr_training(torch, seed, smi):
    """Phase 7c (see the module docstring); returns the launches (all
    0, asserted)."""
    from paddle_tpu_torch.models import CRNN, CTCHeadLoss, DBLoss, DBNet
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    _zero_launches()
    try:
        gen = torch.Generator(device="cuda").manual_seed(seed + 5)
        rb, rw = OCR_TRAIN["rec_batch"], OCR_TRAIN["rec_width"]
        x = torch.rand((rb, 3, 32, rw), generator=gen,
                       device="cuda").to(torch.bfloat16)
        lens = torch.randint(5, 26, (rb,), generator=gen, device="cuda")
        labels = torch.randint(1, 97, (rb, 25), generator=gen,
                               device="cuda")
        crit = CTCHeadLoss()
        _ocr_train_run(torch, "ocr training, CRNN + CTC",
                       CRNN(seed=seed + 2),
                       lambda n, a, y, ln: crit(n(a), y, ln),
                       (x, labels, lens), smi,
                       f"{rb}x3x32x{rw}, labels of 5-25")
        db, ds = OCR_TRAIN["det_batch"], OCR_TRAIN["det_size"]
        dx = torch.rand((db, 3, ds, ds), generator=gen,
                        device="cuda").to(torch.bfloat16)
        gt = torch.zeros((db, 1, ds, ds), device="cuda",
                         dtype=torch.bfloat16)
        gt[:, :, ds // 4:ds // 2, ds // 8:3 * ds // 4] = 1.0
        dcrit = DBLoss()
        _ocr_train_run(torch, "ocr training, DBNet + DBLoss",
                       DBNet(seed=seed + 3),
                       lambda n, a, g: dcrit(n(a), g, g * 0.5),
                       (dx, gt), smi, f"{db}x3x{ds}x{ds}, one text box")
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = prev
    return _zero_kernels("phase 7c")


def _card_cpu(torch, tag, got, want, rel):
    """Assert card ``got`` within ``rel`` of max(1, |want|) of the CPU's
    ``want``; returns the largest |diff| over that scale."""
    g = got.detach().float().cpu()
    w = want.detach().float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{tag}: card output not finite")
    scale = max(1.0, w.abs().max().item())
    err = (g - w).abs().max().item() / scale
    if err > rel:
        raise AssertionError(f"{tag}: card vs CPU {err:.3g} of the largest "
                             f"entry (limit {rel:.3g})")
    return err


def _card_cpu_ulp(torch, tag, got, want):
    """Assert bf16 card ``got`` within one bf16 ulp of each entry of the
    CPU's ``want`` (``|got - want| <= |want| 2^-7``, element by
    element); returns the largest share of that limit."""
    g = got.detach().float().cpu()
    w = want.detach().float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{tag}: card output not finite")
    share = ((g - w).abs() / (w.abs() * 2.0 ** -7 + 1e-30)).max().item()
    if share > 1.0:
        raise AssertionError(f"{tag}: card vs CPU {share:.3g} bf16 ulps of "
                             f"an entry (limit 1)")
    return share


def _pair_models(torch, build):
    gpu = build(None)
    cpu = build("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    return gpu, cpu


def phase_vision_exactness(torch, seed):
    """Phase 7d (see the module docstring): returns (vision launches,
    ocr launches), all 0 (asserted)."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (CRNN, CRNNConfig, CTCHeadLoss,
                                         DBNet, DBNetConfig)
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models as vm
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True   # the caller's default
    worst = {}
    try:
        _zero_launches()
        g = torch.Generator().manual_seed(seed + 7)
        x = torch.randn((2, 3, 64, 64), generator=g)
        for depth in (18, 50):
            for df in ("NCHW", "NHWC"):
                gpu, cpu = _pair_models(torch, lambda d: getattr(
                    vm, f"resnet{depth}")(num_classes=7, data_format=df,
                                          device=d, seed=seed))
                for mode in ("eval", "train"):
                    gpu.train(mode == "train")
                    cpu.train(mode == "train")
                    with torch.no_grad():
                        got, want = gpu(x.cuda()), cpu(x)
                    rel = VISION_REL_R50_TRAIN if (depth, mode) == (
                        50, "train") else VISION_REL
                    tag = f"resnet{depth} {df} {mode}"
                    worst[tag] = _card_cpu(torch, tag, got, want, rel)
                    cb = dict(cpu.named_buffers())
                    for name, t in gpu.named_buffers():
                        d = (t.cpu() - cb[name]).abs() - 1e-4 * \
                            cb[name].abs()
                        if d.max().item() > 1e-5:
                            raise AssertionError(f"{tag}: buffer {name} "
                                                 f"off by {d.max():.3g}")
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("the port changed the caller's TF32 "
                                 "setting")
        # two train steps of ResNet-18 with Momentum
        gpu, cpu = _pair_models(torch, lambda d: vm.resnet18(
            num_classes=10, device=d, seed=seed + 1))
        p0 = {n: p.detach().clone() for n, p in cpu.named_parameters()}
        steps = []
        for net in (gpu, cpu):
            net.train()
            opt = Momentum(learning_rate=0.01, momentum=0.9,
                           parameters=net.parameters())
            steps.append(TrainStep(net, lambda n, a, c: F.cross_entropy(
                n(a), c).mean(), opt))
        gx = torch.randn((4, 3, 64, 64), generator=g)
        gy = torch.randint(0, 10, (4,), generator=g)
        gl = [float(steps[0](gx.cuda(), gy.cuda())) for _ in range(2)]
        cl = [float(steps[1](gx, gy)) for _ in range(2)]
        rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(gl, cl))
        if rel > 1e-4:
            raise AssertionError(f"resnet18 train steps: losses card {gl} "
                                 f"CPU {cl}")
        cpar = dict(cpu.named_parameters())
        frob = 0.0
        for name, p in gpu.named_parameters():
            _card_cpu(torch, f"resnet18 step {name}", p, cpar[name],
                      VISION_REL)
            dg = p.detach().cpu() - p0[name]
            dc = cpar[name].detach() - p0[name]
            frob = max(frob, ((dg - dc).norm() / dc.norm().clamp_min(
                1e-30)).item())
        if frob > 5e-3:
            raise AssertionError(f"resnet18 train steps: an update differs "
                                 f"by {frob:.3g} (relative Frobenius)")
        worst["resnet18 2 Momentum steps, losses (rel)"] = rel
        worst["resnet18 updates (relative Frobenius)"] = frob
        vision = _zero_kernels("phase 7d (vision)")
        _zero_launches()
        det = _pair_models(torch, lambda d: DBNet(
            DBNetConfig(backbone_scale=0.25, fpn_channels=32), device=d,
            seed=seed + 2))
        dx = torch.randn((2, 3, 64, 64), generator=g)
        for mode in ("train", "eval"):
            for net in det:
                net.train(mode == "train")
            with torch.no_grad():
                got = det[0](dx.cuda())["maps"]
                want = det[1](dx)["maps"]
            worst[f"dbnet {mode} maps"] = _card_cpu(
                torch, f"dbnet {mode}", got[:, :2], want[:, :2], VISION_REL)
            if mode == "train":      # the binary map's slope reaches 12.5
                worst["dbnet binary map"] = _card_cpu(
                    torch, "dbnet binary", got[:, 2:], want[:, 2:],
                    20 * VISION_REL)
        rec = _pair_models(torch, lambda d: CRNN(
            CRNNConfig(num_classes=12, hidden_size=16), device=d,
            seed=seed + 3))
        rx = torch.randn((2, 3, 32, 64), generator=g)
        labels = torch.tensor([[3, 3, 5, 1], [2, 7, 0, 0]])
        lens = torch.tensor([4, 2])
        outs = []
        for net, dev in zip(rec, ("cuda", "cpu")):
            net.train()
            logits = net(rx.to(dev))
            loss = CTCHeadLoss()(logits, labels.to(dev), lens.to(dev))
            grads = torch.autograd.grad(loss, [net.convs[0].conv.weight,
                                               net.encoder.weight_ih_l0])
            outs.append((logits, loss, grads))
        worst["crnn logits"] = _card_cpu(torch, "crnn logits", outs[0][0],
                                         outs[1][0], VISION_REL)
        worst["crnn ctc loss"] = _card_cpu(torch, "crnn ctc", outs[0][1],
                                           outs[1][1], VISION_REL)
        for k, name in enumerate(("convs.0 weight", "LSTM weight_ih_l0")):
            worst[f"crnn grad {name}"] = _card_cpu(
                torch, f"crnn grad {name}", outs[0][2][k], outs[1][2][k],
                VISION_REL)
        ocr = _zero_kernels("phase 7d (ocr)")
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("the port changed the caller's TF32 "
                                 "setting")
        _log("vision exactness (float32, card vs CPU, cuDNN TF32 left on "
             "for the caller; limits 1e-4 of the largest entry, ResNet-50 "
             "train 1e-3, the DB binary map 2e-3): " + "; ".join(
                 f"{k} {v:.3g}" for k, v in worst.items()))
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    torch.cuda.empty_cache()
    return vision, ocr


# ---- the hapi surface and the vision ops (phases 7e, 7f) ----

# 7e's fit over 10000 of CIFAR-10's 50000 training images (the smoke's
# time: ROADMAP.md); evaluate on its 10000 test images
HAPI = dict(batch=128, train=10000, test=10000, lr=1e-3, iters=20,
            profile_steps=10, bare_steps=15, bare_pairs=6, lenet=512,
            lenet_batch=64)
# LeNet fit, card against CPU: per-step losses within this of the largest
HAPI_LENET_REL = 1e-4


class _HostSplit:
    """Host time of ``Model.fit``'s step by part, measured by wrapping
    the loader's iterator (the wait for a batch), ``Model.train_batch``,
    ``Model._update_train_metrics`` (the metric update and its
    device-to-host read) and ``hapi.model._loss_value`` (``float(loss)``)
    while the context is open."""

    PARTS = ("loader wait", "train_batch", "metrics + read", "float(loss)")

    def __init__(self):
        self.t = dict.fromkeys(self.PARTS, 0.0)
        self.steps = 0

    def __enter__(self):
        from paddle_tpu_torch.hapi import model as hm
        from paddle_tpu_torch.io import DataLoader
        self._saved = [(DataLoader, "__iter__", DataLoader.__iter__),
                       (hm.Model, "train_batch", hm.Model.train_batch),
                       (hm.Model, "_update_train_metrics",
                        hm.Model._update_train_metrics),
                       (hm, "_loss_value", hm._loss_value)]
        split = self

        def timed(part, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    split.t[part] += time.perf_counter() - t0
            return run

        orig_iter = DataLoader.__iter__

        def loader_iter(dl):
            it = orig_iter(dl)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    split.t["loader wait"] += time.perf_counter() - t0
                yield batch

        orig_tb = hm.Model.train_batch

        def train_batch(*a, **k):
            split.steps += 1
            return timed("train_batch", orig_tb)(*a, **k)

        DataLoader.__iter__ = loader_iter
        hm.Model.train_batch = train_batch
        hm.Model._update_train_metrics = timed(
            "metrics + read", hm.Model._update_train_metrics)
        hm._loss_value = timed("float(loss)", hm._loss_value)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)

    def report(self):
        n = max(self.steps, 1)
        ms = {k: v / n * 1e3 for k, v in self.t.items()}
        ms["step dispatch"] = (ms["train_batch"] - ms["metrics + read"]
                               - ms["float(loss)"])
        return ms


def _step_clock(paddle):
    """A callback that stamps the end of every train batch."""
    class Clock(paddle.hapi.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.stamps, self.losses = [], []

        def on_train_batch_end(self, step, logs=None):
            self.stamps.append(time.perf_counter())
            self.losses.append(logs["loss"])

    return Clock()


def _hapi_model(paddle, net, level=None, lr=HAPI["lr"]):
    m = paddle.Model(net)
    m.prepare(optimizer=paddle.optimizer.Adam(learning_rate=lr,
                                              parameters=net.parameters()),
              loss=paddle.nn.CrossEntropyLoss(),
              metrics=paddle.metric.Accuracy(), amp_configs=level)
    return m


def _profile_fit(torch, tag, fn, steps):
    """One call of ``fn`` (``steps`` train steps) under the profiler:
    device busy, idle share and kernels a step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_kernel, count = _profile_kernels(torch, prof)
    if not per_kernel:
        _log(f"  {tag}: profiled wall {wall:.3f} ms; device busy not "
             f"measured (the profiler recorded no CUDA kernel)")
        return None
    busy = _union_us(torch, prof)[0] / 1e3
    launches = sum(count.values())
    _log(f"  {tag}: {steps} steps, profiled wall {wall:.3f} ms, device "
         f"busy {busy:.3f} ms, idle {100 * (1 - busy / wall):.1f}%, "
         f"{launches / steps:.1f} kernel launches a step; top kernels:")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]:
        _log(f"    {us / 1e3:9.3f} ms x{count[name]:<5d} {name[:100]}")
    return busy, wall, launches / steps


def phase_hapi(torch, seed, smi):
    """Phase 7e (see the module docstring); returns the launches of every
    port kernel over the phase (all 0, asserted)."""
    import warnings

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.examples import resnet_cifar
    from paddle_tpu_torch.io import DataLoader, Subset
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.vision.datasets import MNIST, Cifar10
    from paddle_tpu_torch.vision.models import LeNet, resnet50
    h, b = HAPI, HAPI["batch"]
    _zero_launches()
    # (a) the example twin, ResNet-50, its synthetic default data
    t0 = time.perf_counter()
    logs = resnet_cifar.main(["--arch", "resnet50", "--epochs", "1",
                              "--batch-size", str(b)])
    ex_s = time.perf_counter() - t0
    if not (math.isfinite(logs["loss"]) and 0.0 <= logs["acc"] <= 1.0):
        raise AssertionError(f"resnet_cifar: bad evaluate logs {logs}")
    _log(f"hapi (a) examples.resnet_cifar --arch resnet50 --epochs 1 "
         f"--batch-size {b} on the card: evaluate {logs}; {ex_s:.1f} s "
         f"(1024 train and 256 test images, the build of the model and "
         f"cuDNN's first calls included)")
    # (b) 10000 of CIFAR-10's training images, its 10000 test images,
    # float32, one epoch
    train = Cifar10(mode="train", size=h["train"])
    test = Cifar10(mode="test", size=h["test"])
    net = resnet50(num_classes=10, seed=seed)
    model = _hapi_model(paddle, net)
    clock = _step_clock(paddle)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _HostSplit() as split:
        model.fit(train, batch_size=b, epochs=1, shuffle=False, verbose=0,
                  callbacks=[clock])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(clock.stamps)
    if n != -(-h["train"] // b) or not _finite(clock.losses):
        raise AssertionError(f"hapi (b): {n} steps, losses finite "
                             f"{_finite(clock.losses)}")
    # steady steps: the first (the step's state and cuDNN's first calls)
    # and the short last batch left out
    ms = (clock.stamps[-2] - clock.stamps[0]) / (n - 2) * 1e3
    t0 = time.perf_counter()
    ev = model.evaluate(test, batch_size=b, verbose=0)
    ev_s = time.perf_counter() - t0
    if not (math.isfinite(ev["loss"]) and 0.0 <= ev["acc"] <= 1.0):
        raise AssertionError(f"hapi (b): bad evaluate logs {ev}")
    parts = split.report()
    _log(f"hapi (b) Model.fit ResNet-50 (10 classes) float32, Adam "
         f"{h['lr']}, Cifar10 train size {h['train']} B={b}, one epoch, "
         f"shuffle=False: {n} steps in {fit_s:.1f} s; steady {ms:.2f} ms "
         f"a step = {b / ms * 1e3:.1f} images/s (unprofiled, host clock "
         f"between batch ends); losses first {clock.losses[0]:.4f} last "
         f"{clock.losses[-1]:.4f}; peak {peak:.2f} GiB; host split a step "
         + "; ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
         + f"; evaluate on {h['test']}: {ev} in {ev_s:.1f} s = "
         f"{h['test'] / ev_s:.1f} images/s; on {smi}")
    # profiled window of 10 steps through fit
    window = Subset(train, list(range(h["profile_steps"] * b)))
    _profile_fit(torch, "hapi (b) fit, profiled",
                 lambda: model.fit(window, batch_size=b, epochs=1,
                                   shuffle=False, verbose=0),
                 h["profile_steps"])
    # fit's cost over a bare TrainStep loop on the same batches, in turns
    k = h["bare_steps"]
    sub = Subset(train, list(range(k * b)))
    batches = list(DataLoader(sub, batch_size=b, places="cuda"))
    bare_net = resnet50(num_classes=10, seed=seed)
    ce = paddle.nn.CrossEntropyLoss()
    bare = TrainStep(bare_net, lambda m, x, y: ce(m(x), y),
                     paddle.optimizer.Adam(learning_rate=h["lr"],
                                           parameters=bare_net.parameters()))
    fit_net = resnet50(num_classes=10, seed=seed)
    fit_model = _hapi_model(paddle, fit_net)

    def bare_run():
        for xb, yb in batches:
            loss = bare(xb, yb)
        float(loss)

    def fit_run():
        fit_model.fit(sub, batch_size=b, epochs=1, shuffle=False,
                      verbose=0)

    bare(*batches[0])
    fit_model.fit(Subset(train, list(range(b))), batch_size=b, epochs=1,
                  shuffle=False, verbose=0)
    # pairs of adjacent runs, their order alternating (bare, fit, fit,
    # bare, ...): the host's drift between runs is shared within a pair
    diffs, runs = [], {"bare": [], "fit": []}
    for i in range(h["bare_pairs"]):
        pair = {}
        for arm in (("bare", "fit") if i % 2 == 0 else ("fit", "bare")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (bare_run if arm == "bare" else fit_run)()
            torch.cuda.synchronize()
            pair[arm] = (time.perf_counter() - t0) / k * 1e3
            runs[arm].append(pair[arm])
        diffs.append(pair["fit"] - pair["bare"])
    lo, hi = min(diffs), max(diffs)
    verdict = ("resolved: every pair agrees on the sign" if lo > 0 or hi < 0
               else "unresolved: the pairs disagree on the sign")
    _log(f"hapi (b) fit over a bare TrainStep loop, {h['bare_pairs']} "
         f"pairs of {k}-step runs on the same batches, the order "
         f"alternating (batches already on the card for the bare loop, "
         f"one loss read at its end): fit "
         + " / ".join(f"{t:.2f}" for t in runs["fit"]) + " ms a step, "
         "bare " + " / ".join(f"{t:.2f}" for t in runs["bare"])
         + " ms; fit minus bare by pair "
         + " / ".join(f"{d:+.2f}" for d in diffs)
         + f" ms, median {statistics.median(diffs):+.2f} ms a step, "
         f"range {lo:+.2f} .. {hi:+.2f}; {verdict}")
    del model, net, bare, bare_net, fit_model, fit_net, batches
    torch.cuda.empty_cache()
    # (c) O1, 20 iterations
    o1 = _hapi_model(paddle, resnet50(num_classes=10, seed=seed),
                     level="O1")
    c1 = _step_clock(paddle)
    o1.fit(train, batch_size=b, epochs=1, shuffle=False, verbose=0,
           num_iters=h["iters"], callbacks=[c1])
    torch.cuda.synchronize()
    if len(c1.losses) != h["iters"] or not _finite(c1.losses):
        raise AssertionError(f"hapi (c) O1: losses {c1.losses}")
    o1_ms = (c1.stamps[-1] - c1.stamps[1]) / (len(c1.stamps) - 2) * 1e3
    # (d) two loader workers: CUDA is live, so threads
    mw = _hapi_model(paddle, resnet50(num_classes=10, seed=seed))
    c2 = _step_clock(paddle)
    probe = DataLoader(train, batch_size=b, num_workers=2,
                       use_process_workers=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        use_proc = probe._resolve_process_workers()
    if use_proc or not any("falling back" in str(w.message)
                           for w in caught):
        raise AssertionError("hapi (d): process workers with CUDA live")
    mw.fit(train, batch_size=b, epochs=1, shuffle=False, verbose=0,
           num_workers=2, num_iters=h["iters"], callbacks=[c2])
    torch.cuda.synchronize()
    if len(c2.losses) != h["iters"] or not _finite(c2.losses):
        raise AssertionError(f"hapi (d) workers: losses {c2.losses}")
    mw_ms = (c2.stamps[-1] - c2.stamps[1]) / (len(c2.stamps) - 2) * 1e3
    _log(f"hapi (c) O1 (bf16 convolutions and matmuls), {h['iters']} "
         f"iterations: {o1_ms:.2f} ms a step = {b / o1_ms * 1e3:.1f} "
         f"images/s, losses {c1.losses[0]:.4f} .. {c1.losses[-1]:.4f}; "
         f"(d) num_workers=2: CUDA is initialized, so thread mode "
         f"(use_process_workers=True warns and takes threads), "
         f"{h['iters']} iterations: {mw_ms:.2f} ms a step = "
         f"{b / mw_ms * 1e3:.1f} images/s")
    del o1, mw
    torch.cuda.empty_cache()
    # (e) LeNet, card against CPU, bridged weights
    nets = _pair_models(torch, lambda d: LeNet(device=d, seed=seed))
    losses = []
    for net, dev in zip(nets, ("cuda", "cpu")):
        m = _hapi_model(paddle, net)
        c = _step_clock(paddle)
        data = MNIST(size=h["lenet"])
        m.fit(DataLoader(data, batch_size=h["lenet_batch"], places=dev),
              epochs=1, verbose=0, callbacks=[c])
        losses.append(c.losses)
    scale = max(abs(x) for x in losses[1])
    err = max(abs(a - c) for a, c in zip(*losses)) / scale
    if len(losses[0]) != h["lenet"] // h["lenet_batch"] or \
            err > HAPI_LENET_REL:
        raise AssertionError(f"hapi (e) LeNet card {losses[0]} CPU "
                             f"{losses[1]}")
    # (f) save and load, bits equal
    m = _hapi_model(paddle, nets[0])
    m.fit(MNIST(size=h["lenet_batch"]), batch_size=h["lenet_batch"],
          verbose=0)
    fresh = LeNet(seed=seed + 1)
    with tempfile.TemporaryDirectory() as tmp:
        m.save(os.path.join(tmp, "lenet"))
        _hapi_model(paddle, fresh).load(os.path.join(tmp, "lenet"))
    for (name, a), c in zip(nets[0].state_dict().items(),
                            fresh.state_dict().values()):
        if not torch.equal(a, c):
            raise AssertionError(f"hapi (f): {name} differs after load")
    # (g) O2 refuses a float32 batch at the first convolution
    o2 = _hapi_model(paddle, LeNet(seed=seed), level="O2")
    try:
        o2.fit(MNIST(size=8), batch_size=8, verbose=0)
    except TypeError as e:
        o2_msg = str(e)
    else:
        raise AssertionError("hapi (g): O2 with a float32 batch trained")
    _log(f"hapi (e) LeNet fit, float32, card against CPU on one state, "
         f"{len(losses[0])} steps: losses within {err:.3g} of the largest "
         f"(limit {HAPI_LENET_REL}); (f) save/load: {len(fresh.state_dict())}"
         f" tensors bit-equal; (g) O2: TypeError ({o2_msg})")
    torch.cuda.empty_cache()
    return _zero_kernels("phase 7e")


def phase_vision_ops(torch, seed):
    """Phase 7f (see the module docstring); returns the kernels'
    launches of its ``F.rms_norm`` calls (asserted: the calls made with a
    weight, and nothing else)."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops.rms_norm import rms_norm_plain
    from paddle_tpu_torch.vision import ops
    g = torch.Generator().manual_seed(seed + 21)
    worst = {}

    def both(tag, fn, inputs, diff=()):
        """``fn`` on the card and the CPU on copies of ``inputs``; values
        and the gradients of ``inputs[i]`` for ``i`` in ``diff``."""
        outs = []
        for dev in ("cuda", "cpu"):
            xs = [t.to(dev).requires_grad_(i in diff)
                  if isinstance(t, torch.Tensor) else t
                  for i, t in enumerate(inputs)]
            out = fn(*xs)
            grads = []
            if diff:
                cot = torch.ones_like(out).mul_(0.5).to(dev)
                grads = torch.autograd.grad((out * cot).sum(),
                                            [xs[i] for i in diff])
            outs.append((out, grads))
        (go, gg), (co, cg) = outs
        worst[tag] = _card_cpu(torch, tag, go, co, VISION_REL)
        for i, a, c in zip(diff, gg, cg):
            worst[f"{tag} grad {i}"] = _card_cpu(torch, f"{tag} grad {i}",
                                                 a, c, VISION_REL)

    x = torch.randn((2, 256, 50, 68), generator=g)
    r = 64
    xy = torch.rand((r, 2), generator=g) * torch.tensor([540.0, 400.0])
    wh = torch.rand((r, 2), generator=g) * 200 + 8
    boxes = torch.cat([xy, xy + wh], 1)
    bn = torch.tensor([40, 24])
    both("roi_align", lambda a, b_, n: ops.roi_align(
        a, b_, n, 7, spatial_scale=0.125, sampling_ratio=2), [x, boxes, bn],
        diff=(0,))
    both("roi_pool", lambda a, b_, n: ops.roi_pool(
        a, b_, n, 7, spatial_scale=0.125), [x, boxes, bn], diff=(0,))
    dx = torch.randn((2, 64, 32, 32), generator=g)
    off = torch.randn((2, 18, 32, 32), generator=g) * 2
    mask = torch.rand((2, 9, 32, 32), generator=g)
    wt = torch.randn((64, 64, 3, 3), generator=g) * 0.05
    bias = torch.randn((64,), generator=g)
    both("deform_conv2d v2", lambda a, o, w, b_, m: ops.deform_conv2d(
        a, o, w, b_, padding=1, mask=m), [dx, off, wt, bias, mask],
        diff=(0, 1, 2, 3, 4))
    both("deform_conv2d v1", lambda a, o, w: ops.deform_conv2d(
        a, o, w, stride=2, padding=1), [dx, off[:, :, ::2, ::2], wt],
        diff=(0, 1, 2))
    prior = boxes[:32] / 600.0
    var = torch.tensor([[0.1, 0.1, 0.2, 0.2]]).repeat(32, 1)
    shift = torch.rand((32, 2), generator=g) * 0.05
    target = prior + torch.cat(
        [shift, shift + torch.rand((32, 2), generator=g) * 0.05], 1)
    both("box_coder encode", lambda p, v, t: ops.box_coder(p, v, t),
         [prior, var, target], diff=(2,))
    both("box_coder decode", lambda p, v, t: ops.box_coder(
        p, v, t, "decode_center_size"), [prior, var, target], diff=(2,))
    feat, img = torch.zeros((1, 8, 38, 38)), torch.zeros((1, 3, 300, 300))
    feat_g = feat.cuda()
    pb_g = ops.prior_box(feat_g, img.cuda(), [30.0], [60.0], (1.0, 2.0),
                         flip=True, clip=True)
    pb_c = ops.prior_box(feat, img, [30.0], [60.0], (1.0, 2.0), flip=True,
                         clip=True)
    for a, c in zip(pb_g, pb_c):
        if a.device != feat_g.device or not torch.equal(a.cpu(), c):
            raise AssertionError("prior_box: card and CPU differ")
    scores = torch.rand((r,), generator=g)
    cats = torch.randint(0, 4, (r,), generator=g)
    keep_g = ops.nms(boxes.cuda(), 0.5, scores.cuda(), cats.cuda(), top_k=20)
    keep_c = ops.nms(boxes, 0.5, scores, cats, top_k=20)
    ms_g = ops.matrix_nms(boxes.cuda(), scores.cuda(), 0.1, 0.05,
                          use_gaussian=True)
    ms_c = ops.matrix_nms(boxes, scores, 0.1, 0.05, use_gaussian=True)
    if not (torch.equal(keep_g.cpu(), keep_c) and all(
            torch.equal(a.cpu(), c) for a, c in zip(ms_g, ms_c))):
        raise AssertionError("nms/matrix_nms: card and CPU differ")
    # F.rms_norm: the kernel with a weight, torch ops without
    _zero_launches()
    calls = 0
    for rows, d, dt in ((8, 4096, torch.bfloat16), (64, 2048, torch.float32)):
        xr = torch.randn((rows, d), generator=g).to(dt).cuda()
        w = (1 + 0.1 * torch.randn((d,), generator=g)).to(dt).cuda()
        got = F.rms_norm(xr, w)
        calls += 1
        want = rms_norm_plain(xr, w)
        hold = _card_cpu_ulp if dt == torch.bfloat16 else (
            lambda *a: _card_cpu(*a, 1e-5))
        worst[f"F.rms_norm {dt} weight"] = hold(
            torch, "F.rms_norm weight", got, want.cpu())
        worst[f"F.rms_norm {dt} no weight"] = hold(
            torch, "F.rms_norm", F.rms_norm(xr), F.rms_norm(xr.cpu()))
    from paddle_tpu_torch.ops import KERNELS
    counts = {n: k.launches for n, k in KERNELS.items()}
    if counts.pop("rms_norm") != calls or any(counts.values()):
        raise AssertionError(f"phase 7f: F.rms_norm launches {counts}, "
                             f"{calls} calls with a weight")
    _log("vision ops and F.rms_norm, card against CPU (float32; values and "
         "input gradients within 1e-4 of the largest entry; nms, "
         "matrix_nms and prior_box equal; F.rms_norm float32 within 1e-5 "
         "of the largest entry, bf16 within one bf16 ulp of each entry "
         "(its share of |want| 2^-7 shown); "
         f"{calls} rms_norm launches for {calls} calls with a "
         "weight): " + "; ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    counts["rms_norm"] = calls
    return counts


JIT = dict(layers=4, batch=4, seq=512, cpu_layers=2, cifar_batch=128,
           mlp=(256, 512, 10), mlp_batch=64, static_steps=3,
           replays=5)
JIT_REL = 1e-5                       # float32 card vs CPU (8a (d), (e))


def _jit_grow(x):
    """A tensor ``while`` loop: ``jit.save`` exports it (converted by
    dy2static) as ``torch._higher_order_ops.while_loop``."""
    s = x
    while s.sum() < 1000.0:
        s = s * 2.0 + 1.0
    return s


def _run_device(pred):
    """``pred.run()`` through its handles; the output left on the card."""
    pred.run()
    return pred.get_output_handle("output_0").to_device_array()


def _jit_arm(torch, tag, model, ids, want, prefix, per_run, eager_ms):
    """``jit.save`` of ``model`` at ``ids``' shape, ``create_predictor`` on
    the card, runs through the handles and the list form, each held bit
    for bit against ``want`` (the eager forward on the card) with the
    kernels' launches of one run equal to ``per_run``; a clone shares the
    weights.  Returns the launches of the Predictor's runs; the artifact
    is deleted."""
    import numpy as np
    from paddle_tpu_torch import inference, jit
    stats = jit.save(model, prefix,
                     input_spec=[jit.InputSpec(list(ids.shape), "int64")])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(prefix))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for sfx in (jit.api.PROGRAM_SUFFIX, jit.api.PARAMS_SUFFIX):
        os.remove(prefix + sfx)
    h = pred.get_input_handle("input_0")
    h.share_external_data(ids)
    total = {}
    _zero_launches()
    t0 = time.perf_counter()
    got = _run_device(pred)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _launch_counts()
    _add_launches(total, counts)
    if not torch.equal(got, want):
        d = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{tag}: Predictor logits differ from the "
                             f"eager forward's by up to {d:.4g}")
    if counts != per_run:
        raise AssertionError(f"{tag}: launches of one run {counts}, "
                             f"want {per_run}")
    _zero_launches()
    replay_ms = _wall_ms(torch, lambda: _run_device(pred), n=JIT["replays"])
    runs = JIT["replays"]
    counts = _launch_counts()
    _add_launches(total, counts)
    if counts != {k: v * runs for k, v in per_run.items()}:
        raise AssertionError(f"{tag}: launches of {runs} runs {counts}")
    _zero_launches()
    listed = pred.run([ids])[0]
    _add_launches(total, _launch_counts())
    if not np.array_equal(listed, want.float().cpu().numpy()):
        raise AssertionError(f"{tag}: list-form run differs")
    twin = pred.clone()
    shared = all(a.data_ptr() == b.data_ptr() for a, b in
                 zip(twin._param_values, pred._param_values))
    twin.get_input_handle("input_0").share_external_data(ids)
    _zero_launches()
    if not (shared and torch.equal(_run_device(twin), want)):
        raise AssertionError(f"{tag}: clone shares weights {shared}, or "
                             f"its run differs")
    _add_launches(total, _launch_counts())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _log(f"jit {tag}: jit.save export {stats['export_s']:.2f} s, write "
         f"{stats['write_s']:.2f} s, {stats['bytes'] / 2 ** 30:.3f} GiB; "
         f"create_predictor (load, weights to the card) {load_s:.2f} s; "
         f"first run (warm-up, capture, replay) {first_s:.2f} s; replay "
         f"{replay_ms:.3f} ms (least of {JIT['replays']} synced walls, "
         f"output copied on the card) against the eager forward's "
         f"{eager_ms:.3f} ms; logits bit-equal to the eager forward "
         f"(handles, list form, clone: weights shared {shared}); launches "
         f"a run {per_run}; peak {peak:.2f} GiB")
    del pred, twin
    torch.cuda.empty_cache()
    return total


def _jit_resnet(torch, seed, tmp):
    """8a (d): the CIFAR example's twin exports ResNet-50 (``--export``);
    its Predictor's logits at B=128 against ``Model.predict_batch`` on
    the card, TF32 on for cuDNN around both (each must turn it off for
    float32 convolutions itself); no port kernel launched."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.examples import resnet_cifar
    from paddle_tpu_torch.jit.api import Artifact
    from paddle_tpu_torch.vision.models import resnet50
    prefix = os.path.join(tmp, "resnet")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    _zero_launches()
    try:
        t0 = time.perf_counter()
        resnet_cifar.main(["--arch", "resnet50", "--epochs", "0",
                           "--batch-size", str(JIT["cifar_batch"]),
                           "--export", prefix])
        ex_s = time.perf_counter() - t0
        art = Artifact(prefix)
        net = resnet50(num_classes=10)
        keep = net.state_dict()
        net.load_state_dict({n: v for n, v in zip(art.names, art.values)
                             if n in keep})
        model = paddle.Model(net)
        gen = torch.Generator(device="cuda").manual_seed(seed + 24)
        x = torch.randn((JIT["cifar_batch"], 3, 32, 32), generator=gen,
                        device="cuda")
        want = model.predict_batch([x])
        pred = inference.create_predictor(inference.Config(prefix))
        t0 = time.perf_counter()
        got = pred.run([x])[0]
        first_s = time.perf_counter() - t0
        pred.get_input_handle("input_0").share_external_data(x)
        replay_ms = _wall_ms(torch, lambda: _run_device(pred),
                             n=JIT["replays"])
        eager_ms = _wall_ms(torch, lambda: model.predict_batch([x]),
                            n=JIT["replays"])
        err = _card_cpu(torch, "8a (d) Predictor vs predict_batch",
                        torch.from_numpy(got), want.cpu(), JIT_REL)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    counts = _zero_kernels("phase 8a (d)")
    _log(f"jit 8a (d) examples.resnet_cifar --arch resnet50 --epochs 0 "
         f"--batch-size {JIT['cifar_batch']} --export: {ex_s:.1f} s (the "
         f"model, 256 test images, the export); Predictor at "
         f"B={JIT['cifar_batch']} 3x32x32 float32 against "
         f"Model.predict_batch on the card: within {err:.3g} of the largest "
         f"entry (limit {JIT_REL}), TF32 on for the caller; first run "
         f"{first_s:.2f} s, replay {replay_ms:.3f} ms against predict_batch "
         f"{eager_ms:.3f} ms; no port kernel launched")
    del pred, model, net
    torch.cuda.empty_cache()
    return counts


def _jit_static(torch, seed, tmp):
    """8a (e): ``to_static`` forward and backward, a converted ``while``
    exported and run on the card, and a static ``Program`` trained
    ``static_steps`` steps with ``SGD.minimize`` on the card, then one
    step by a CPU Executor and one by the card's on the same parameters,
    each card against CPU."""
    import copy
    import numpy as np
    from paddle_tpu_torch import jit, nn, optimizer, static
    d_in, d_hid, d_out = JIT["mlp"]
    gen = torch.Generator().manual_seed(seed + 25)
    x = torch.randn((JIT["mlp_batch"], d_in), generator=gen)
    nets = [nn.Sequential(nn.Linear(d_in, d_hid, device="cpu"), nn.GELU(),
                          nn.Linear(d_hid, d_out, device="cpu"))]
    nets.insert(0, copy.deepcopy(nets[0]).to("cuda"))
    outs = []
    for net, dev in zip(nets, ("cuda", "cpu")):
        step = jit.to_static(lambda a, _n=net: _n(a).square().mean())
        loss = step(x.to(dev))
        loss.backward()
        outs.append([loss] + [p.grad for p in net.parameters()])
    worst = max(_card_cpu(torch, "8a (e) to_static", g, c, JIT_REL)
                for g, c in zip(*outs))
    prefix = os.path.join(tmp, "grow")
    jit.save(_jit_grow, prefix, input_spec=[jit.InputSpec([64], "float32")])
    loaded = jit.load(prefix)
    hops = {str(n.target) for n in loaded._artifact.program.graph.nodes
            if n.op == "call_function" and "while_loop" in str(n.target)}
    xs = torch.rand((64,), generator=gen)
    grown = loaded(xs.cuda())
    if not hops or not torch.equal(grown.cpu(), _jit_grow(xs)):
        raise AssertionError(f"8a (e) converted while: graph {hops}, "
                             f"card vs eager CPU differ")
    rng = np.random.default_rng(seed)
    xv = rng.standard_normal((16, d_in)).astype(np.float32)
    yv = rng.standard_normal((16, 1)).astype(np.float32)
    base = nn.Linear(d_in, 1, device="cpu")
    runs = []
    # the card's Executor trains a copy of the host's parameters and
    # writes each update back: a CPU Executor on the same program goes on
    # from them, and the card's after it
    n = JIT["static_steps"]
    for places in (["cuda"] * n + ["cpu", "cuda"], ["cpu"] * (n + 2)):
        lin = copy.deepcopy(base)
        sgd = optimizer.SGD(learning_rate=0.01, parameters=lin.parameters())
        prog = static.Program()
        with static.program_guard(prog):
            xd = static.data("x", [16, d_in], "float32")
            yd = static.data("y", [16, 1], "float32")
            loss = ((lin(xd) - yd) ** 2).mean()
            sgd.minimize(loss)
        exes = {p: static.Executor(p) for p in set(places)}
        losses = [float(exes[p].run(prog, feed={"x": xv, "y": yv},
                                    fetch_list=[loss])[0])
                  for p in places]
        if lin.weight.device.type != "cpu":
            raise AssertionError(f"8a (e) static: the Executor moved the "
                                 f"module's weight to {lin.weight.device}")
        runs.append((losses, lin.weight.detach()))
    (lg, wg), (lc, wc) = runs
    if not lg[-1] < lg[0]:
        raise AssertionError(f"8a (e) static: losses {lg} do not fall")
    worst = max(worst, _card_cpu(torch, "8a (e) static losses",
                                 torch.tensor(lg), torch.tensor(lc),
                                 JIT_REL),
                _card_cpu(torch, "8a (e) static weight", wg, wc, JIT_REL))
    _log(f"jit 8a (e) to_static MLP {JIT['mlp']} forward and backward, a "
         f"converted tensor while exported ({sorted(hops)}) and run on the "
         f"card, a static Program (Linear {d_in}->1, SGD.minimize) "
         f"{n} steps on the card, then one by a CPU Executor and one by the "
         f"card's on the same parameters, losses "
         f"{[round(v, 6) for v in lg]}: "
         f"card vs CPU within {worst:.3g} of the largest entry "
         f"(limit {JIT_REL})")


def phase_jit(torch, seed, smi):
    """Phase 8a (see the module docstring); returns the launches of the
    Predictor runs of (a)-(c), the path's counts."""
    import dataclasses
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_3_8b_config
    from paddle_tpu_torch.quantization import weight_only_quantize
    nl, b, s = JIT["layers"], JIT["batch"], JIT["seq"]
    per_run = {"rms_norm": 2 * nl + 1, "rope": 2 * nl,
               "flash_attention_fwd": nl}
    total = {}
    tmp = tempfile.mkdtemp(prefix="ptpu_jit_")
    try:
        cfg, model = _build_8b(torch, nl, "bfloat16", seed)
        gen = torch.Generator(device="cuda").manual_seed(seed + 23)
        ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device="cuda")
        with torch.no_grad():
            want = model(ids)
            eager_ms = _wall_ms(torch, lambda: model(ids), n=JIT["replays"])
        _add_launches(total, _jit_arm(
            torch, f"8a (a) Llama-3-8B width, {nl} layers, bf16, ids "
            f"{b}x{s}", model, ids, want, os.path.join(tmp, "a"), per_run,
            eager_ms))
        del want
        weight_only_quantize(model, inplace=True, skip=_skip_head)
        _int8_flag(True)
        try:
            with torch.no_grad():
                want = model(ids)
                eager_ms = _wall_ms(torch, lambda: model(ids),
                                    n=JIT["replays"])
            _add_launches(total, _jit_arm(
                torch, "8a (b) the same model by weight_only_quantize, "
                "FLAGS_use_int8_matmul_kernel", model, ids, want,
                os.path.join(tmp, "b"),
                {**per_run, "quantized_matmul": QUANT_PER_LAYER * nl},
                eager_ms))
        finally:
            _int8_flag(False)
        del model, want
        torch.cuda.empty_cache()
        # (c) exported on the CPU, served on the card
        c_cfg = dataclasses.replace(llama_3_8b_config(),
                                    num_hidden_layers=JIT["cpu_layers"])
        small = LlamaForCausalLM(c_cfg, dtype="bfloat16", seed=seed + 1)
        ids2 = torch.flip(ids, dims=(1,))
        with torch.no_grad():
            want, want2 = small(ids), small(ids2)
        small.to("cpu")
        prefix = os.path.join(tmp, "c")
        stats = jit.save(small, prefix, input_spec=[jit.InputSpec([b, s],
                                                                  "int64")])
        del small
        pred = inference.create_predictor(inference.Config(prefix))
        if pred._shared.exported_on != "cpu":
            raise AssertionError("8a (c): the artifact was exported on "
                                 f"{pred._shared.exported_on}")
        pred.get_input_handle("input_0").share_external_data(ids)
        _zero_launches()
        got = _run_device(pred)
        counts = _launch_counts()
        _add_launches(total, counts)
        nc = JIT["cpu_layers"]
        want_c = {"rms_norm": 2 * nc + 1, "rope": 2 * nc,
                  "flash_attention_fwd": nc}
        equal = torch.equal(got, want)
        diff = (got.float() - want.float()).abs().max().item()
        if counts != want_c or not (equal or diff <= TOL["bfloat16"][0]):
            raise AssertionError(f"8a (c): launches {counts} (want "
                                 f"{want_c}); logits off by {diff:.4g}")
        # two clones under enable_memory_optim stage different feeds
        # before either runs; each gets its own logits
        cfg = inference.Config(prefix)
        cfg.enable_memory_optim()
        staged = inference.create_predictor(cfg)
        pair = (staged, staged.clone())
        _zero_launches()
        for p_, feed in zip(pair, (ids, ids2)):
            p_.get_input_handle("input_0").copy_from_cpu(feed.cpu().numpy())
        outs = [_run_device(p_) for p_ in pair]
        _add_launches(total, _launch_counts())
        diff2 = (outs[1].float() - want2.float()).abs().max().item()
        if not (torch.equal(outs[0], got) and (
                torch.equal(outs[1], want2) or diff2 <= TOL["bfloat16"][0])):
            raise AssertionError("8a (c): clones staging different feeds "
                                 "under enable_memory_optim got another "
                                 f"feed's logits (second off by {diff2:.4g})")
        _log(f"jit 8a (c) a {nc}-layer model at 8B width exported on the "
             f"CPU ({stats['export_s']:.2f} s, {stats['bytes'] / 2 ** 30:.3f}"
             f" GiB), served on the card: launches a run {counts}; logits "
             f"{'bit-equal to' if equal else f'within {diff:.4g} of'} the "
             f"eager forward on the card; two clones under "
             f"enable_memory_optim staging different feeds: the first "
             f"bit-equal to the run above, the second within {diff2:.4g} of "
             f"its eager forward")
        del pred, staged, pair, outs
        torch.cuda.empty_cache()
        if not all(total.get(k) for k in per_run):
            raise AssertionError(f"phase 8a: a kernel never launched {total}")
        _jit_resnet(torch, seed, tmp)
        _jit_static(torch, seed, tmp)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return total


# ---- phase 8b: a decoder written against the reference API ----

NN_API = dict(layers=2, batch=2, seq=512, beam=4, steps=31, max_seq=1024,
              rope_base=500000.0, eps=1e-5, start=128000, end=128001,
              varlen=(512, 384, 200, 1, 0), cpu_layers=1, cpu_seq=128,
              cpu_steps=7)
NN_API_LOGIT_REL = 1e-4          # float32 card vs CPU, of max(1, |logit|)
NN_API_REL = 1e-5                # float32 card vs CPU, the small functions


def api_decoder_class():
    """The Llama-architecture decoder phase 8b runs, written the way a
    Paddle user writes one, against the public API only: an ``nn.Layer``
    whose weights come from ``create_parameter`` (``[in, out]``, Normal(0,
    0.02); norms Constant(1)), with ``fused_rms_norm``,
    ``fused_linear``, ``fused_rotary_position_embedding`` (rotate-half,
    the reference's interleaved tables), ``memory_efficient_attention``,
    ``swiglu`` and, for one-token decode, ``masked_multihead_attention``
    over a ``[2, N, H, max_seq, D]`` cache after repeating the kv heads.
    ``memory_efficient_attention`` has no causal form in the reference
    (its ``attn_bias`` is additive, and a bias leaves the kernel), so the
    prefill attends over the whole prompt, as a prefix LM does, and
    decoding is causal over the cache.  ``step(ids, states)`` is the
    cell ``BeamSearchDecoder`` drives: states are the per-layer caches
    ``[N, 2, H, max_seq, D]`` (batch first) and the lengths ``[N]``.
    The tests hold it against the same decoder written against the JAX
    package (``tests/test_torch_decode.py``)."""
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F

    def weight(layer, shape):
        return layer.create_parameter(shape, attr=nn.ParamAttr(
            initializer=nn.initializer.Normal(0.0, 0.02)))

    def unit(layer, n):
        return layer.create_parameter(
            [n], default_initializer=nn.initializer.Constant(1.0))

    class ApiBlock(nn.Layer):
        def __init__(self, hidden, heads, kv_heads, ffn, eps, base, dtype):
            super().__init__(dtype=dtype)
            d = hidden // heads
            self.heads, self.kv_heads, self.d = heads, kv_heads, d
            self.eps, self.base = eps, base
            self.ln1, self.ln2 = unit(self, hidden), unit(self, hidden)
            self.wq = weight(self, [hidden, heads * d])
            self.wk = weight(self, [hidden, kv_heads * d])
            self.wv = weight(self, [hidden, kv_heads * d])
            self.wo = weight(self, [heads * d, hidden])
            self.w_gate_up = weight(self, [hidden, 2 * ffn])
            self.w_down = weight(self, [ffn, hidden])

        def qkv(self, x):
            """Rotated q ``[B, S, H, D]``, k and v ``[B, S, Hkv, D]``."""
            b, s = x.shape[:2]
            h = IF.fused_rms_norm(x, self.ln1, epsilon=self.eps)
            q = IF.fused_linear(h, self.wq).reshape(b, s, self.heads, self.d)
            k = IF.fused_linear(h, self.wk).reshape(b, s, self.kv_heads,
                                                    self.d)
            v = IF.fused_linear(h, self.wv).reshape(b, s, self.kv_heads,
                                                    self.d)
            q, k = IF.fused_rotary_position_embedding(
                q, k, use_neox_rotary_style=False,
                rotary_emb_base=self.base)
            return q, k, v

        def mlp(self, x):
            h = IF.fused_rms_norm(x, self.ln2, epsilon=self.eps)
            return x + IF.fused_linear(
                IF.swiglu(IF.fused_linear(h, self.w_gate_up)), self.w_down)

        def forward(self, x):
            b, s = x.shape[:2]
            q, k, v = self.qkv(x)
            a = IF.memory_efficient_attention(q, k, v)
            x = x + IF.fused_linear(a.reshape(b, s, -1), self.wo)
            return self.mlp(x), k, v

        def decode(self, x, cache, lens, sin, cos):
            n = x.shape[0]
            h = IF.fused_rms_norm(x, self.ln1, epsilon=self.eps)
            q = IF.fused_linear(h, self.wq).reshape(n, 1, self.heads, self.d)
            k = IF.fused_linear(h, self.wk).reshape(n, 1, self.kv_heads,
                                                    self.d)
            v = IF.fused_linear(h, self.wv).reshape(n, self.kv_heads, self.d)
            q, k = IF.fused_rotary_position_embedding(
                q, k, sin=sin, cos=cos, position_ids=lens[:, None],
                use_neox_rotary_style=False)
            g = self.heads // self.kv_heads
            k = k.reshape(n, self.kv_heads, self.d).repeat_interleave(g, 1)
            packed = torch.cat([q.reshape(n, -1), k.reshape(n, -1),
                                v.repeat_interleave(g, 1).reshape(n, -1)],
                               dim=-1)
            out, new = IF.masked_multihead_attention(
                packed, cache.transpose(0, 1), sequence_lengths=lens)
            x = x + IF.fused_linear(out, self.wo)
            return self.mlp(x), new.transpose(0, 1)

    class ApiDecoder(nn.Layer):
        def __init__(self, vocab, hidden, heads, kv_heads, ffn, layers,
                     max_seq, rope_base=500000.0, eps=1e-5,
                     dtype="float32"):
            super().__init__(dtype=dtype)
            self.max_seq, self.base, self.eps = max_seq, rope_base, eps
            self.embed = weight(self, [vocab, hidden])
            self.blocks = nn.LayerList([
                ApiBlock(hidden, heads, kv_heads, ffn, eps, rope_base, dtype)
                for _ in range(layers)])
            self.norm = unit(self, hidden)
            self.lm_head = weight(self, [hidden, vocab])

        def logits(self, x):
            return IF.fused_linear(
                IF.fused_rms_norm(x, self.norm, epsilon=self.eps),
                self.lm_head)

        def forward(self, ids):
            """Prefill: logits ``[B, S, V]`` and each layer's (k, v)."""
            x = F.embedding(ids, self.embed)
            kv = []
            for blk in self.blocks:
                x, k, v = blk(x)
                kv.append((k, v))
            return self.logits(x), kv

        def caches(self, kv):
            """The cell's states after a prefill: per layer ``[B, 2, H,
            max_seq, D]`` (kv heads repeated), then the lengths ``[B]``."""
            out = []
            for blk, (k, v) in zip(self.blocks, kv):
                b, s, hkv, d = k.shape
                g = blk.heads // hkv
                c = k.new_zeros((b, 2, blk.heads, self.max_seq, d))
                c[:, 0, :, :s] = k.repeat_interleave(g, 2).transpose(1, 2)
                c[:, 1, :, :s] = v.repeat_interleave(g, 2).transpose(1, 2)
                out.append(c)
            lens = torch.full((kv[0][0].shape[0],), kv[0][0].shape[1],
                              dtype=torch.int64, device=kv[0][0].device)
            return (*out, lens)

        def tables(self, device):
            """Rotary tables for every cache slot, built as
            ``fused_rotary_position_embedding`` builds its own: ``[1,
            max_seq, 1, D]`` sin and cos."""
            d = self.blocks[0].d
            exps = torch.div(torch.arange(d, dtype=torch.float32,
                                          device=device), 2,
                             rounding_mode="floor") * 2.0 / d
            inv_freq = 1.0 / (self.base ** exps)
            t = torch.arange(self.max_seq, dtype=torch.float32,
                             device=device)
            emb = torch.outer(t, inv_freq)[None, :, None, :]
            return torch.sin(emb), torch.cos(emb)

        def step(self, ids, states):
            """The decode cell: ids ``[N]`` -> (logits ``[N, V]``, states)."""
            *caches, lens = states
            sin, cos = self.tables(ids.device)
            x = F.embedding(ids, self.embed)
            new = []
            for blk, cache in zip(self.blocks, caches):
                x, c = blk.decode(x, cache, lens, sin, cos)
                new.append(c)
            return self.logits(x), (*new, lens + 1)

    return ApiDecoder


def _api_decoder(n_layers, dtype, max_seq):
    """``api_decoder_class()`` at Llama-3-8B's widths (``llama_3_8b_config``:
    hidden 4096, 32/8 heads of D 128, FFN 14336, vocab 128256)."""
    from paddle_tpu_torch.models import llama_3_8b_config
    c = llama_3_8b_config()
    return api_decoder_class()(
        c.vocab_size, c.hidden_size, c.num_attention_heads,
        c.num_key_value_heads, c.intermediate_size, n_layers, max_seq,
        NN_API["rope_base"], NN_API["eps"], dtype)


def _api_beam(keep_gaps=False):
    """A ``BeamSearchDecoder`` subclass whose ``finalize`` also returns the
    steps' raw outputs (scores, tokens, parents); with ``keep_gaps`` it
    records, each step, every batch row's gap between the K-th and the
    (K+1)-th candidate score of its flat top-K (4j's decisiveness)."""
    import torch
    from paddle_tpu_torch import nn

    class KeepSteps(nn.BeamSearchDecoder):
        gaps = []

        def _beam_search_step(self, time, logits, cells, state):
            if keep_gaps:
                vocab = logits.shape[-1]
                noend = torch.full((vocab,), -1e9, device=logits.device)
                noend[self.end_token] = 0.0
                lp = torch.where(state.finished[:, :, None], noend,
                                 torch.log_softmax(logits.float(), dim=-1))
                total = (state.log_probs[:, :, None] + lp).flatten(1)
                top = torch.topk(total, self.beam_size + 1, dim=-1).values
                self.gaps.append((top[:, -2] - top[:, -1]).cpu())
            return super()._beam_search_step(time, logits, cells, state)

        def finalize(self, outputs, final_states, sequence_lengths):
            ids, states = super().finalize(outputs, final_states,
                                           sequence_lengths)
            return (ids, outputs), states

    return KeepSteps


def _greedy(torch, model, states, start, steps):
    """Argmax decoding over ``model.step`` from ``states``: ``[B, steps]``."""
    n = states[-1].shape[0]
    tok = torch.full((n,), start, dtype=torch.int32, device=states[-1].device)
    out = []
    for _ in range(steps):
        logits, states = model.step(tok, states)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)


def _api_small_functions(torch, seed):
    """8b (f): ``sparse_attention``, ``one_hot`` and ``embedding`` (with
    ``padding_idx`` and ids outside [0, V): NaN rows, no device assert),
    card against CPU in float32."""
    import numpy as np
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(seed + 31)
    b, h, s, d, per_row = 2, 4, 256, 64, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)) for _ in range(3))
    cols = np.sort(np.stack([[[rng.choice(s, per_row, replace=False)
                               for _ in range(s)] for _ in range(h)]
                             for _ in range(b)]), axis=-1)
    cols = torch.from_numpy(cols.reshape(b, h, -1).astype(np.int32))
    offset = torch.arange(0, s * per_row + 1, per_row,
                          dtype=torch.int32).expand(b, h, -1).contiguous()
    kp = torch.from_numpy((rng.random((b, s)) > 0.1).astype(np.float32))
    am = torch.tril(torch.ones(s, s))
    args = (q, k, v, offset, cols)
    want = F.sparse_attention(*args, key_padding_mask=kp, attn_mask=am)
    got = F.sparse_attention(*[a.cuda() for a in args],
                             key_padding_mask=kp.cuda(), attn_mask=am.cuda())
    worst = _card_cpu(torch, "8b (f) sparse_attention", got, want,
                      NN_API_REL)
    ids = torch.from_numpy(rng.integers(-12, 12, (4, 16)))
    hot = F.one_hot(ids.cuda(), 9)
    if not torch.equal(hot.cpu(), F.one_hot(ids, 9)):
        raise AssertionError("8b (f) one_hot: card differs from the CPU")
    w = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    for pad in (None, 3):
        e_cpu = F.embedding(ids, w, padding_idx=pad)
        e_gpu = F.embedding(ids.cuda(), w.cuda(), padding_idx=pad)
        torch.cuda.synchronize()        # a device assert would raise here
        nan_rows = int(torch.isnan(e_gpu).all(dim=-1).sum())
        if not (torch.equal(torch.isnan(e_gpu).cpu(), torch.isnan(e_cpu))
                and torch.equal(torch.nan_to_num(e_gpu).cpu(),
                                torch.nan_to_num(e_cpu)) and nan_rows):
            raise AssertionError(f"8b (f) embedding(padding_idx={pad}): "
                                 f"card differs from the CPU")
    _log(f"nn api 8b (f) sparse_attention B={b} H={h} S={s} D={d} "
         f"({per_row} columns a row, both masks) within {worst:.3g} of the "
         f"largest entry (limit {NN_API_REL}); one_hot of ids in [-12, 12) "
         f"over 9 classes equal; embedding of ids in [-12, 12) over V=8 "
         f"with and without padding_idx equal ({nan_rows} NaN rows, no "
         f"device assert)")


def _api_beam_steps(run):
    """``(ids [B, T, K], scores, tokens, parents [B, T, K], lengths [B,
    K])`` of a ``dynamic_decode`` run over ``_api_beam``."""
    (ids, raw), final = run
    return ids, raw.scores, raw.predicted_ids, raw.parent_ids, final.lengths


def _api_exactness(torch, seed):
    """8b (e): the decoder at ``cpu_layers`` layer(s), float32, TF32 off:
    built once on the host, its state carried to one built on the card by
    ``set_state_dict``; prefill logits (B=2, ``cpu_seq``) within
    ``NN_API_LOGIT_REL`` of the largest, beam K=4 over ``cpu_steps + 1``
    steps: tokens and parents equal and scores within
    ``NN_API_LOGIT_REL`` of max(1, |score|) up to each row's first step
    whose CPU K-th/(K+1)-th gap is <= ``BEAM_MARGIN``."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch import nn
    torch.backends.cuda.matmul.allow_tf32 = False
    nl, s, steps = NN_API["cpu_layers"], NN_API["cpu_seq"], NN_API["cpu_steps"]
    prev = tdevice._layer_device
    try:
        t0 = time.perf_counter()
        pt.set_device("cpu")
        pt.seed(seed + 33)
        host = _api_decoder(nl, "float32", s + steps + 8)
        host_s = time.perf_counter() - t0
        pt.set_device("cuda")
        card = _api_decoder(nl, "float32", s + steps + 8)
    finally:
        tdevice._layer_device = prev
    missing, unexpected = card.set_state_dict(host.state_dict())
    if missing or unexpected:
        raise AssertionError(f"8b (e) set_state_dict: {missing} {unexpected}")
    rng = np.random.default_rng(seed + 34)
    ids = torch.from_numpy(rng.integers(0, NN_API["start"],
                                        (NN_API["batch"], s)))
    runs = []
    for model, dev in ((card, "cuda"), (host, "cpu")):
        with torch.no_grad():
            logits, kv = model(ids.to(dev))
            beam = _api_beam(keep_gaps=dev == "cpu")
            beam.gaps = []
            dec = beam(model.step, NN_API["start"], NN_API["end"],
                       NN_API["beam"])
            out = _api_beam_steps(nn.dynamic_decode(
                dec, inits=model.caches(kv), max_step_num=steps))
        runs.append((logits, out, beam.gaps))
    (gl, gout, _), (cl, cout, gaps) = runs
    err = _card_cpu(torch, "8b (e) prefill logits", gl, cl, NN_API_LOGIT_REL)
    gaps = torch.stack(gaps, dim=1).numpy()          # [B, T]
    held = 0
    for r in range(gaps.shape[0]):
        upto = int(np.argmax(gaps[r] <= BEAM_MARGIN)) if (
            gaps[r] <= BEAM_MARGIN).any() else gaps.shape[1]
        for name, g, c in zip(("tokens", "parents"), gout[2:4], cout[2:4]):
            if not torch.equal(g[r, :upto].cpu(), c[r, :upto]):
                raise AssertionError(f"8b (e) row {r} {name} differ before "
                                     f"step {upto}")
        _card_cpu(torch, f"8b (e) row {r} scores", gout[1][r, :upto],
                  cout[1][r, :upto], NN_API_LOGIT_REL)
        held += upto
    _log(f"nn api 8b (e) the decoder at {nl} layer, 8B width, float32, TF32 "
         f"off, built on the host in {host_s:.1f} s and carried to the card "
         f"by set_state_dict: prefill logits B={NN_API['batch']} S={s} "
         f"within {err:.3g} of the largest (limit {NN_API_LOGIT_REL}); beam "
         f"K={NN_API['beam']} over {gaps.shape[1]} steps: tokens and parents "
         f"equal, scores within {NN_API_LOGIT_REL} at {held} of "
         f"{gaps.size} row-steps (each row up to its first K-th/(K+1)-th "
         f"gap <= {BEAM_MARGIN}; smallest gaps "
         f"{np.round(gaps.min(axis=1), 5).tolist()})")
    del card, host
    torch.cuda.empty_cache()


def _api_varlen(torch, model, ids):
    """8b (c): ``flash_attn_unpadded`` over layer 0's q/k/v of the prefill,
    packed (q and k alike) in sequences of ``NN_API["varlen"]`` tokens
    taken from the batch rows in turn, in float32 (the bf16 values
    widened): each sequence's rows are held against the flash kernel on
    the sequence alone in bf16 (``memory_efficient_attention`` without
    ``causal``, ``scaled_dot_product_attention(is_causal=True)`` with it)
    at the flash tolerance (2^-5 of the row's RMS: the float32 math is
    the kernel's plain version), the length-0 sequence adds no row, and
    the card's output is held against the CPU's.  (In bf16 the
    reference's math rounds its scores to bf16: a row of this prefill
    then differs from the kernel's by up to 11% of its RMS on an H100,
    PERF.md.)"""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F
    lens = NN_API["varlen"]
    with torch.no_grad():
        q, k, v = model.blocks[0].qkv(F.embedding(ids, model.embed))
    rows = [i % q.shape[0] for i in range(len(lens))]
    packed = [torch.cat([t[r, :n] for r, n in zip(rows, lens)]).float()
              for t in (q, k, v)]
    cu = torch.tensor([sum(lens[:i]) for i in range(len(lens) + 1)],
                      dtype=torch.int32, device="cuda")
    mx, scale = max(lens), 1.0 / math.sqrt(q.shape[-1])
    worst = {}
    for causal in (False, True):
        out = F.flash_attn_unpadded(*packed, cu, cu, mx, mx, scale,
                                    causal=causal)
        if out.shape != packed[0].shape:
            raise AssertionError(f"8b (c) varlen: shape {tuple(out.shape)}")
        for i, (r, n) in enumerate(zip(rows, lens)):
            if n == 0:
                continue
            a, b_ = int(cu[i]), int(cu[i + 1])
            one = [t[r:r + 1, :n] for t in (q, k, v)]
            alone = (F.scaled_dot_product_attention(*one, is_causal=True)
                     if causal else IF.memory_efficient_attention(*one))[0]
            want = out[a:b_]
            rms = want.square().mean(dim=-1, keepdim=True).sqrt()
            err = ((alone.float() - want).abs()
                   / rms.clamp_min(1e-30)).max().item()
            if err > 2.0 ** -5:
                raise AssertionError(f"8b (c) varlen causal={causal} "
                                     f"sequence {i} ({n} tokens): the flash "
                                     f"kernel alone is {err:.4g} of the row "
                                     f"RMS off")
            worst[causal] = max(worst.get(causal, 0.0), err)
    host = F.flash_attn_unpadded(*[t.cpu() for t in packed], cu.cpu(),
                                 cu.cpu(), mx, mx, scale, causal=True)
    cpu_err = _card_cpu(torch, "8b (c) varlen float32", out, host,
                        NN_API_REL)
    _log(f"nn api 8b (c) flash_attn_unpadded over layer 0's q "
         f"{list(packed[0].shape)} and k/v {list(packed[1].shape)}, lengths "
         f"{list(lens)} packed, float32: the flash kernel on each sequence "
         f"alone (bf16) within {worst[False]:.3g} (not causal, "
         f"memory_efficient_attention) and {worst[True]:.3g} (causal, "
         f"scaled_dot_product_attention) of the row RMS (limit 2^-5), the "
         f"length-0 sequence no row; card vs CPU within {cpu_err:.3g} of "
         f"the largest entry (limit {NN_API_REL})")


def phase_nn_api(torch, seed, smi):
    """Phase 8b (see the module docstring); returns the launches of the
    main path (the first forward, the timed prefills, the beam and greedy
    decodes)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.incubate.nn import functional as IF
    nl, b, s = NN_API["layers"], NN_API["batch"], NN_API["seq"]
    per_prefill = {"rms_norm": 2 * nl + 1, "flash_attention_fwd": nl}
    total = {}
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # (c), (e): float32
    # (a) lazy construction: parameters in host RAM, the card untouched
    pt.seed(seed + 30)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with pt.LazyGuard():
        model = _api_decoder(nl, "bfloat16", NN_API["max_seq"])
    build_s = time.perf_counter() - t0
    params = list(model.parameters())
    on_host = all(p.device.type == "cpu" for p in params)
    grown = torch.cuda.memory_allocated() - before
    if not on_host or grown:
        raise AssertionError(f"8b (a) LazyGuard: parameters on the host "
                             f"{on_host}, card memory grew by {grown} B")
    vocab = model.lm_head.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed + 32)
    ids = torch.randint(0, NN_API["start"], (b, s), generator=gen,
                        device="cuda")
    # a hook registered after the guard's runs after its move
    moved = []

    def after_move(module, args):
        torch.cuda.synchronize()
        moved.append(time.perf_counter())

    hook = model.register_forward_pre_hook(after_move)
    _zero_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, kv = model(ids)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    hook.remove()
    move_s = moved[0] - t0
    counts = _launch_counts()
    _add_launches(total, counts)
    card = resolve_device()
    if not all(p.device == card for p in model.parameters()) or any(
            a is not c for a, c in zip(model.parameters(), params)):
        raise AssertionError("8b (a): the first forward did not place the "
                             "same parameters on the card")
    n_params = sum(p.numel() for p in params)
    _log(f"nn api 8b (a) LazyGuard: the decoder ({nl} layers at Llama-3-8B "
         f"width, bf16, {n_params / 1e9:.3f} B parameters) built in host RAM "
         f"in {build_s:.2f} s, card memory unchanged; the first forward "
         f"moved the same parameters to the card in {move_s:.2f} s and ran "
         f"the prefill in {first_s - move_s:.2f} s")
    # (b) prefill
    if counts != per_prefill:
        raise AssertionError(f"8b (b) prefill launches {counts}, want "
                             f"{per_prefill}")
    if logits.shape != (b, s, vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"8b (b) prefill logits {tuple(logits.shape)} "
                             f"or not finite")
    reps = 3
    _zero_launches()
    with torch.no_grad():
        prefill_ms = _wall_ms(torch, lambda: model(ids), n=reps)
    counts = _launch_counts()
    _add_launches(total, counts)
    if counts != {k_: v_ * reps for k_, v_ in per_prefill.items()}:
        raise AssertionError(f"8b (b) {reps} prefills launched {counts}")
    _log(f"nn api 8b (b) prefill B={b} S={s} bf16: {prefill_ms:.3f} ms "
         f"(least of {reps} synced walls), logits finite, launches a "
         f"prefill {per_prefill}; {smi}")
    # (c) varlen
    _api_varlen(torch, model, ids)
    # (d) beam decode from the prefill's caches
    states = model.caches(kv)
    del logits
    runs = {}
    for k_ in (NN_API["beam"], 1):
        dec = _api_beam()(model.step, NN_API["start"], NN_API["end"], k_)
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = _api_beam_steps(nn.dynamic_decode(
                dec, inits=states, max_step_num=NN_API["steps"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        _add_launches(total, counts)
        t = out[0].shape[1]
        if counts != {"rms_norm": (2 * nl + 1) * t}:
            raise AssertionError(f"8b (d) beam {k_}: {t} steps launched "
                                 f"{counts}")
        runs[k_] = (out, wall, t)
    (out, wall, t) = runs[NN_API["beam"]]
    ids_b, scores = out[0], out[1]
    if ids_b.shape != (b, t, NN_API["beam"]) or not torch.isfinite(
            scores).all() or int(ids_b.max()) >= vocab:
        raise AssertionError(f"8b (d) beam ids {tuple(ids_b.shape)} or "
                             f"scores not finite")
    _zero_launches()
    with torch.no_grad():
        greedy = _greedy(torch, model, states, NN_API["start"],
                         runs[1][2])
    _add_launches(total, _launch_counts())
    one = runs[1][0][0][..., 0]
    if not torch.equal(one, greedy):
        raise AssertionError(f"8b (d) beam_size=1 differs from the greedy "
                             f"loop: {one.tolist()} vs {greedy.tolist()}")
    # masked_multihead_attention alone, at the step's shape
    n = b * NN_API["beam"]
    cache = states[0].repeat_interleave(NN_API["beam"], 0).transpose(0, 1)
    x = torch.randn((n, 3 * cache.shape[2] * cache.shape[4]), generator=gen,
                    device="cuda", dtype=torch.bfloat16)
    lens = torch.full((n,), s + t // 2, dtype=torch.int64, device="cuda")
    mmha_ms = _time_ms(torch, lambda: IF.masked_multihead_attention(
        x, cache, sequence_lengths=lens))
    xb = x.numel() * x.element_size()
    nbytes = 2 * cache.numel() * cache.element_size() + xb + xb // 3
    mmha_bound = nbytes / H100_BYTES_PER_S * 1e3
    _log(f"nn api 8b (d) BeamSearchDecoder(beam_size={NN_API['beam']}) and "
         f"dynamic_decode(max_step_num={NN_API['steps']}) over the "
         f"masked_multihead_attention cell, B={b}, max_seq "
         f"{NN_API['max_seq']}, from the prefill's caches: {t} steps in "
         f"{wall:.3f} s, {wall / t * 1e3:.3f} ms a step (wall, with each "
         f"step's finished check), RMSNorm {2 * nl + 1} a step; beam_size=1 "
         f"({runs[1][1] / runs[1][2] * 1e3:.3f} ms a step) equals the greedy "
         f"argmax loop token for token; masked_multihead_attention alone at "
         f"x {list(x.shape)}, cache {list(cache.shape)} "
         f"bf16: {mmha_ms:.4f} ms against {mmha_bound:.4f} ms for its "
         f"{nbytes / 1e6:.1f} MB (the cache read and the new cache written "
         f"once) at 3.35 TB/s; {smi}")
    del model, states, kv, cache, runs, out
    torch.cuda.empty_cache()
    # (e), (f): checks; their launches are not the path's
    _api_exactness(torch, seed)
    _api_small_functions(torch, seed)
    if not all(total.get(k_) for k_ in per_prefill):
        raise AssertionError(f"phase 8b: a kernel never launched {total}")
    _log(f"nn api 8b: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---- phase 8c: a decoder written against the top-level tensor API ----

TENSOR_API = dict(layers=2, batch=2, seq=1024, hidden=4096, heads=32,
                  kv_heads=8, ffn=14336, eps=1e-5, rope_base=500000.0,
                  std=0.02, cpu_layers=1, cpu_batch=1, cpu_seq=64)
TENSOR_API_REL = 1e-4        # float32 card vs CPU, of the largest entry
TENSOR_API_SWEEP_REL = 1e-4  # the op sweep card vs CPU, float32
# gradients accumulated twice vs twice one backward: the one-pass flash
# backward's dQ sums its tiles in a run-dependent order; bf16 grads hold
# one bf16 ulp of the largest entry
TENSOR_API_REPEAT_REL = 2.0 ** -7


def tensor_decoder_class(P=None):
    """The Llama-architecture decoder phase 8c runs, written the way a
    Paddle user writes one against the top-level tensor API only
    (``to_tensor``, ``normal``, ``matmul``, ``reshape``, ``transpose``,
    ``split``, ``concat``, ``stack``, ``multiply``, ``add``, ``sin``/
    ``cos``, ``cast``, indexing, the operators, ``_C_ops.rms_norm`` and
    ``_C_ops.flash_attention(causal=True)``), with a user ``PyLayer``
    for SwiGLU whose backward is written by hand; nothing of ``torch``,
    ``models`` or ``nn``.  ``P`` is the package (the port by default; the
    tests pass the JAX package to build its twin from the same code).
    Weights are ``[in, out]``; the decoder takes hidden states ``[B, S,
    hidden]`` (no embedding or head) and ``loss`` is the mean square of
    the final norm's output less 0.5, in float32."""
    import importlib
    if P is None:
        import paddle_tpu_torch as P
    C = importlib.import_module(P.__name__ + "._C_ops")

    class SwiGLU(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, gate, up):
            sig = 1.0 / (1.0 + P.exp(-gate))
            ctx.save_for_backward(gate, up, sig)
            return P.multiply(gate * sig, up)

        @staticmethod
        def backward(ctx, g):
            gate, up, sig = ctx.saved_tensor()
            d_gate = g * up * sig * (1.0 + gate * (1.0 - sig))
            return d_gate, g * (gate * sig)

    class TensorDecoder:
        def __init__(self, hidden, heads, kv_heads, ffn, layers,
                     eps=1e-5, rope_base=500000.0, dtype="bfloat16",
                     std=0.02):
            self.hidden, self.heads, self.kv_heads = hidden, heads, kv_heads
            self.d = hidden // heads
            self.eps, self.base, self.dtype = eps, rope_base, dtype
            self.layers = []
            for _ in range(layers):
                self.layers.append({
                    "ln1": self._unit(hidden), "ln2": self._unit(hidden),
                    "wq": self._draw([hidden, heads * self.d], std),
                    "wk": self._draw([hidden, kv_heads * self.d], std),
                    "wv": self._draw([hidden, kv_heads * self.d], std),
                    "wo": self._draw([hidden, heads * self.d], std),
                    "w_gate_up": self._draw([hidden, 2 * ffn], std),
                    "w_down": self._draw([ffn, hidden], std)})
            self.norm = self._unit(hidden)

        def _draw(self, shape, std):
            w = P.normal(0.0, std, shape).astype(self.dtype)
            w.stop_gradient = False
            return w

        def _unit(self, n):
            w = P.ones([n], dtype=self.dtype)
            w.stop_gradient = False
            return w

        def parameters(self):
            out = []
            for layer in self.layers:
                out += [layer[k] for k in sorted(layer)]
            return out + [self.norm]

        def tables(self, s):
            """Rotate-half RoPE tables ``[1, S, 1, D]`` in float32."""
            inv = 1.0 / (self.base ** (P.arange(
                0, self.d, 2, dtype="float32") / float(self.d)))
            pos = P.arange(s, dtype="float32")
            freqs = P.matmul(P.reshape(pos, [s, 1]),
                             P.reshape(inv, [1, self.d // 2]))
            emb = P.concat([freqs, freqs], axis=-1)
            tab = P.stack([P.cos(emb), P.sin(emb)])
            return (P.reshape(tab[0], [1, s, 1, self.d]),
                    P.reshape(tab[1], [1, s, 1, self.d]))

        def rope(self, x, cos, sin):
            xf = P.cast(x, "float32")
            half = self.d // 2
            rot = P.concat([-xf[..., half:], xf[..., :half]], axis=-1)
            out = P.add(P.multiply(xf, cos), P.multiply(rot, sin))
            return P.cast(out, x.dtype)

        def forward(self, x):
            b, s = x.shape[0], x.shape[1]
            cos, sin = self.tables(s)
            for L in self.layers:
                h = C.rms_norm(x, L["ln1"], self.eps)
                q = P.reshape(P.matmul(h, L["wq"]),
                              [b, s, self.heads, self.d])
                k = P.reshape(P.matmul(h, L["wk"]),
                              [b, s, self.kv_heads, self.d])
                v = P.reshape(P.matmul(h, L["wv"]),
                              [b, s, self.kv_heads, self.d])
                q, k = self.rope(q, cos, sin), self.rope(k, cos, sin)
                a = C.flash_attention(q, k, v, causal=True)
                a = P.reshape(a, [b, s, self.heads * self.d])
                x = P.add(x, P.matmul(a, P.transpose(L["wo"], [1, 0])))
                h = C.rms_norm(x, L["ln2"], self.eps)
                gate, up = P.split(P.matmul(h, L["w_gate_up"]), 2, axis=-1)
                x = P.add(x, P.matmul(SwiGLU.apply(gate, up),
                                      L["w_down"]))
            return C.rms_norm(x, self.norm, self.eps)

        @staticmethod
        def loss(out):
            # (the RMS-normed output's own mean square is 1 whatever the
            # input, so the target is offset)
            return P.mean(P.square(P.cast(out, "float32") - 0.5))

    TensorDecoder.SwiGLU = SwiGLU
    return TensorDecoder


def _tensor_decoder(pt, layers, dtype):
    c = TENSOR_API
    return tensor_decoder_class(pt)(
        c["hidden"], c["heads"], c["kv_heads"], c["ffn"], layers, c["eps"],
        c["rope_base"], dtype, c["std"])


# ---- the registry sweep's inputs (numpy only) ----
# The rules of the CPU sweep (tests/test_op_sweep.py ``_auto_inputs`` and
# tests/op_sweep_spec.py ``CUSTOM_INPUTS``), with the tensor factory
# ``T`` a parameter; tests/test_torch_op_sweep.py holds these inputs
# equal to the reference sweep's, op for op.

SWEEP_SKIP = {
    "to_tensor": "constructor, covered by the facade tests",
    "tolist": "host conversion returning python lists",
    "cond": "the reference's sweep skips the name (control flow)",
    "while_loop": "takes python callables",
    "case": "takes python callables",
    "switch_case": "takes python callables",
    "masked_select": "dynamic output shape",
    "nonzero": "dynamic output shape",
    "unique": "dynamic output shape",
    "unique_consecutive": "dynamic output shape",
    "all_reduce": "collective",
    "all_gather": "collective",
}
# draws bit-equal to the reference's for one seed (threefry bits)
SWEEP_BITS = {"rand", "uniform", "uniform_", "randint", "randint_like",
              "randperm", "bernoulli", "dropout", "dropout2d", "dropout3d",
              "alpha_dropout"}
# draws through the same uniforms and torch's erfinv: a few ulps
SWEEP_ULPS = {"normal", "normal_", "standard_normal", "randn", "log_normal"}
# draws that follow the reference's law only: shape and dtype
SWEEP_LAW = {"multinomial", "poisson", "binomial", "standard_gamma",
             "exponential_", "rrelu", "gumbel_softmax"}
# ops whose gradient is not compared, with the reason
SWEEP_NO_GRAD = {
    "increment": "in place on a leaf that needs a gradient: torch "
                 "refuses it (README, 'Known differences of the tensor "
                 "facade')",
    "scatter_": "in place on a leaf (as increment)",
    "unsqueeze_": "in place on a leaf (as increment)",
    "squeeze_": "in place on a leaf (as increment)",
    "reshape_": "in place on a leaf (as increment)",
    "flatten_": "in place on a leaf (as increment)",
    "cast_": "in place on a leaf (as increment)",
    "uniform_": "a draw in place (no gradient)",
    "normal_": "a draw in place (no gradient)",
    "exponential_": "a draw in place (no gradient)",
    "relu_": "in place on a leaf: the reference's leaf loses its "
             "gradient (ROADMAP Queue 3), torch refuses or records it",
    "softmax_": "in place on a leaf (as relu_)",
    "svd": "the reference's tape cannot differentiate svd (its vjp gets "
           "a tuple for jnp's SVDResult: ROADMAP Queue 3)",
    "eig": "no gradient in the reference (host LAPACK)",
    "eigvals": "no gradient in the reference (host LAPACK)",
}
# output slots holding singular/eigen vectors, whose signs are free:
# (vector output, the slot sharing its signs, that slot's vector axis)
SWEEP_SIGNED = {"eigh": (1, None, None), "svd": (0, 2, -2),
                "pca_lowrank": (0, 2, -1)}

_SWEEP_FLOAT_NAMES = {"x", "y", "input", "a", "b", "value", "tensor",
                      "weight", "theta", "grad", "param", "logit", "logits",
                      "other"}
_SWEEP_INT_NAMES = {"index", "indices", "label", "labels", "target"}


def _sweep_rng(seed=0):
    import numpy as np
    return np.random.default_rng(seed)


def sweep_inputs(op, fn, T, F=None, card=False):
    """``(args, kwargs)`` of the sweep's case for ``op`` (``fn`` its
    implementation, read for its signature), every array made by
    ``T(numpy_array)``; ``F`` is the ``nn.functional`` module (the
    unpooling cases pool first).  ``card``: the shapes the card's
    kernels take where the CPU sweep's do not fit them (the flash
    kernels' head_dim is 64 or 128; the CPU sweep's is 4)."""
    import inspect
    import numpy as np

    def f(shape=(3, 4), lo=0.3, hi=0.9, seed=0):
        return T(_sweep_rng(seed).uniform(lo, hi, shape).astype(np.float32))

    def i(shape=(3,), hi=3, seed=1, dtype=np.int64):
        return T(_sweep_rng(seed).integers(0, hi, shape).astype(dtype))

    def rngf(shape, lo=-1.0, hi=1.0, seed=9):
        return _sweep_rng(seed).uniform(lo, hi, shape).astype(np.float32)

    def spd(n=3, seed=5):
        a = _sweep_rng(seed).standard_normal((n, n)).astype(np.float32)
        return a @ a.T + n * np.eye(n, dtype=np.float32)

    def sq(n=3, seed=6):
        a = _sweep_rng(seed).uniform(0.1, 0.9, (n, n)).astype(np.float32)
        return T(a + n * np.eye(n, dtype=np.float32))

    def chol():
        return T(np.linalg.cholesky(spd()))

    def unpool(shape, pool):
        out, idx = pool(f(shape), 2, stride=2, return_mask=True)
        return (out, idx, 2), {}

    i32 = np.int32
    custom = {
        "acosh": lambda: ((f(lo=1.2, hi=2.5),), {}),
        "bitwise_and": lambda: ((i((3, 4), 7, dtype=i32),
                                 i((3, 4), 7, 8, dtype=i32)), {}),
        "bitwise_or": lambda: ((i((3, 4), 7, dtype=i32),
                                i((3, 4), 7, 8, dtype=i32)), {}),
        "bitwise_xor": lambda: ((i((3, 4), 7, dtype=i32),
                                 i((3, 4), 7, 8, dtype=i32)), {}),
        "bitwise_not": lambda: ((i((3, 4), 7, dtype=i32),), {}),
        "bitwise_left_shift": lambda: ((i((3, 4), 7, dtype=i32),
                                        i((3, 4), 3, 8, dtype=i32)), {}),
        "bitwise_right_shift": lambda: ((i((3, 4), 63, dtype=i32),
                                         i((3, 4), 3, 8, dtype=i32)), {}),
        "bincount": lambda: ((i((10,), 5),), {}),
        "gather_tree": lambda: ((i((4, 2, 3), 9), i((4, 2, 3), 2)), {}),
        "sparse_attention": lambda: (
            (f((1, 2, 4, 8)), f((1, 2, 4, 8), seed=2), f((1, 2, 4, 8), seed=3),
             T(np.tile(np.arange(0, 17, 4, dtype=i32), (1, 2, 1))),
             T(np.tile(np.tile(np.arange(4, dtype=i32), 4), (1, 2, 1)))), {}),
        "gcd": lambda: ((i((4,), 12, dtype=i32), i((4,), 12, 8, dtype=i32)),
                        {}),
        "lcm": lambda: ((i((4,), 6, dtype=i32), i((4,), 6, 8, dtype=i32)),
                        {}),
        "matmul": lambda: ((f((3, 4)), f((4, 5), seed=2)), {}),
        "bmm": lambda: ((f((2, 3, 4)), f((2, 4, 5), seed=2)), {}),
        "mv": lambda: ((f((3, 4)), f((4,), seed=2)), {}),
        "addmm": lambda: ((f((3, 5)), f((3, 4), seed=2), f((4, 5), seed=3)),
                          {}),
        "linear": lambda: ((f((3, 4)), f((4, 5), seed=2)), {}),
        "multi_dot": lambda: (([f((3, 4)), f((4, 5), seed=2),
                                f((5, 2), seed=3)],), {}),
        "matrix_power": lambda: ((sq(), 2), {}),
        "einsum": lambda: (("ij,jk->ik", f((3, 4)), f((4, 5), seed=2)), {}),
        "bilinear": lambda: ((f((3, 4)), f((3, 5), seed=2),
                              f((6, 4, 5), seed=3)), {}),
        "dot": lambda: ((f((4,)), f((4,), seed=2)), {}),
        "outer": lambda: ((f((3,)), f((4,), seed=2)), {}),
        "cross": lambda: ((f((3, 3)), f((3, 3), seed=2)), {}),
        "cholesky": lambda: ((T(spd()),), {}),
        "cholesky_inverse": lambda: ((chol(),), {}),
        "cholesky_solve": lambda: ((f((3, 2)), chol()), {}),
        "det": lambda: ((sq(),), {}),
        "slogdet": lambda: ((sq(),), {}),
        "inv": lambda: ((sq(),), {}),
        "inverse": lambda: ((sq(),), {}),
        "eig": lambda: ((sq(),), {}),
        "eigvals": lambda: ((sq(),), {}),
        "eigh": lambda: ((T(spd()),), {}),
        "eigvalsh": lambda: ((T(spd()),), {}),
        "solve": lambda: ((sq(), f((3, 2), seed=2)), {}),
        "triangular_solve": lambda: ((chol(), f((3, 2), seed=2)),
                                     {"upper": False}),
        "lstsq": lambda: ((f((5, 3)), f((5, 2), seed=2)), {}),
        "svd": lambda: ((f((4, 3)),), {}),
        "qr": lambda: ((f((4, 3)),), {}),
        "lu": lambda: ((sq(),), {}),
        "pinv": lambda: ((f((4, 3)),), {}),
        "pca_lowrank": lambda: ((f((6, 4)),), {"q": 2}),
        "matrix_rank": lambda: ((sq(),), {}),
        "transpose": lambda: ((f((3, 4)), [1, 0]), {}),
        "flip": lambda: ((f((3, 4)), [0]), {}),
        "moveaxis": lambda: ((f((3, 4)), [0], [1]), {}),
        "roll": lambda: ((f((3, 4)), 1), {}),
        "split": lambda: ((f((4, 4)), 2), {}),
        "chunk": lambda: ((f((4, 4)), 2), {}),
        "vsplit": lambda: ((f((4, 4)), 2), {}),
        "hsplit": lambda: ((f((4, 4)), 2), {}),
        "dsplit": lambda: ((f((2, 3, 4)), 2), {}),
        "tensor_split": lambda: ((f((4, 4)), 2), {}),
        "unflatten": lambda: ((f((3, 4)), 1, [2, 2]), {}),
        "unsqueeze_": lambda: ((f((3, 4)), 0), {}),
        "topk": lambda: ((f((3, 4)), 2), {}),
        "kthvalue": lambda: ((f((3, 4)), 2), {}),
        "one_hot": lambda: ((i((4,), 3), 3), {}),
        "slice": lambda: ((f((3, 4)), [0], [0], [2]), {}),
        "strided_slice": lambda: ((f((3, 4)), [0], [0], [3], [1]), {}),
        "crop": lambda: ((f((3, 4)), [2, 2], [0, 1]), {}),
        "pad": lambda: ((f((3, 4)), [1, 1]), {}),
        "zeropad2d": lambda: ((f((2, 3, 4, 4)), [1, 1, 1, 1]), {}),
        "increment": lambda: ((f((1,)),), {}),
        "repeat_interleave": lambda: ((f((3, 4)), 2), {}),
        "tril_indices": lambda: ((3, 3, 0), {}),
        "triu_indices": lambda: ((3, 3, 0), {}),
        "full": lambda: (([3, 4], 1.5), {}),
        "full_like": lambda: ((f((3, 4)), 1.5), {}),
        "linspace": lambda: ((0.0, 1.0, 5), {}),
        "logspace": lambda: ((0.0, 2.0, 5), {}),
        "quantile": lambda: ((f((3, 4)), 0.5), {}),
        "nanquantile": lambda: ((f((3, 4)), 0.5), {}),
        "index_add": lambda: ((f((3, 4)), i((2,), 3), 0, f((2, 4), seed=2)),
                              {}),
        "index_put": lambda: ((f((3, 4)), (i((2,), 3),), f((2, 4), seed=2)),
                              {}),
        "gather_nd": lambda: ((f((3, 4)), i((2, 1), 3)), {}),
        "scatter_nd": lambda: ((i((2, 1), 3), f((2, 4), seed=2), [3, 4]),
                               {}),
        "scatter_nd_add": lambda: ((f((3, 4)), i((2, 1), 3),
                                    f((2, 4), seed=2)), {}),
        "take_along_axis": lambda: ((f((3, 4)), i((3, 2), 4, seed=4), 1),
                                    {}),
        "put_along_axis": lambda: ((f((3, 4)), i((3, 1), 4),
                                    f((3, 1), seed=2), 1), {}),
        "mse_loss": lambda: ((f((3, 4)), f((3, 4), seed=2)), {}),
        "l1_loss": lambda: ((f((3, 4)), f((3, 4), seed=2)), {}),
        "smooth_l1_loss": lambda: ((f((3, 4)), f((3, 4), seed=2)), {}),
        "log_loss": lambda: ((f((3, 1), lo=0.1, hi=0.9),
                              f((3, 1), lo=0.1, hi=0.9, seed=2)), {}),
        "kl_div": lambda: ((f((3, 4)), f((3, 4), seed=2)), {}),
        "binary_cross_entropy": lambda: ((f((3, 4), lo=0.1, hi=0.9),
                                          f((3, 4), seed=2)), {}),
        "binary_cross_entropy_with_logits": lambda: (
            (f((3, 4)), f((3, 4), seed=2)), {}),
        "hinge_embedding_loss": lambda: ((f((3, 4)), T(np.sign(
            rngf((3, 4))).astype(np.float32))), {}),
        "margin_ranking_loss": lambda: ((f((3,)), f((3,), seed=2),
                                         T(np.ones(3, np.float32))), {}),
        "soft_margin_loss": lambda: ((f((3, 4)), T(np.sign(
            rngf((3, 4))).astype(np.float32))), {}),
        "multi_label_soft_margin_loss": lambda: (
            (f((3, 4)), i((3, 4), 2, dtype=np.float32)), {}),
        "sigmoid_focal_loss": lambda: ((f((3, 4)),
                                        i((3, 4), 2, dtype=np.float32)), {}),
        "poisson_nll_loss": lambda: ((f((3, 4)), f((3, 4), seed=2)), {}),
        "dice_loss": lambda: ((f((3, 4)), i((3, 1), 4)), {}),
        "square_error_cost": lambda: ((f((3, 4)), f((3, 4), seed=2)), {}),
        "ctc_loss": lambda: (
            (T(np.log(rngf((6, 2, 5), 0.05, 0.95, seed=3))),
             i((2, 3), 4, seed=4), T(np.asarray([6, 6], np.int64)),
             T(np.asarray([3, 2], np.int64))), {}),
        "rnnt_loss": lambda: (
            (T(rngf((1, 3, 3, 4), -1.0, 1.0, seed=5)), i((1, 2), 3, seed=6),
             T(np.asarray([3], np.int64)), T(np.asarray([2], np.int64))), {}),
        "cross_entropy": lambda: ((f((3, 5)), i((3,), 5)), {}),
        "nll_loss": lambda: ((T(np.log(rngf((3, 5), 0.1, 0.9))),
                              i((3,), 5)), {}),
        "batch_norm": lambda: ((f((2, 3, 4, 4)), T(np.zeros(3, np.float32)),
                                T(np.ones(3, np.float32))), {}),
        "layer_norm": lambda: ((f((2, 3, 4)), [4]), {}),
        "group_norm": lambda: ((f((2, 4, 3, 3)), 2), {}),
        "local_response_norm": lambda: ((f((2, 3, 4, 4)), 3), {}),
        "prelu": lambda: ((f((2, 3, 4)), T(np.full(3, 0.25, np.float32))),
                          {}),
        "maxout": lambda: ((f((2, 4, 3, 3)), 2), {}),
        "gumbel_softmax": lambda: ((f((3, 4)),), {}),
        "channel_shuffle": lambda: ((f((2, 4, 3, 3)), 2), {}),
        "pixel_shuffle": lambda: ((f((2, 4, 3, 3)), 2), {}),
        "pixel_unshuffle": lambda: ((f((2, 1, 4, 4)), 2), {}),
        "affine_grid": lambda: ((f((2, 2, 3)), [2, 3, 4, 4]), {}),
        "grid_sample": lambda: ((f((2, 3, 4, 4)),
                                 T(rngf((2, 4, 4, 2), -0.9, 0.9))), {}),
        "fold": lambda: ((f((2, 12, 4)), [4, 4], [2, 2]),
                         {"strides": [2, 2]}),
        "unfold": lambda: ((f((2, 3, 6, 6)), [2, 2]), {}),
        "flash_attention": lambda: ((f((2, 8, 2, 4)), f((2, 8, 2, 4), seed=2),
                                     f((2, 8, 2, 4), seed=3)), {}),
        "scaled_dot_product_attention": lambda: (
            (f((2, 8, 2, 4)), f((2, 8, 2, 4), seed=2),
             f((2, 8, 2, 4), seed=3)), {}),
        "flash_attn_unpadded": lambda: (
            (T(rngf((8, 2, 4), 0.3, 0.9, seed=1)),
             T(rngf((8, 2, 4), 0.3, 0.9, seed=2)),
             T(rngf((8, 2, 4), 0.3, 0.9, seed=3)),
             T(np.asarray([0, 4, 8], i32)), T(np.asarray([0, 4, 8], i32)),
             4, 4, 0.5), {}),
        "adaptive_avg_pool1d": lambda: ((f((2, 3, 8)), 4), {}),
        "adaptive_avg_pool2d": lambda: ((f((2, 3, 8, 8)), [4, 4]), {}),
        "adaptive_avg_pool3d": lambda: ((f((2, 3, 4, 4, 4)), [2, 2, 2]), {}),
        "adaptive_max_pool1d": lambda: ((f((2, 3, 8)), 4), {}),
        "adaptive_max_pool2d": lambda: ((f((2, 3, 8, 8)), [4, 4]), {}),
        "adaptive_max_pool3d": lambda: ((f((2, 3, 4, 4, 4)), [2, 2, 2]), {}),
        "avg_pool1d": lambda: ((f((2, 3, 8)), 2), {}),
        "avg_pool2d": lambda: ((f((2, 3, 8, 8)), 2), {}),
        "avg_pool3d": lambda: ((f((2, 3, 4, 4, 4)), 2), {}),
        "max_pool1d": lambda: ((f((2, 3, 8)), 2), {}),
        "max_pool2d": lambda: ((f((2, 3, 8, 8)), 2), {}),
        "max_pool3d": lambda: ((f((2, 3, 4, 4, 4)), 2), {}),
        "max_unpool1d": lambda: unpool((2, 3, 8), F.max_pool1d),
        "max_unpool2d": lambda: unpool((2, 3, 8, 8), F.max_pool2d),
        "max_unpool3d": lambda: unpool((2, 3, 4, 4, 4), F.max_pool3d),
        "conv1d": lambda: ((f((2, 3, 8)), f((4, 3, 3), seed=2)), {}),
        "conv2d": lambda: ((f((2, 3, 8, 8)), f((4, 3, 3, 3), seed=2)), {}),
        "conv3d": lambda: ((f((1, 2, 4, 4, 4)), f((3, 2, 2, 2, 2), seed=2)),
                           {}),
        "conv1d_transpose": lambda: ((f((2, 3, 8)), f((3, 4, 3), seed=2)),
                                     {}),
        "conv2d_transpose": lambda: ((f((2, 3, 8, 8)),
                                      f((3, 4, 3, 3), seed=2)), {}),
        "conv3d_transpose": lambda: ((f((1, 2, 4, 4, 4)),
                                      f((2, 3, 2, 2, 2), seed=2)), {}),
    }
    if card and op in ("flash_attention", "scaled_dot_product_attention"):
        return (f((2, 8, 2, 64)), f((2, 8, 2, 64), seed=2),
                f((2, 8, 2, 64), seed=3)), {}
    if op in custom:
        return custom[op]()
    args, seed = [], 0
    for name, param in inspect.signature(fn).parameters.items():
        if param.default is not inspect.Parameter.empty:
            break
        if param.kind in (param.VAR_POSITIONAL, param.VAR_KEYWORD):
            break
        if name in _SWEEP_INT_NAMES:
            args.append(T(_sweep_rng(seed).integers(0, 3, (3,)).astype(
                np.int64)))
        elif name == "shape":
            args.append([3, 4])
        elif name in ("num_rows", "n", "num"):
            args.append(3)
        elif name == "dtype":
            args.append("float32")
        elif name in ("inputs", "tensors", "xs"):
            args.append([f(seed=seed), f(seed=seed + 7)])
        else:  # default: a float tensor
            args.append(f(seed=seed))
        seed += 11
    return tuple(args), {}


def _sweep_flat(out, torch):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        flat = []
        for o in out:
            flat.extend(_sweep_flat(o, torch))
        return flat
    return []


def _sweep_signed(op, out, s):
    k, k2, axis = SWEEP_SIGNED[op]
    out = list(out)
    out[k] = out[k] * s.to(out[k].device)
    if k2 is not None:
        s2 = s.to(out[k2].device)
        out[k2] = out[k2] * (s2[:, None] if axis == -2 else s2)
    return tuple(out)


def _sweep_fn(pt, op):
    fn = getattr(pt._C_ops, op)
    if op == "linear":
        # the port's linear takes torch's [out, in] weight; the sweep's
        # inputs are the reference's [in, out]
        return lambda x, w, b=None, name=None: fn(x, w.mT, b)
    return fn


def sweep_case(torch, pt, op, device, signs=None):
    """One registry op at the sweep's inputs on ``device`` (float32):
    its outputs on the host and, unless the op is a draw or in
    ``SWEEP_NO_GRAD``, the gradients of its summed float outputs with
    respect to its float tensor inputs.  ``signs`` (from another run)
    aligns free eigen/singular vector signs."""
    from paddle_tpu_torch.ops.registry import registry_by_name, resolve
    pt.set_device("cpu" if device == "cpu" else "gpu")   # creation ops
    fn = _sweep_fn(pt, op)
    args, kw = sweep_inputs(
        op, resolve(registry_by_name()[op]),
        lambda a: pt.to_tensor(a, place=device), pt.nn.functional,
        card=True)
    args = list(args)
    grad = not (op in SWEEP_BITS or op in SWEEP_ULPS or op in SWEEP_LAW
                or op in SWEEP_NO_GRAD)
    idx = [k for k, a in enumerate(args) if isinstance(a, torch.Tensor)
           and a.is_floating_point()] if grad else []
    for k in idx:
        args[k].stop_gradient = False
    pt.seed(1234)
    out = fn(*args, **kw)
    if op in SWEEP_SIGNED and signs is not None:
        out = _sweep_signed(op, out, signs)
    outs = _sweep_flat(out, torch)
    host = [o.detach().cpu() for o in outs]
    if not outs:
        host = [out]
    grads = None
    fl = [o for o in outs if o.is_floating_point() and o.requires_grad]
    if idx and fl:
        loss = fl[0].float().sum()
        for o in fl[1:]:
            loss = loss + o.float().sum()
        loss.backward()
        grads = [None if args[k].grad is None else
                 args[k].grad.detach().cpu() for k in idx]
    return host, grads


def _sweep_signs(torch, op, want, got):
    k = SWEEP_SIGNED[op][0]
    dots = (want[k].double() * got[k].double()).sum(-2)
    return torch.where(dots < 0, -1.0, 1.0).float()


def _sweep_close(torch, op, what, got, want, rel, floor=0.0):
    """Equal dtypes; floats within ``rel`` of max(largest, floor), the
    rest exact.  Returns the error over that scale."""
    if not isinstance(want, torch.Tensor):
        if want != got:
            raise AssertionError(f"8c (e) {op} {what}: {got} != {want}")
        return 0.0
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"8c (e) {op} {what}: {got.dtype} "
                             f"{tuple(got.shape)} vs {want.dtype} "
                             f"{tuple(want.shape)}")
    if not (want.is_floating_point() or want.is_complex()):
        if not torch.equal(got, want):
            raise AssertionError(f"8c (e) {op} {what}: not equal")
        return 0.0
    w, g = want.to(torch.complex64 if want.is_complex() else torch.float32), \
        got.to(torch.complex64 if want.is_complex() else torch.float32)
    fin = torch.isfinite(w)
    if not torch.equal(fin, torch.isfinite(g)):
        raise AssertionError(f"8c (e) {op} {what}: non-finite entries differ")
    if not bool(fin.any()):
        return 0.0
    scale = max(float(w[fin].abs().max()), floor, 1e-30)
    err = float((g[fin] - w[fin]).abs().max()) / scale
    if err > rel:
        raise AssertionError(f"8c (e) {op} {what}: card vs CPU {err:.3g} of "
                             f"the largest entry (limit {rel:.3g})")
    return err


def _tensor_api_sweep(torch, pt):
    """(e): every registry op the port resolves (the CPU sweep's cases),
    card against CPU in float32, forward and gradient; threefry draws
    bit-equal.  Returns (ops run, worst error, ops with a gradient)."""
    from paddle_tpu_torch.ops.registry import registry_by_name
    ops = sorted(op for op in registry_by_name() if op not in SWEEP_SKIP)
    worst, n_grad = 0.0, 0
    walls = []
    for op in ops:
        t_op = time.perf_counter()
        cpu_out, cpu_g = sweep_case(torch, pt, op, "cpu")
        signs = None
        if op in SWEEP_SIGNED:
            probe, _ = sweep_case(torch, pt, op, "cuda")
            signs = _sweep_signs(torch, op, cpu_out, probe)
        gpu_out, gpu_g = sweep_case(torch, pt, op, "cuda", signs)
        if len(cpu_out) != len(gpu_out):
            raise AssertionError(f"8c (e) {op}: {len(gpu_out)} outputs on "
                                 f"the card, {len(cpu_out)} on the CPU")
        for k, (g, w) in enumerate(zip(gpu_out, cpu_out)):
            if op in SWEEP_LAW:
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(f"8c (e) {op}: law draw's shape or "
                                         f"dtype differs")
                continue
            if op in ("eig", "eigvals") and k == 0:
                g = torch.sort(torch.view_as_real(g.to(torch.complex64)),
                               dim=0).values if g.is_complex() else \
                    torch.sort(g).values
                w = torch.sort(torch.view_as_real(w.to(torch.complex64)),
                               dim=0).values if w.is_complex() else \
                    torch.sort(w).values
            elif op == "eig":
                continue        # vectors: their eigenvalue order is free
            rel = 0.0 if op in SWEEP_BITS else TENSOR_API_SWEEP_REL
            worst = max(worst, _sweep_close(torch, op, f"output {k}", g, w,
                                            rel))
        if cpu_g is not None:
            n_grad += 1
            for k, (g, w) in enumerate(zip(gpu_g, cpu_g)):
                if g is None or w is None:
                    other = w if g is None else g
                    if other is not None and bool(other.abs().max() > 0):
                        raise AssertionError(f"8c (e) {op}: a gradient on "
                                             f"one device only")
                    continue
                worst = max(worst, _sweep_close(
                    torch, op, f"grad {k}", g, w, TENSOR_API_SWEEP_REL,
                    floor=1.0))
        walls.append((time.perf_counter() - t_op, op))
    slow = ", ".join(f"{op} {w * 1e3:.0f}" for w, op in sorted(walls)[-6:])
    return len(ops), worst, n_grad, slow


def tensor_api_grads(pt, model, xh, dev):
    """8c (d)'s one run of ``model`` on ``dev`` (``"cpu"`` or ``"gpu"``):
    ``[loss, each weight's gradient, the input's gradient]`` of one
    forward and backward on the host tensor ``xh``."""
    pt.set_device(dev)          # the rotary tables' device
    x = pt.to_tensor(xh, place=dev, stop_gradient=False)
    loss = model.loss(model.forward(x))
    loss.backward()
    return [loss] + [p.grad for p in model.parameters()] + [x.grad]


def hold_by_own_largest(torch, tag, got, want, rel):
    """Assert each card tensor of ``got`` within ``rel`` of its CPU twin
    in ``want``, scaled by that twin's own largest entry (``max|g - w| /
    max|w|``, tensor by tensor: a gradient of 1e-5 is held at 1e-5
    ``rel``, not at an absolute ``rel``); returns the worst ratio and the
    index of its tensor."""
    worst, at = 0.0, None
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().float().cpu()
        w = w.detach().float().cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{tag}: tensor {i} is {tuple(g.shape)} "
                                 f"and finite {bool(torch.isfinite(g).all())}"
                                 f" on the card, {tuple(w.shape)} on the CPU")
        diff = float((g - w).abs().max())
        scale = float(w.abs().max())
        if scale > 0:
            err = diff / scale
        else:
            err = 0.0 if diff == 0 else float("inf")
        if err > rel:
            raise AssertionError(f"{tag}: tensor {i} card vs CPU {err:.3g} "
                                 f"of its largest entry {scale:.3g} (limit "
                                 f"{rel:.3g})")
        if at is None or err > worst:
            worst, at = err, i
    return worst, at


def _host_us_per_op(torch, pt, forward, x, n_ops, reps=3):
    """Host wall of enqueuing one ``forward(x)`` (no sync inside), least
    of ``reps``, per facade op of (b)'s forward."""
    walls = []
    with pt.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(x)
            walls.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
    return min(walls) / n_ops * 1e6


def _raw_torch_forward(torch, model):
    """8c (f)'s floor: ``model``'s forward written with raw torch calls
    and the kernel wrappers (``ops.rms_norm.rms_norm``,
    ``ops.flash_attention.flash_attention``) over the same weights, op
    for op: no facade function and no dispatcher."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention
    from paddle_tpu_torch.ops.rms_norm import rms_norm
    T = torch.Tensor
    layers = [{k: v.detach().as_subclass(T) for k, v in layer.items()}
              for layer in model.layers]
    norm = model.norm.detach().as_subclass(T)
    nh, nkv, d, eps = model.heads, model.kv_heads, model.d, model.eps
    half = d // 2

    def rope(x, cos, sin):
        xf = x.float()
        rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
        return torch.add(xf * cos, rot * sin).to(x.dtype)

    def forward(x):
        b, s = x.shape[0], x.shape[1]
        f32 = dict(dtype=torch.float32, device=x.device)
        inv = 1.0 / (model.base ** (torch.arange(0, d, 2, **f32) / float(d)))
        pos = torch.arange(s, **f32)
        freqs = torch.matmul(pos.reshape(s, 1), inv.reshape(1, half))
        emb = torch.cat([freqs, freqs], dim=-1)
        tab = torch.stack([torch.cos(emb), torch.sin(emb)])
        cos, sin = tab[0].reshape(1, s, 1, d), tab[1].reshape(1, s, 1, d)
        for L in layers:
            h = rms_norm(x, L["ln1"], eps)
            q = torch.matmul(h, L["wq"]).reshape(b, s, nh, d)
            k = torch.matmul(h, L["wk"]).reshape(b, s, nkv, d)
            v = torch.matmul(h, L["wv"]).reshape(b, s, nkv, d)
            q, k = rope(q, cos, sin), rope(k, cos, sin)
            a = flash_attention(q, k, v, causal=True).reshape(b, s, nh * d)
            x = torch.add(x, torch.matmul(a, L["wo"].permute(1, 0)))
            h = rms_norm(x, L["ln2"], eps)
            gate, up = torch.split(torch.matmul(h, L["w_gate_up"]),
                                   L["w_down"].shape[0], dim=-1)
            sig = 1.0 / (1.0 + torch.exp(-gate))
            x = torch.add(x, torch.matmul(torch.mul(gate * sig, up),
                                          L["w_down"]))
        return rms_norm(x, norm, eps)

    return forward


def _plain_copy(torch, model):
    """The same decoder over plain ``torch.Tensor`` views of its weights
    (the facade's functions then run on torch's rules and return plain
    tensors)."""
    import copy
    plain = copy.copy(model)
    plain.layers = [{k: v.detach().as_subclass(torch.Tensor)
                     for k, v in layer.items()} for layer in model.layers]
    plain.norm = model.norm.detach().as_subclass(torch.Tensor)
    plain.tables = lambda s: tuple(t.as_subclass(torch.Tensor)
                                   for t in model.tables(s))
    return plain


def phase_tensor_api(torch, seed, smi):
    """Phase 8c (see the module docstring); returns the launches of the
    main path ((a)-(c): the forwards and backwards)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.runtime import HostTracer
    c = TENSOR_API
    nl, b, s = c["layers"], c["batch"], c["seq"]
    per_fwd = {"rms_norm": 2 * nl + 1, "flash_attention_fwd": nl}
    total = {}
    t_phase = time.perf_counter()
    prev_dev = tdevice._layer_device
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pt.set_device("gpu")
        # (a) weights drawn on the card by the facade's ``normal``
        pt.seed(seed + 40)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = _tensor_decoder(pt, nl, "bfloat16")
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        params = model.parameters()
        n_params = sum(p.numel() for p in params)
        card = tdevice.resolve_device()
        if not all(p.device == card and p.dtype == torch.bfloat16
                   and p.is_leaf and not p.stop_gradient for p in params):
            raise AssertionError("8c (a): a weight is not a bf16 leaf on "
                                 "the card that needs a gradient")
        h0 = (pt.randn([b, s, c["hidden"]]) * 0.5).astype("bfloat16")
        h0.stop_gradient = False
        _log(f"tensor api 8c (a) weights: {n_params / 1e6:.1f} M parameters "
             f"({n_params * 2 / 1e9:.3f} GB bf16) drawn on the card by "
             f"pt.normal (threefry) in {draw_s:.2f} s")
        # (b) forward
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss(model.forward(h0))
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        counts = _launch_counts()
        _add_launches(total, counts)
        if counts != per_fwd:
            raise AssertionError(f"8c (b) forward launches {counts}, want "
                                 f"{per_fwd}")
        if not bool(pt.isfinite(loss)):
            raise AssertionError("8c (b) loss not finite")
        reps = 3
        _zero_launches()
        warm_ms = _wall_ms(torch, lambda: model.loss(model.forward(h0)),
                           n=reps)
        counts = _launch_counts()
        _add_launches(total, counts)
        if counts != {k_: v_ * reps for k_, v_ in per_fwd.items()}:
            raise AssertionError(f"8c (b) {reps} forwards launched {counts}")
        _log(f"tensor api 8c (b) forward B={b} S={s} bf16 ({nl} layers at "
             f"Llama-3-8B width): {warm_ms:.3f} ms (least of {reps} synced "
             f"walls; the first {fwd_ms:.3f}), loss "
             f"{float(loss.detach()):.6g}, launches a forward {per_fwd}; "
             f"{smi}")
        # (c) backward
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        bwd_ms = (time.perf_counter() - t0) * 1e3
        counts = _launch_counts()
        _add_launches(total, counts)
        want_bwd = {"flash_attention_bwd": nl}
        if counts != want_bwd:
            raise AssertionError(f"8c (c) backward launches {counts}, want "
                                 f"{want_bwd}")
        first = [p.grad.float().clone() for p in params]
        if not all(bool(torch.isfinite(g).all()) for g in first):
            raise AssertionError("8c (c) a weight's gradient is not finite")
        h0_grad = h0.grad.float().clone()
        # a second backward after a new forward accumulates (its wall is
        # the warm backward's)
        _zero_launches()
        loss1 = model.loss(model.forward(h0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss1.backward()
        torch.cuda.synchronize()
        warm_bwd_ms = (time.perf_counter() - t0) * 1e3
        _add_launches(total, _launch_counts())
        acc = 0.0
        for p, g1 in zip(params, first):
            scale = float(g1.abs().max()) * 2 or 1.0
            acc = max(acc, float((p.grad.float() - 2 * g1).abs().max())
                      / scale)
        if acc > TENSOR_API_REPEAT_REL:
            raise AssertionError(f"8c (c) two backwards {acc:.3g} of twice "
                                 f"one (limit {TENSOR_API_REPEAT_REL:.3g})")
        # paddle.grad against the .grad route
        _zero_launches()
        loss2 = model.loss(model.forward(h0))
        (gh,) = pt.grad(loss2, [h0])
        _add_launches(total, _launch_counts())
        g_err = float((gh.float() - h0_grad).abs().max()) / max(
            float(h0_grad.abs().max()), 1e-30)
        if g_err > TENSOR_API_REPEAT_REL:
            raise AssertionError(f"8c (c) grad(loss, [h0]) {g_err:.3g} from "
                                 f"the .grad route")
        _log(f"tensor api 8c (c) backward: {warm_bwd_ms:.3f} ms (a synced "
             f"wall; the first {bwd_ms:.3f}), flash backward {nl} launches, "
             f"every weight's .grad "
             f"finite; a second backward accumulates to twice the first "
             f"within {acc:.3g} of the largest (limit "
             f"{TENSOR_API_REPEAT_REL:.3g}: the one-pass dQ's run-to-run "
             f"order); pt.grad(loss, [h0]) equals the .grad route within "
             f"{g_err:.3g}; {smi}")
        # the PyLayer's gradients against autograd through the same ops
        SwiGLU = type(model).SwiGLU
        g32 = pt.randn([4, 64])
        u32 = pt.randn([4, 64])
        ga, ua = g32.clone(), u32.clone()
        for t in (g32, u32, ga, ua):
            t.stop_gradient = False
        w = pt.randn([4, 64])
        (SwiGLU.apply(g32, u32) * w).sum().backward()
        ((ga * (1.0 / (1.0 + pt.exp(-ga)))) * ua * w).sum().backward()
        pl = max(float((g32.grad - ga.grad).abs().max()),
                 float((u32.grad - ua.grad).abs().max()))
        if pl > 1e-5:
            raise AssertionError(f"8c (c) PyLayer gradients {pl:.3g} from "
                                 f"autograd")
        # (f) the facade's host cost (before the small phases free memory)
        HostTracer.clear()
        HostTracer.enable()
        with pt.no_grad():
            model.forward(h0)
        HostTracer.disable()
        n_ops = sum(1 for e in HostTracer.events()
                    if e[0] == 0 and e[5].startswith("op::"))
        HostTracer.clear()
        plain = _plain_copy(torch, model)
        raw = _raw_torch_forward(torch, model)
        x_plain = h0.detach().as_subclass(torch.Tensor)
        runs = {}
        for tag, fwd, x in (("facade", model.forward, h0.detach()),
                            ("plain", plain.forward, x_plain),
                            ("raw", raw, x_plain)):
            _zero_launches()
            with pt.no_grad():
                out = fwd(x)
            runs[tag] = (out, _launch_counts())
        facade_launch = runs["facade"][1]
        f_out = runs["facade"][0].float()
        raw_err = float((runs["raw"][0].float() - f_out).abs().max()) / \
            float(f_out.abs().max())
        if any(type(runs[t][0]) is not torch.Tensor for t in ("plain", "raw"))\
                or any(runs[t][1] != facade_launch for t in runs) \
                or raw_err > TENSOR_API_REPEAT_REL:
            raise AssertionError(
                f"8c (f): results {[type(r[0]) for r in runs.values()]}, "
                f"launches {[r[1] for r in runs.values()]}, raw vs facade "
                f"{raw_err:.3g} of the largest")
        us = {tag: _host_us_per_op(torch, pt, fwd, x, n_ops)
              for tag, fwd, x in (("facade", model.forward, h0.detach()),
                                  ("plain", plain.forward, x_plain),
                                  ("raw", raw, x_plain))}
        _log(f"tensor api 8c (f) host cost: (b)'s forward runs {n_ops} "
             f"facade ops; host time to enqueue it {us['facade']:.1f} us an "
             f"op on facade tensors, {us['plain']:.1f} us on plain tensors "
             f"through the same facade functions (as_subclass(torch.Tensor)),"
             f" {us['raw']:.1f} us written with raw torch calls and the "
             f"kernel wrappers (output within {raw_err:.3g} of the facade's "
             f"largest entry); launches equal {facade_launch}; {smi}")
        del model, plain, raw, runs, out, f_out
        del params, first, loss, loss1, loss2, gh
        torch.cuda.empty_cache()
        # (d) card against CPU: 1 layer in float32; the host decoder
        # holds weights drawn on the card (threefry on the host's cores
        # would take tens of seconds at this width), and the card's
        # decoder is carried from it by to_tensor(place=)
        pt.seed(seed + 41)
        drawn = tensor_decoder_class(pt)(
            c["hidden"], c["heads"], c["kv_heads"], c["ffn"],
            c["cpu_layers"], c["eps"], c["rope_base"], "float32", c["std"])
        host = copy_decoder_to(pt, drawn, "cpu")
        del drawn
        xh = pt.randn([c["cpu_batch"], c["cpu_seq"], c["hidden"]]).cpu()
        card = copy_decoder_to(pt, host, "gpu")
        want = tensor_api_grads(pt, host, xh, "cpu")
        got = tensor_api_grads(pt, card, xh, "gpu")
        d_err, d_at = hold_by_own_largest(torch, "8c (d)", got, want,
                                          TENSOR_API_REL)
        _log(f"tensor api 8c (d) card vs CPU, 1 layer float32 (TF32 off) "
             f"B={c['cpu_batch']} S={c['cpu_seq']}, weights carried by "
             f"to_tensor(place=): the loss and each of the "
             f"{len(want) - 1} gradients within {d_err:.3g} of its own "
             f"largest entry (max |card - CPU| / max |CPU|, worst: tensor "
             f"{d_at}; limit {TENSOR_API_REL}); gradients' largest "
             f"entries {min(float(w.abs().max()) for w in want[1:]):.3g} "
             f"to {max(float(w.abs().max()) for w in want[1:]):.3g}")
        del host, card, want, got
        torch.cuda.empty_cache()
        # (e) the registry sweep, card against CPU
        t0 = time.perf_counter()
        n_ops_swept, worst, n_grad, slow = _tensor_api_sweep(torch, pt)
        sweep_s = time.perf_counter() - t0
        _log(f"tensor api 8c (e) op sweep: {n_ops_swept} registry ops at the "
             f"CPU sweep's inputs (the two flash ops at head_dim 64, which "
             f"the kernels take), float32 (TF32 off), card vs CPU, forward "
             f"and ({n_grad} ops) the gradient: worst {worst:.3g} of the "
             f"largest entry (limit {TENSOR_API_SWEEP_REL}); threefry draws "
             f"bit-equal; {sweep_s:.2f} s (the slowest ops, ms on both "
             f"devices: {slow})")
    finally:
        tdevice._layer_device = prev_dev
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not all(total.get(k_) for k_ in ("rms_norm", "flash_attention_fwd",
                                        "flash_attention_bwd")):
        raise AssertionError(f"phase 8c: a kernel never launched {total}")
    _log(f"tensor api 8c: {time.perf_counter() - t_phase:.1f} s")
    return total


def copy_decoder_to(pt, model, place):
    """A copy of a ``tensor_decoder_class`` model with every weight
    carried to ``place`` by ``to_tensor`` (a leaf that needs a
    gradient)."""
    import copy
    out = copy.copy(model)
    out.layers = [{k: pt.to_tensor(v, place=place, stop_gradient=False)
                   for k, v in layer.items()} for layer in model.layers]
    out.norm = pt.to_tensor(model.norm, place=place, stop_gradient=False)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-window", action="store_true",
                    help="measure the decode attention kernels alone and "
                         "in the serving step (phase_decode_window), then "
                         "stop without a result line")
    ap.add_argument("--quant-window", action="store_true",
                    help="measure the quantized matmul and the int8 decode "
                         "alone and in the quantized serving step "
                         "(phase_quant_window), then stop without a result "
                         "line")
    ap.add_argument("--norm-window", action="store_true",
                    help="measure RoPE and RMSNorm alone, in a train step "
                         "and in the serving decode step "
                         "(phase_norm_window), then stop without a result "
                         "line")
    ap.add_argument("--facade-window", action="store_true",
                    help="measure the host cost of nn.functional's tensor "
                         "ops on plain tensors and in ERNIE's step "
                         "(phase_facade_window), then stop without a "
                         "result line")
    ap.add_argument("--root", help="import paddle_tpu_torch from this tree "
                                   "instead of the checkout (with a "
                                   "--*-window: measure another commit)")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this smoke needs one "
              "GPU", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import paddle_tpu_torch ({e}); run it "
              f"from the root of the repository", file=sys.stderr)
        return 2
    smi = phase_env(torch)
    if args.decode_window:
        phase_decode_window(torch, args.seed)
        return 0
    if args.quant_window:
        phase_quant_window(torch, args.seed)
        return 0
    if args.norm_window:
        phase_norm_window(torch, args.seed)
        return 0
    if args.facade_window:
        phase_facade_window(torch, args.seed)
        return 0
    t_start = time.perf_counter()

    def mark(tag):
        _log(f"[{time.perf_counter() - t_start:.1f} s] {tag} done")

    rows = phase_kernels(torch, args.seed)
    mark("phase 2")
    gpt_rows = phase_gpt_kernels(torch, args.seed)
    mark("phase 2, GPT geometries")
    phase_sampler(torch, args.seed)
    cfg, model = _build_8b(torch, 32, "bfloat16", args.seed)
    phase_graphs(torch, args.seed, cfg, model)
    phase_sampled_graph(torch, args.seed, cfg, model)
    mark("phases 2's sampler, 3a")
    serving, greedy_prof, serve_tokens = phase_serving(torch, args.seed,
                                                       cfg, model)
    by_path = {"serving": serving}
    mark("phase 3")
    by_path.update(phase_quant_serving(torch, args.seed, cfg, model))
    mark("phase 3b")
    by_path["speculative"] = phase_spec_serving(torch, args.seed, cfg, model)
    mark("phase 3c")
    by_path["preemption"] = phase_preemption(torch, args.seed, cfg, model)
    by_path["radix"] = phase_radix_tier(torch, args.seed, cfg, model)
    mark("phases 3d, 3e")
    by_path["sampling"] = phase_sampled_serving(torch, args.seed, cfg, model,
                                                greedy_prof)
    mark("phase 3f")
    by_path["observability"] = phase_observability(torch, args.seed, cfg,
                                                   model, serve_tokens)
    mark("phase 3g")
    by_path["dense_programs"] = phase_dense_programs(torch, args.seed, cfg,
                                                     model)
    mark("phase 3h")
    by_path["fleet"] = phase_fleet(torch, args.seed, cfg, model,
                                   serve_tokens)
    mark("phase 3i")
    by_path["lora"] = phase_lora(torch, args.seed, cfg, model, serve_tokens)
    mark("phase 3j")
    by_path["quantization"] = phase_quantization(torch, args.seed, cfg,
                                                 model)
    del model
    torch.cuda.empty_cache()
    mark("phase 3l")
    by_path.update(phase_gpt_serving(torch, args.seed))
    mark("phase 3k (GPT-3 13B)")
    phase_exactness(torch, args.seed)
    mark("phase 4")
    phase_quant_exactness(torch, args.seed)
    mark("phase 4b")
    phase_spec_exactness(torch, args.seed)
    mark("phase 4c")
    phase_preempt_exactness(torch, args.seed)
    mark("phase 4d")
    phase_observability_exactness(torch, args.seed)
    mark("phase 3g (f)")
    phase_sampled_exactness(torch, args.seed)
    mark("phase 4f")
    phase_dense_exactness(torch, args.seed)
    mark("phase 4h")
    by_path["lora_exactness"] = phase_lora_exactness(torch, args.seed)
    mark("phase 4j")
    phase_gpt_exactness(torch, args.seed)
    mark("phase 4k")
    by_path["quantization_exactness"] = phase_quant_exactness_layers(
        torch, args.seed)
    mark("phase 4l")
    by_path["training"] = phase_training(torch, args.seed, smi)
    cpu_full = phase_train_exactness(torch, args.seed)
    mark("phases 5, 6")
    by_path["training_routes"] = phase_training_routes(torch, args.seed,
                                                       smi)
    phase_train_exactness_routes(torch, args.seed)
    mark("phases 5b, 6b")
    by_path["training_policies"] = phase_training_policies(torch, args.seed,
                                                           smi)
    mark("phase 5c")
    by_path["eager_amp"] = phase_eager_amp(torch, args.seed, smi)
    mark("phase 5d")
    phase_train_exactness_policies(torch, args.seed, cpu_full)
    mark("phase 6c")
    by_path["gpt_training"] = phase_gpt_training(torch, args.seed, smi)
    by_path["ernie"] = phase_ernie_finetune(torch, args.seed, smi)
    phase_zoo_train_exactness(torch, args.seed)
    mark("phases 5k, 5e, 6k")
    by_path["vision"] = phase_vision_training(torch, args.seed, smi)
    mark("phase 7a")
    by_path["ocr"] = phase_ocr_inference(torch, args.seed, smi)
    _add_launches(by_path["ocr"], phase_ocr_training(torch, args.seed,
                                                     smi))
    mark("phases 7b, 7c")
    vision_exact, ocr_exact = phase_vision_exactness(torch, args.seed)
    _add_launches(by_path["vision"], vision_exact)
    _add_launches(by_path["ocr"], ocr_exact)
    for path in ("vision", "ocr"):
        if any(by_path[path].values()):
            raise AssertionError(f"{path}: port kernels launched "
                                 f"{by_path[path]}")
    mark("phase 7d")
    by_path["hapi"] = phase_hapi(torch, args.seed, smi)
    if any(by_path["hapi"].values()):
        raise AssertionError(f"hapi: port kernels launched "
                             f"{by_path['hapi']}")
    mark("phase 7e")
    by_path["functional"] = phase_vision_ops(torch, args.seed)
    if not by_path["functional"]["rms_norm"]:
        raise AssertionError("functional: F.rms_norm launched no kernel")
    mark("phase 7f")
    by_path["jit"] = phase_jit(torch, args.seed, smi)
    mark("phase 8a")
    by_path["nn_api"] = phase_nn_api(torch, args.seed, smi)
    mark("phase 8b")
    by_path["tensor_api"] = phase_tensor_api(torch, args.seed, smi)
    mark("phase 8c")
    # the case of each kernel's row: bf16 on its main path's shape
    # (RMSNorm: one serving decode step; the quantized matmul: int8, one
    # decode step's gate/up projection, M=8 K=4096 N=14336)
    main_case = {"rms_norm": 0, "paged_decode_attention": 0,
                 "paged_decode_attention_int8": 0,
                 "quantized_matmul": QMM_SHAPES.index((8, 4096, 14336)),
                 "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                 "rope": 0, "paged_decode_attention_multi": 0,
                 "paged_decode_attention_multi_int8": 0,
                 "decode_attention": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0, "fused_adamw": 0}
    meta = {"rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                         "paddle_tpu/ops/pallas/rms_norm.py:63"),
            "paged_decode_attention": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/decode_attention.py:492"),
            "paged_decode_attention_int8": (
                "paddle_tpu_torch/csrc/paged_decode_attention_int8.cu",
                "paddle_tpu/ops/pallas/decode_attention.py:583"),
            "quantized_matmul": (
                "paddle_tpu_torch/csrc/quantized_matmul.cu",
                "paddle_tpu/ops/pallas/quantized_matmul.py:175"),
            "flash_attention_fwd": (
                "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                "paddle_tpu/ops/pallas/flash_attention.py:161"),
            "flash_attention_bwd": (
                "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                "paddle_tpu/ops/pallas/flash_attention.py:292"),
            "rope": ("paddle_tpu_torch/csrc/rope.cu",
                     "paddle_tpu/ops/pallas/rope.py:41"),
            "paged_decode_attention_multi": (
                "paddle_tpu_torch/csrc/paged_decode_attention_multi.cu",
                "paddle_tpu/ops/pallas/decode_attention.py:692"),
            "paged_decode_attention_multi_int8": (
                "paddle_tpu_torch/csrc/paged_decode_attention_multi.cu",
                "paddle_tpu/ops/pallas/decode_attention.py:787"),
            "decode_attention": (
                "paddle_tpu_torch/csrc/decode_attention.cu",
                "paddle_tpu/ops/pallas/decode_attention.py:398"),
            "flash_attention_bwd_dq": (
                "paddle_tpu_torch/csrc/flash_attention_bwd_twopass.cu",
                "paddle_tpu/ops/pallas/flash_attention.py:212"),
            "flash_attention_bwd_dkv": (
                "paddle_tpu_torch/csrc/flash_attention_bwd_twopass.cu",
                "paddle_tpu/ops/pallas/flash_attention.py:248"),
            "fused_adamw": (
                "paddle_tpu_torch/csrc/fused_adamw.cu",
                "paddle_tpu/ops/pallas/fused_optimizer.py:71")}
    kernels = []
    for name, (source, replaces) in meta.items():
        c = rows[name][main_case[name]]
        per_path = {path: counts.get(name, 0)
                    for path, counts in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"], "dtype": c["dtype"],
            **{k: c[k] for k in ("wrapper_ms", "host_us") if k in c},
            **({"gpt_geometry": [
                {k: g[k] for k in ("shape", "dtype", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "max_abs_err")}
                for g in gpt_rows[name]]} if gpt_rows.get(name) else {})})
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
