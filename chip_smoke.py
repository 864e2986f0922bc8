#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (nonzero exit, no result line) on failure:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the build of every CUDA kernel of the port from
   ``paddle_tpu_torch/csrc/`` (one nvcc per source, all in parallel);
2. each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (serving: paged decode, RMSNorm; training:
   flash-attention forward and backward, RoPE forward and backward,
   RMSNorm), bfloat16 and float32, with CUDA-event timings of the kernel,
   the plain version and one PyTorch library call that computes the same
   function where there is one (a yardstick the port never calls),
   beside the least time the card could take (``bound_ms``);
3. serving at full Llama-3-8B width (32 layers, bfloat16, random weights
   from ``--seed``): 8 requests through an 8-slot ``ServingEngine``, two
   of them sharing a 256-token prefix so the prefix cache hits; every
   request must finish with in-vocabulary tokens, and the kernels' launch
   counters must rise by exactly their per-step counts;
4. exactness: a 4-layer float32 model at the same width serves a mixed
   trace through a 2-slot engine, and every request must be token-exact
   against the same request alone on a fresh 1-slot engine;
5. training at the full width of ``examples/llama_pretrain.py`` ("1.1B":
   16 layers, hidden 2048, 32/8 heads, vocab 32000, bfloat16 parameters,
   full recompute): ``TrainStep`` with AdamW (fp32 moments) and
   global-norm clipping, batch 8 x 2048 tokens, 1 warm-up step and 5
   timed steps on the same batch; losses finite and falling, parameters
   finite, launch counters up by exactly their per-step counts; step
   time, tokens/s, MFU and peak memory, then one profiled step;
6. training exactness: a 2-layer float32 model at the same width takes 2
   train steps on the card and, from the same state dict, on the CPU
   (plain versions); losses and parameters agree within stated bounds.

The line before the last is a JSON object of per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
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


def _time_ms(torch, fn, flush=None, warmup=5, iters=25):
    """Median CUDA-event time of ``fn`` in ms over ``iters`` runs after
    ``warmup``; ``flush`` (if given) runs between timed launches, outside
    the events, so the launch finds the L2 cache cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _check(torch, name, got, want, dtype, row_atol=None, rtol=None):
    """Max |got - want|, after asserting every element within ``atol +
    rtol * |want|``: ``TOL[dtype]``, or, where ``row_atol`` is given, an
    atol of ``row_atol`` times the RMS over the last axis of ``want``'s
    row, and ``rtol``.  Logs the largest share of the limit any element
    used."""
    atol, rt = TOL[dtype]
    g, w = got.float(), want.float()
    if row_atol is not None:
        atol, rt = row_atol * w.square().mean(-1, keepdim=True).sqrt(), rtol
        how = f"atol {row_atol:.3g} x row RMS"
    else:
        how = f"atol {atol:.3g}"
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (g - w).abs()
    limit = atol + rt * w.abs()
    bad = err > limit
    if bad.any():
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max |err| {err.max().item():.3g}, {int(bad.sum())} elements "
            f"past {how} rtol {rt:.3g})")
    _log(f"  {name}: max |err| {err.max().item():.3g}, "
         f"{torch.where(err == 0, 0.0, err / limit).max().item():.3f} of "
         f"the limit ({how}, "
         f"rtol {rt:.3g})")
    return err.max().item()


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


def _decode_case(torch, dtype, gen, rng):
    """B=8 rows, Hkv=8, G=4, D=128, L=16, 128-block tables: ragged lens
    up to 2047 (a full table), mid-block frontiers, trash-padded
    tables and a random (finite) trash row."""
    import numpy as np
    from paddle_tpu_torch.ops import decode_attention as da
    b, hkv, g, d, blk_len, mb = 8, 8, 4, 128, 16, 128
    lens = np.array([2047, 1500, 1023, 700, 383, 100, 17, 0], np.int32)
    need = [min(int(n) // blk_len + 1, mb) for n in lens]
    nb = sum(need) + 8
    dt = getattr(torch, dtype)
    perm = rng.permutation(nb)
    tables = np.full((b, mb), nb, np.int32)
    used = 0
    for i, k in enumerate(need):
        tables[i, :k] = perm[used:used + k]
        used += k
    shape = da.paged_arena_shape(nb + 1, hkv, blk_len, d)
    ka = torch.randn(shape, generator=gen, device="cuda").to(dt)
    va = torch.randn(shape, generator=gen, device="cuda").to(dt)
    q = torch.randn(b, hkv * g, d, generator=gen, device="cuda").to(dt)
    tb = torch.from_numpy(tables).cuda()
    ln = torch.from_numpy(lens).cuda()
    got = da.decode_attention_paged(q, ka, va, tb, ln)
    want = da.decode_attention_paged_plain(q, ka, va, tb, ln)
    torch.cuda.synchronize()
    err = _check(torch, f"paged_decode_attention {dtype}", got, want, dtype)
    item = q.element_size()
    slots = int((lens.astype(np.int64) + 1).sum())
    nbytes = (slots * 2 * hkv * d * item          # valid K and V
              + 2 * q.numel() * item              # q in, out
              + sum(need) * 4 + b * 4)            # table entries, lens
    bound_ms, by = _bound(nbytes, 4 * slots * hkv * g * d, dtype)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    ms = _time_ms(torch, lambda: da.decode_attention_paged(q, ka, va, tb, ln),
                  flush)
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
    return dict(shape=f"B={b} Hkv={hkv} G={g} D={d} L={blk_len} "
                      f"max_blocks={mb} lens<={int(lens.max())}",
                dtype=dtype, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                library_max_abs_err=lib_err)


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


def _flash_case(torch, dtype, b, gen):
    """Causal flash attention at the training geometry (S=2048, Hq=32,
    Hkv=8, D=64), forward and backward, each against its plain version
    within FLASH_BF16_TOL in bfloat16 (its reasons are stated there) and
    TOL in float32."""
    from paddle_tpu_torch.ops import flash_attention as fa
    s, hq, hkv, d = TRAIN["seq"], TRAIN["heads"], TRAIN["kv_heads"], \
        TRAIN["head_dim"]
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
    atol, rtol = LSE_TOL
    err_lse = (lse - lse_ref).abs()
    if (err_lse > atol + rtol * lse_ref.abs()).any():
        raise AssertionError(f"flash_attention_fwd LSE {tag}: max |err| "
                             f"{err_lse.max().item():.3g} past atol {atol}")
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
    fwd = dict(shape=shape, dtype=dtype, max_abs_err=max(err_o,
               err_lse.max().item()), ms=fwd_ms, plain_ms=fwd_plain_ms,
               bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms,
               library_max_abs_err=lib_err)
    bwd = dict(shape=shape, dtype=dtype, max_abs_err=err_b, ms=bwd_ms,
               plain_ms=bwd_plain_ms, bound_ms=bb, bound_by=bby,
               library_ms=lib_bwd_ms)
    return fwd, bwd


def _rope_case(torch, dtype, gen):
    """RoPE on q [8, 2048, 32, 64] (the training path's largest call),
    forward and backward (-sin) against the plain version.  Both round
    each fp32 product and sum on its own and cast once, so they agree
    bit for bit (held to TOL all the same)."""
    from paddle_tpu_torch.ops import rope as rp
    b, s, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"], \
        TRAIN["head_dim"]
    dt = getattr(torch, dtype)
    x = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
    g = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
    inv = 1.0 / (500000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                           device="cuda") / d))
    freqs = torch.outer(torch.arange(s, dtype=torch.float32, device="cuda"),
                        inv)
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    y = rp._rope(x, cos, sin, 1.0)
    gx = rp._rope(g, cos, sin, -1.0)
    want_y = rp.apply_rope_plain(x, cos, sin)
    want_gx = rp.apply_rope_plain(g, cos, -sin)
    torch.cuda.synchronize()
    err = max(_check(torch, f"rope fwd {dtype}", y, want_y, dtype),
              _check(torch, f"rope bwd {dtype}", gx, want_gx, dtype))
    item = x.element_size()
    bound_ms, by = _bound(2 * x.numel() * item + 2 * cos.numel() * 4,
                          3 * x.numel(), dtype)
    ms = _time_ms(torch, lambda: rp._rope(x, cos, sin, 1.0))
    plain_ms = _time_ms(torch, lambda: rp.apply_rope_plain(x, cos, sin))
    return dict(shape=f"[{b},{s},{h},{d}]", dtype=dtype, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None)


def phase_kernels(torch, seed):
    import numpy as np
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    rows = {"rms_norm": [], "paged_decode_attention": [],
            "flash_attention_fwd": [], "flash_attention_bwd": [],
            "rope": []}
    for dtype in ("bfloat16", "float32"):
        for n in (8, 256):
            rows["rms_norm"].append(_rms_case(torch, n, dtype, gen))
        rows["paged_decode_attention"].append(
            _decode_case(torch, dtype, gen, rng))
        # flash at the training batch in bf16 (the main path's shape), at
        # B=2 in f32 (the plain backward's fp32 score tensors at B=8 f32
        # would be 4.3 GB each)
        fwd, bwd = _flash_case(torch, dtype,
                               TRAIN["batch"] if dtype == "bfloat16" else 2,
                               gen)
        rows["flash_attention_fwd"].append(fwd)
        rows["flash_attention_bwd"].append(bwd)
        rows["rope"].append(_rope_case(torch, dtype, gen))
    rows["rms_norm"].append(_rms_case(
        torch, TRAIN["batch"] * TRAIN["seq"], "bfloat16", gen,
        d=TRAIN["hidden"]))
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


def phase_serving(torch, seed):
    """Phase 3.  Returns the kernels' launch counts of the run."""
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops import KERNELS
    cfg, model = _build_8b(torch, 32, "bfloat16", seed)
    eng = ServingEngine(model, num_slots=8, prompt_len=512, chunk_len=256,
                        max_cache_len=1024, block_len=16,
                        compute_dtype="bfloat16")
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
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(ids, max_new_tokens=m) for ids, m in first]
    while reqs[0].state in ("queued", "prefill"):
        eng.step()
    reqs.append(eng.submit(second[0], max_new_tokens=second[1]))
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    st = eng.stats()
    specs = first + [second]
    for r, (ids, m) in zip(reqs, specs):
        out = r.output
        if r.state != "finished" or out.shape != (m,):
            raise AssertionError(f"request {r.request_id}: state {r.state}, "
                                 f"{out.shape[0]} tokens of {m}")
        if out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.request_id}: token outside "
                                 f"the vocabulary")
    if st["prefix_hits"] <= 0:
        raise AssertionError(f"the shared prefix did not hit: {st}")
    want = {name: 0 for name in KERNELS}       # training kernels: none
    want.update({"rms_norm": (2 * cfg.num_hidden_layers + 1)
                 * (st["prefill_chunks"] + st["decode_steps"]),
                 "paged_decode_attention": cfg.num_hidden_layers
                 * st["decode_steps"]})
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != expected "
                             f"{want} for {st['prefill_chunks']} chunks and "
                             f"{st['decode_steps']} decode steps")
    n_tok = sum(m for _, m in specs)
    _log(f"serving: {len(specs)} requests, {n_tok} tokens in {wall:.3f} s "
         f"= {n_tok / wall:.2f} tokens/s; mean TTFT "
         f"{st['mean_ttft_s'] * 1e3:.2f} ms; decode step "
         f"{st['decode_seconds'] / st['decode_steps'] * 1e3:.3f} ms over "
         f"{st['decode_steps']} steps; prefill chunks "
         f"{st['prefill_chunks']}; prefix hits {st['prefix_hits']} "
         f"(rate {st['prefix_hit_rate']:.3f}); peak blocks "
         f"{st['peak_blocks_in_use']}; launches {launches}")
    _profile_decode(torch, eng, rng, cfg.vocab_size)
    del eng, model
    torch.cuda.empty_cache()
    return launches


def _profile_decode(torch, eng, rng, vocab, steps=8):
    """Where a decode step's time goes: 8 fresh 64-token requests fill
    the slots; once all are prefilled, ``steps`` decode steps run
    unprofiled (host wall) and ``steps`` more under ``torch.profiler``
    (device busy time = sum of CUDA kernel durations, and the kernels
    that take most of it).  Budgets keep every slot decoding through
    both windows."""
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.submit(rng.integers(0, vocab, 64).astype("int32"),
                       max_new_tokens=eng.num_slots + 2 * steps + 4)
            for _ in range(eng.num_slots)]
    while any(r.state in ("queued", "prefill") for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) / steps
    live = sum(r.state == "decode" for r in reqs)
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
    busy = sum(per_kernel.values()) / 1e3 / steps
    eng.run()
    if live != eng.num_slots:
        raise AssertionError(f"decode profile: {live} of {eng.num_slots} "
                             f"slots still decoding after the windows")
    if not per_kernel:
        _log(f"decode profile: wall {wall * 1e3:.3f} ms/step; device time "
             f"not measured (the profiler recorded no CUDA kernels)")
        return
    _log(f"decode profile: {steps}+{steps} steps x {eng.num_slots} slots: "
         f"wall {wall * 1e3:.3f} ms/step unprofiled, "
         f"{wall_prof * 1e3:.3f} ms/step profiled; device busy "
         f"{busy:.3f} ms/step ({100 * busy / (wall * 1e3):.1f}% of the "
         f"unprofiled wall), {len(per_kernel)} distinct kernels")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        _log(f"  {us / 1e3 / steps:8.3f} ms/step  {name[:90]}")


def phase_exactness(torch, seed):
    import numpy as np
    from paddle_tpu_torch.inference import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = _build_8b(torch, 4, "float32", seed + 1)
    kw = dict(prompt_len=64, chunk_len=32, max_cache_len=128, block_len=16,
              compute_dtype="float32")
    rng = np.random.default_rng(seed + 1)
    specs = [(40, 12), (17, 5), (64, 9), (33, 7), (5, 10)]
    trace = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for n, m in specs]
    eng = ServingEngine(model, num_slots=2, **kw)
    mixed = [eng.submit(ids, max_new_tokens=m) for ids, m in trace]
    eng.run()
    for r, (ids, m) in zip(mixed, trace):
        one = ServingEngine(model, num_slots=1, **kw)
        alone = one.submit(ids, max_new_tokens=m)
        one.run()
        if not np.array_equal(r.output, alone.output):
            raise AssertionError(
                f"request {r.request_id}: mixed 2-slot trace {r.output} != "
                f"alone on a 1-slot engine {alone.output}")
        del one
    _log(f"exactness: {len(trace)} requests token-exact (2-slot mixed "
         f"trace vs 1-slot engines, float32, 4 layers at 8B width)")
    del eng, model
    torch.cuda.empty_cache()


def _train_setup(torch, layers, dtype, seed, device=None):
    """``examples/llama_pretrain.py``'s model, criterion, AdamW and
    TrainStep at the full 1.1B width (``layers`` deep), parameters
    random from ``seed`` on the card (or built on ``device``)."""
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
                      max_position_embeddings=TRAIN["seq"], recompute=True)
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype, seed=seed,
                             init=device is None)
    model.train()
    crit = LlamaPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True)
    step = TrainStep(model, lambda net, t, l: crit(net(t), l), opt)
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
    # launches per train step with full recompute, one launch per tensor
    per_step = {name: 0 for name in KERNELS}
    per_step.update({"flash_attention_fwd": 2 * nl,   # forward + recompute
                     "flash_attention_bwd": nl,
                     "rope": 6 * nl,        # q, k x (fwd, recompute, bwd)
                     "rms_norm": 4 * nl + 1})  # 2/layer x 2, + final norm
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
    of the profiled step) and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tokens, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
    if not per_kernel:
        _log(f"train profile: wall {wall * 1e3:.1f} ms; device time not "
             f"measured (the profiler recorded no CUDA kernels)")
        return
    busy = sum(per_kernel.values()) / 1e3
    _log(f"train profile: 1 step, wall {wall * 1e3:.1f} ms profiled; device "
         f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of the "
         f"wall), {len(per_kernel)} distinct kernels")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        _log(f"  {us / 1e3:9.3f} ms  {100 * us / 1e3 / busy:5.1f}%  "
             f"{name[:90]}")


def phase_train_exactness(torch, seed):
    """Phase 6: 2 float32 train steps of a 2-layer model at 1.1B width,
    batch 1 x 256, on the card (kernels) and on the CPU (plain versions)
    from the same state dict and batch.  Bounds, set with room around
    what the run measures (float32 sums in other orders give a loss
    difference near 1e-7 relative and parameters within about 1e-5):
    losses within rtol 1e-6; parameters: at most 1e-6 of the elements
    past 1e-4, and none past lr (a gradient of the wrong sign puts a
    parameter about 2 lr off after one Adam step)."""
    from paddle_tpu_torch.ops import KERNELS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_steps, lr = 2, 3e-4
    cfg, gpu, _, gstep = _train_setup(torch, 2, "float32", seed + 2)
    _, cpu, _, cstep = _train_setup(torch, 2, "float32", seed + 2, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    tokens, labels = _train_batch(torch, cfg, 1, 256, seed + 2, "cpu")
    for k in KERNELS.values():
        k.launches = 0
    gl, cl = [], []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        gl.append(float(gstep(tokens, labels)))
    launches = {name: k.launches for name, k in KERNELS.items()}
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_steps):
        cl.append(float(cstep(tokens, labels)))
    t_cpu = time.perf_counter() - t0
    for name in ("flash_attention_fwd", "flash_attention_bwd", "rope",
                 "rms_norm"):
        if launches[name] == 0:
            raise AssertionError(f"train exactness: {name} never launched")
    rel = max(abs(g - c) / abs(c) for g, c in zip(gl, cl))
    if rel > 1e-6:
        raise AssertionError(f"train exactness: card losses {gl} vs CPU "
                             f"{cl} (rel {rel:.3g})")
    cparams = dict(cpu.named_parameters())
    worst, n_bad, n_all = 0.0, 0, 0
    for name, p in gpu.named_parameters():
        diff = (p.detach().cpu() - cparams[name].detach()).abs()
        worst = max(worst, diff.max().item())
        n_bad += int((diff > 1e-4).sum())
        n_all += diff.numel()
    if worst > lr or n_bad > 1e-6 * n_all:
        raise AssertionError(
            f"train exactness: parameters differ by up to {worst:.3g} "
            f"(bound {lr:.3g}), {n_bad} of {n_all} elements past 1e-4")
    _log(f"train exactness: 2 layers at 1.1B width, float32, batch 1x256, "
         f"{n_steps} steps: losses card {gl} CPU {cl} (max rel diff "
         f"{rel:.3g}); parameters max |diff| {worst:.3g}, {n_bad} of "
         f"{n_all} elements past 1e-4; card {t_gpu:.2f} s, CPU "
         f"{t_cpu:.2f} s; launches {launches}")
    del gpu, cpu, gstep, cstep
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
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
    rows = phase_kernels(torch, args.seed)
    by_path = {"serving": phase_serving(torch, args.seed)}
    phase_exactness(torch, args.seed)
    by_path["training"] = phase_training(torch, args.seed, smi)
    phase_train_exactness(torch, args.seed)
    # the case of each kernel's row: bf16 on its main path's shape
    # (RMSNorm: one serving decode step)
    main_case = {"rms_norm": 0, "paged_decode_attention": 0,
                 "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                 "rope": 0}
    meta = {"rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                         "paddle_tpu/ops/pallas/rms_norm.py:63"),
            "paged_decode_attention": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/decode_attention.py:492"),
            "flash_attention_fwd": (
                "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                "paddle_tpu/ops/pallas/flash_attention.py:161"),
            "flash_attention_bwd": (
                "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                "paddle_tpu/ops/pallas/flash_attention.py:292"),
            "rope": ("paddle_tpu_torch/csrc/rope.cu",
                     "paddle_tpu/ops/pallas/rope.py:41")}
    kernels = []
    for name, (source, replaces) in meta.items():
        c = rows[name][main_case[name]]
        per_path = {path: counts[name] for path, counts in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"], "dtype": c["dtype"]})
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
