#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --decode-window [--root TREE]
    python3 chip_smoke.py --quant-window [--root TREE]
    python3 chip_smoke.py --norm-window [--root TREE]

The second form measures only the decode attention kernels, alone and
in the serving step (``phase_decode_window``), the third the quantized
matmul and the int8 decode, alone and in the quantized serving step
(``phase_quant_window``), the fourth RoPE and RMSNorm, alone, in a train
step and in the serving decode step (``phase_norm_window``), of this
checkout or of the port in another tree (a parent commit unpacked beside
it); none prints a result line.

Phases, each of which raises (nonzero exit, no result line) on failure:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the build of every CUDA kernel of the port from
   ``paddle_tpu_torch/csrc/`` (one nvcc per source, all in parallel);
2. each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (serving: paged decode over a float and an
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
   take (``bound_ms``);
3a. the decode block as a CUDA graph at full Llama-3-8B width (32
   layers, bfloat16, random weights from ``--seed``): the engine's
   captured program against the eager ``paged_decode_block`` at B=8
   (every slot live at a ragged length) for 1 and 2 scanned steps, in
   bf16 and with an int8 KV cache and int8 weights, on the same inputs
   and copies of the same arenas: tokens, carries and arenas bit-equal,
   and one replay counting exactly the launches of one eager block;
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
   peak memory, and a decode window's unprofiled wall, device busy time
   and idle share (the union of the device intervals against the
   window's wall); the first default run also runs 8 steady-state decode
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
   one profiled speculative step;
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
4. exactness: a 4-layer float32 model at the same width serves a mixed
   trace through a 2-slot engine, and every request must be token-exact
   against the same trace through the lockstep arm and against the same
   request alone on a fresh 1-slot engine; then the same with an int8 KV
   cache and int8 weights;
4b. quantized card-vs-CPU agreement: a 2-layer float32 model at the same
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
6. training exactness: a 2-layer float32 model at the same width takes 2
   train steps on the card and, from the same state dict, on the CPU
   (plain versions); losses and parameters agree within stated bounds;
6b. the same under the routes of 5b, with Adam (the unfused update) and
   then AdamW under a schedule (the fused kernel on the card, its plain
   version on the CPU).

The line before the last is a JSON object of per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
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


def _decode_case(torch, dtype, gen, rng):
    """B=8 rows, Hkv=8, G=4, D=128, L=16, 128-block tables: ragged lens
    up to 2047 (a full table), mid-block frontiers, trash-padded
    tables and a random (finite) trash row.  Each row of the B=8 launch
    must be bit-equal to the same row launched alone and beside an
    all-trash row (a vacant slot; lens far past its table).  Timed with
    the L2 flushed by a read, beside the host time of one call."""
    import numpy as np
    from paddle_tpu_torch.ops import decode_attention as da
    b, hkv, g, d, blk_len, mb = 8, 8, 4, 128, 16, 128
    lens = np.array([2047, 1500, 1023, 700, 383, 100, 17, 0], np.int32)
    tables, need, nb = _paged_tables(np, rng, lens, blk_len, mb)
    dt = getattr(torch, dtype)
    shape = da.paged_arena_shape(nb + 1, hkv, blk_len, d)
    ka = torch.randn(shape, generator=gen, device="cuda").to(dt)
    va = torch.randn(shape, generator=gen, device="cuda").to(dt)
    q = torch.randn(b, hkv * g, d, generator=gen, device="cuda").to(dt)
    tb = torch.from_numpy(tables).cuda()
    ln = torch.from_numpy(lens).cuda()
    name = f"paged_decode_attention {dtype}"
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


def _decode_int8_case(torch, dtype, gen, rng):
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
    b, hkv, g, d, blk_len, mb = 8, 8, 4, 128, 16, 128
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
    name = f"paged_decode_attention_int8 {dtype}"
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


def _multi_case(torch, dtype, gen, rng, int8):
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
    b, cq, hkv, g, d, blk_len, mb = 8, SPEC["k"] + 1, 8, 4, 128, 16, 128
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
    name = "paged_decode_attention_multi" + ("_int8" if int8 else "")
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


def _dense_case(torch, dtype, gen):
    """The dense decode attention of the draft model's ``generate()``:
    B=1, the 8B head geometry, S = max_context + max_draft of phase 3c's
    drafter (516, not a multiple of the kernel's 16-slot chunk), lens at
    the last decode step's frontier; the same row at B=3 (beside a row at
    lens 0 and one past S) must give the same bits; a launch with lens
    past S (clamped) and an odd S, against the plain version."""
    from paddle_tpu_torch.ops import decode_attention as da
    hkv, g, d = 8, 4, 128
    s = SPEC["max_context"] + SPEC["k"]
    dt = getattr(torch, dtype)
    shape = da.cache_shape(3, hkv, s, d)
    kc3 = torch.randn(shape, generator=gen, device="cuda").to(dt)
    vc3 = torch.randn(shape, generator=gen, device="cuda").to(dt)
    q3 = torch.randn(3, hkv * g, d, generator=gen, device="cuda").to(dt)
    kc, vc, q = kc3[1:2].contiguous(), vc3[1:2].contiguous(), q3[1:2]
    ln = torch.tensor([s - 2], dtype=torch.int32, device="cuda")
    name = f"decode_attention {dtype}"
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


def _qmm_case(torch, dtype, bits, m, k, n, gen):
    """The quantized matmul on x [M, K] and codes of a random [K, N]
    weight (std 0.02) quantized per output channel by the serving rule.
    ``bound_ms`` uses the peak of x's dtype (bf16: the tensor cores the
    kernel runs on; float32: the CUDA cores).  ``library_ms`` is one
    ``torch.matmul`` in x's dtype on the pre-dequantized weight: the GEMM
    of the same shape, not the same function (it streams 2 or 4 bytes per
    weight, not 1 or 1/2).  Every timed call finds the L2 cold and clean
    (``_read_flush``), as a decode step finds each layer's weights."""
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
    got = qm.quantized_matmul(x, codes, scales, bits=bits)
    want = qm.quantized_matmul_plain(x, codes, scales, bits=bits)
    torch.cuda.synchronize()
    tag = f"M={m} K={k} N={n} int{bits}"
    err = _check(torch, f"quantized_matmul {tag} {dtype}", got, want, dtype,
                 tol=QMM_TOL[dtype])
    item = x.element_size()
    nbytes = m * k * item + codes.numel() + 4 * n + m * n * item
    ops = 2.0 * m * k * n
    bound_ms, by = _bound(nbytes, ops, dtype)
    scratch, flush = _read_flush(torch)
    ms = _time_ms(torch, lambda: qm.quantized_matmul(x, codes, scales,
                                                     bits=bits), flush)
    plain_ms = _time_ms(torch, lambda: qm.quantized_matmul_plain(
        x, codes, scales, bits=bits), flush, warmup=2, iters=10)
    wd = qm.dequant_view(codes, scales, bits, dt)
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
    y = rp._rope(x, cos, sin, 1.0)
    gx = rp._rope(g, cos, sin, -1.0)
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
    ms = _time_ms(torch, lambda: rp._rope(x, cos, sin, 1.0))
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


def _serve_trace(torch, eng, cfg, seed):
    """The serving trace of phases 3 and 3b, from ``seed``: 7 requests of
    64-512 prompt tokens, then (once the first has finished its prefill)
    an 8th sharing its 256-token prefix (16 full blocks).  The launch
    counters are set to 0 just before and read just after.  Every request
    must finish with in-vocabulary tokens and the prefix must hit.
    Returns (launches, stats, wall seconds, requests, tokens, rng, the
    Request objects)."""
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
    _finished_in_vocab(reqs, [m for _, m in specs], cfg.vocab_size,
                       "serving")
    if st["prefix_hits"] <= 0:
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
    the unprofiled wall and the device busy time of a decode step, the
    device's idle share (1 - the union of its kernel intervals over the
    window's wall), the forced syncs by reason, the overlap seconds, the
    decode graphs and peak memory.  The first depth-1 run also runs the
    sync-debug window.  Returns the launch counts of the first depth-1
    run (the engine's defaults)."""
    from paddle_tpu_torch.inference import ServingEngine
    nl = cfg.num_hidden_layers
    tokens, first, main_launches = None, None, None
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
        prof = _profile_decode(torch, eng, rng, cfg.vocab_size)
        if ai == 1 and main_launches is None:
            main_launches = launches
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
    return main_launches


def _sync_debug_window(torch, eng, rng, vocab, steps=8):
    """No hidden host sync on the steady-state path: 8 fresh requests
    fill the slots and decode until every harvest defers, then ``steps``
    decode steps run under ``torch.cuda.set_sync_debug_mode("error")``
    (a ``.item()``, ``.cpu()``, pageable copy or boolean-mask index
    raises there; the harvest's wait on its event is not such a sync).
    Every step must defer its harvest, with no forced sync."""
    reqs = [eng.submit(rng.integers(0, vocab, 64).astype("int32"),
                       max_new_tokens=2 * steps + 8)
            for _ in range(eng.num_slots)]
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
    _log(f"sync-debug window: {steps} steady-state depth-1 decode steps "
         f"under set_sync_debug_mode('error'): no hidden sync, every "
         f"harvest deferred")


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
SPEC_TRACE = [(64, 32), (128, 40), (200, 24), (256, 48), (300, 16),
              (96, 36), (384, 28), (150, 44)]
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


def _profile_kernels(torch, prof):
    """A profile's CUDA kernels: ``{name: us}`` summed, and ``{name:
    launches}``."""
    per_kernel, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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
             f"peak memory {peak / 2 ** 30:.2f} GiB; launches {launches}")
        _profile_verify(torch, eng, rng, cfg.vocab_size)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        del eng
    del other
    torch.cuda.empty_cache()
    return total


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


def _union_us(torch, prof):
    """The union of the profile's device intervals (kernels and copies),
    in us, and the span from the first start to the last end."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
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


def _profile_decode(torch, eng, rng, vocab, steps=8):
    """Where a decode step's time goes: 8 fresh 64-token requests fill
    the slots; once all are prefilled, ``steps`` decode steps run
    unprofiled (host wall) and ``steps`` more under ``torch.profiler``
    (device busy time = sum of CUDA kernel durations, the union of the
    device intervals against the window's wall, and the kernels that
    take most of it).  Budgets keep every slot decoding through both
    windows.  A step is one scanned decode step: at ``async_depth`` >= 2
    one ``step()`` may dispatch a fused window of several, so the windows
    are divided by the decode steps they ran.  Returns ``{"wall_ms",
    "busy_ms", "union_ms", "idle"}`` per decode step, or None when the
    profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile
    depth = getattr(eng, "async_depth", 1)
    reqs = [eng.submit(rng.integers(0, vocab, 64).astype("int32"),
                       max_new_tokens=eng.num_slots + 2 * steps * depth + 4)
            for _ in range(eng.num_slots)]
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
            "idle": 1 - union / (wall_prof * 1e3)}


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
    call in those decode steps.  With ``--root`` the package comes from
    another tree (a parent commit unpacked beside this checkout), so one
    script measures two trees, in turns within one call."""
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
    for shape, what in COPY_FLOORS:
        _copy_floor(torch, shape, gen, what)
    b, s, nl = TRAIN["batch"], TRAIN["seq"], TRAIN["layers"]
    cfg, model, opt, step = _train_setup(torch, nl, "bfloat16", seed)
    tokens, labels = _train_batch(torch, cfg, b, s, seed, "cuda")
    step(tokens, labels)
    _profile_train_step(torch, step, tokens, labels)
    del step, opt, model
    torch.cuda.empty_cache()
    cfg, model = _build_8b(torch, 32, "bfloat16", seed)
    kw = dict(num_slots=8, prompt_len=512, chunk_len=256, max_cache_len=1024,
              block_len=16, compute_dtype="bfloat16")
    _profile_decode(torch, ServingEngine(model, **kw), rng, cfg.vocab_size)
    us, calls = _decode_rms_host(torch, ServingEngine(model, **kw), rng,
                                 cfg.vocab_size)
    _log("norm window: decode step: rms_norm host " + (
        "not measured (the decode block replays a CUDA graph, which calls "
        "no wrapper)" if us is None else
        f"{us:.2f} us a call, {calls:.0f} calls a step"))


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
                    kv_dtype=None):
    """Logits of ``model`` over paged arenas (int8 unless ``kv_dtype``
    says otherwise) under the weight context ``wq``: the prompt as one
    chunk, then one decode step per token of ``forced``.  Returns
    [1 + len(forced), vocab] float32 on the CPU."""
    from paddle_tpu_torch.models.generation import init_paged_kv_arena
    from paddle_tpu_torch.models.wquant import wquant_context
    nl, hkv, d = model.kv_cache_spec()
    n = len(prompt)
    mb = -(-(n + len(forced)) // block_len)
    tables = torch.arange(mb, dtype=torch.int32, device=device)[None, :]
    kvs = [tuple(e) + (tables,) for e in init_paged_kv_arena(
        nl, mb, block_len, hkv, d, kv_dtype or torch.int8, device)]
    rows = []
    with torch.no_grad(), wquant_context(wq):
        lg, kvs = model.prefill_chunk(
            torch.from_numpy(prompt[None, :]).to(device), 0, n, kvs)
        rows.append(lg[0].float().cpu())
        for t, tok in enumerate(forced):
            lg, kvs = model.decode_step(
                torch.tensor([int(tok)], dtype=torch.int32, device=device),
                torch.tensor([n + t], dtype=torch.int32, device=device), kvs)
            rows.append(lg[0].float().cpu())
    return torch.stack(rows)


def phase_quant_exactness(torch, seed):
    """Phase 4b: a 2-layer float32 model at 8B width with an int8 KV cache
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
    cfg, gpu = _build_8b(torch, 2, "float32", seed + 3)
    cpu = LlamaForCausalLM(cfg, device="cpu", init=False)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    kw = dict(prompt_len=64, chunk_len=32, max_cache_len=128, block_len=16,
              compute_dtype="float32", kv_cache_dtype="int8",
              weight_dtype="int4", num_slots=2)
    rng = np.random.default_rng(seed + 3)
    trace = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for n, m in [(40, 12), (17, 8)]]
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
    _log(f"quant exactness: 2 layers at 8B width, float32, int8 KV + int4 "
         f"weights: plans bit-identical; teacher-forced logits max |diff| "
         f"{diff.max().item():.3g} over {len(diff)} steps (last step "
         f"{diff[-1].item():.3g}; bound {QUANT_LOGIT_ATOL}); tokens equal "
         f"through step {upto} of {len(margin)} (smallest CPU margin "
         f"{margin.min():.3g}); whole requests equal {same}; card "
         f"{t_gpu:.2f} s, CPU {t_cpu:.2f} s; launches {launches}")
    del geng, ceng, gpu, cpu
    torch.cuda.empty_cache()


def _train_setup(torch, layers, dtype, seed, device=None, make_opt=None,
                 **step_kw):
    """``examples/llama_pretrain.py``'s model, criterion, optimizer and
    TrainStep at the full 1.1B width (``layers`` deep), parameters
    random from ``seed`` on the card (or built on ``device``).  The
    optimizer is the example's AdamW (fp32 moments, global-norm clip
    1.0) unless ``make_opt(parameters)`` makes another."""
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
    if make_opt is None:
        opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True)
    else:
        opt = make_opt(model.parameters())
    step = TrainStep(model, lambda net, t, l: crit(net(t), l), opt,
                     **step_kw)
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
                          accumulate_steps=1):
    """Phase 6: 2 float32 train steps of a 2-layer model at 1.1B width,
    batch 1 x 256, on the card (kernels) and on the CPU (plain versions)
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
    the card, those in ``not_launched`` must not."""
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
        cfg, gpu, _, gstep = _train_setup(torch, 2, "float32", seed + 2,
                                          **kw)
        _, cpu, _, cstep = _train_setup(torch, 2, "float32", seed + 2,
                                        "cpu", **kw)
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        tokens, labels = _train_batch(torch, cfg, 1, 256, seed + 2, "cpu")
        for k in KERNELS.values():
            k.launches = 0
        gl, cl = [], []
        t0 = time.perf_counter()
        for _ in range(n_steps):
            gl.append(float(gstep(tokens, labels)))
            if scheds and scheds[0] is not None:
                scheds[0].step()
        launches = {name: k.launches for name, k in KERNELS.items()}
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_steps):
            cl.append(float(cstep(tokens, labels)))
            if scheds and scheds[1] is not None:
                scheds[1].step()
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
    rel = max(abs(g - c) / abs(c) for g, c in zip(gl, cl))
    if rel > 1e-6:
        raise AssertionError(f"{label}: card losses {gl} vs CPU "
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
            f"{label}: parameters differ by up to {worst:.3g} "
            f"(bound {lr:.3g}), {n_bad} of {n_all} elements past 1e-4")
    _log(f"{label}: 2 layers at 1.1B width, float32, batch 1x256, "
         f"{n_steps} calls, accumulate_steps={accumulate_steps}: losses card {gl} CPU {cl} (max rel diff "
         f"{rel:.3g}); parameters max |diff| {worst:.3g}, {n_bad} of "
         f"{n_all} elements past 1e-4; card {t_gpu:.2f} s, CPU "
         f"{t_cpu:.2f} s; launches {launches}")
    del gpu, cpu, gstep, cstep
    torch.cuda.empty_cache()


def phase_train_exactness_routes(torch, seed):
    """Phase 6b: phase 6 under the flag-selected routes (two-pass flash
    backward, fused AdamW), first with Adam (coupled decay: the unfused
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
                          ("flash_attention_bwd", "fused_adamw"))
    phase_train_exactness(torch, seed, "train exactness routes, AdamW + "
                          "schedule + merge", adamw, ROUTE_FLAGS,
                          twopass + ("fused_adamw",),
                          ("flash_attention_bwd",), accumulate_steps=2)


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
    rows = phase_kernels(torch, args.seed)
    cfg, model = _build_8b(torch, 32, "bfloat16", args.seed)
    phase_graphs(torch, args.seed, cfg, model)
    by_path = {"serving": phase_serving(torch, args.seed, cfg, model)}
    by_path.update(phase_quant_serving(torch, args.seed, cfg, model))
    by_path["speculative"] = phase_spec_serving(torch, args.seed, cfg, model)
    by_path["preemption"] = phase_preemption(torch, args.seed, cfg, model)
    by_path["radix"] = phase_radix_tier(torch, args.seed, cfg, model)
    del model
    torch.cuda.empty_cache()
    phase_exactness(torch, args.seed)
    phase_quant_exactness(torch, args.seed)
    phase_spec_exactness(torch, args.seed)
    phase_preempt_exactness(torch, args.seed)
    by_path["training"] = phase_training(torch, args.seed, smi)
    phase_train_exactness(torch, args.seed)
    by_path["training_routes"] = phase_training_routes(torch, args.seed,
                                                       smi)
    phase_train_exactness_routes(torch, args.seed)
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
        per_path = {path: counts[name] for path, counts in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"], "dtype": c["dtype"],
            **{k: c[k] for k in ("wrapper_ms", "host_us") if k in c}})
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
