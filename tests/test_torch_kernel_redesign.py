"""The contracts that the port's K-wide verify kernel (split-K over the
block walk, ``csrc/paged_decode_attention_multi.cu``) and its one-pass
flash backward (``csrc/flash_attention_bwd.cu``, the GQA group summed in
the kernel) rest on, held on the CPU.

- The verify kernel's split plan is a function of ``max_blocks`` and the
  block length alone, so a row's split boundaries, and so its output
  bits, do not depend on the batch or the verify width it rides in.
- Split-K merged as the kernel merges it (per split: running max,
  denominator, unnormalized accumulator; splits wholly past a query's
  frontier skipped) is the plain verify attention: float32, ``atol
  1e-5`` (fp32 sums in another order).
- The one-pass backward's plain core returns dK and dV per KV head, the
  group summed in the compute dtype, as the bfloat16 kernel writes them;
  in bfloat16 its gradients agree with ``jax.grad`` through the
  interpret-mode ``_onepass_bwd_kernel`` within one bf16 ulp (``rtol
  2**-7``) plus ``2**-6`` of the gradient's largest entry (both sides
  round P and dS to bf16 at the same places, from fp32 scores summed in
  different orders; the reference sums the GQA group's dK, dV in bf16
  where the port sums in fp32).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bf16_np(a):
    """float32 numpy values rounded to bf16 (exactly representable)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# ---- the verify kernel's split plan ----

@pytest.mark.parametrize("max_blocks,blk_len", [
    (128, 16), (8, 16), (33, 16), (5, 48), (200, 1), (7, 256)])
def test_verify_split_plan_depends_on_table_and_block_length_only(
        max_blocks, blk_len):
    bps, n_splits = tda.verify_split_plan(max_blocks, blk_len)
    assert bps == max(1, 128 // blk_len)
    assert (n_splits - 1) * bps < max_blocks <= n_splits * bps
    for b in (1, 8):
        for cq in (1, 5):
            acc, ml = tda.verify_partials(b, cq, 2, 4, 32, max_blocks,
                                          blk_len, "cpu")
            assert acc.shape == (b, 2, n_splits, cq * 4, 32)
            assert ml.shape == (b, 2, n_splits, cq * 4, 2)
            assert acc.dtype == ml.dtype == torch.float32


def _split_merge(q, k_arena, v_arena, tables, lens):
    """The split kernel and the merge in plain float32 torch: each split
    of the plan walks its run of the row's table, keeps (max, denominator,
    unnormalized accumulator) per query row, and the merge weights the
    row's splits by exp(m_s - max m), skipping splits that saw no slot of
    the row.  Returns (out [B, C, Hq, D], number of skipped (row, split)
    pairs)."""
    b, cq, hq, d = q.shape
    blk_len, mb = k_arena.shape[1], tables.shape[1]
    hkv = k_arena[0, 0].numel() // d
    g = hq // hkv
    bps, _ = tda.verify_split_plan(mb, blk_len)
    out = torch.empty_like(q)
    skipped = 0
    for bi in range(b):
        last = int(lens[bi]) + cq - 1
        nblk = min(last // blk_len + 1, mb)
        ns = -(-nblk // bps)
        parts = []
        for s in range(ns):
            blocks = tables[bi, s * bps:min((s + 1) * bps, nblk)].long()
            kd = k_arena[blocks].reshape(-1, hkv, d)
            vd = v_arena[blocks].reshape(-1, hkv, d)
            slot = s * bps * blk_len + torch.arange(kd.shape[0])
            qq = q[bi].reshape(cq, hkv, g, d)
            logits = torch.einsum("ckgd,skd->ckgs", qq, kd) / math.sqrt(d)
            front = int(lens[bi]) + torch.arange(cq)
            keep = slot[None, :] <= front[:, None]
            logits = logits.masked_fill(~keep[:, None, None, :],
                                        float("-inf"))
            m = logits.amax(-1)
            p = torch.where(torch.isinf(m)[..., None],
                            torch.zeros_like(logits),
                            torch.exp(logits - m[..., None]))
            parts.append((m, p.sum(-1), torch.einsum("ckgs,skd->ckgd", p,
                                                     vd)))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        num = torch.zeros(cq, hkv, g, d)
        den = torch.zeros(cq, hkv, g)
        for m, l, acc in parts:
            seen = ~torch.isinf(m)
            skipped += int((~seen).sum())
            w = torch.where(seen, torch.exp(m - mx), torch.zeros_like(m))
            num += w[..., None] * acc
            den += w * l
        out[bi] = (num / den[..., None]).reshape(cq, hq, d)
    return out, skipped


@pytest.mark.parametrize("blk_len,lens", [
    (16, [150, 3, 0, 127]), (48, [400, 47, 95, 5]), (4, [70, 31, 32, 0])])
def test_split_merge_is_the_plain_verify_attention(blk_len, lens):
    rng = np.random.default_rng(blk_len)
    b, cq, hkv, g, d = 4, 5, 2, 2, 16
    mb = max(n + cq - 1 for n in lens) // blk_len + 1
    nb = b * mb + 1
    perm = rng.permutation(nb)
    tables = torch.from_numpy(perm[:b * mb].reshape(b, mb).astype(np.int32))
    shape = tda.paged_arena_shape(nb + 1, hkv, blk_len, d)
    k_arena, v_arena = (torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(
        rng.standard_normal((b, cq, hkv * g, d)).astype(np.float32))
    ln = torch.tensor(lens, dtype=torch.int32)
    got, skipped = _split_merge(q, k_arena, v_arena, tables, ln)
    want = tda.decode_attention_paged_multi_plain(q, k_arena, v_arena,
                                                  tables, ln)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    # the rows of a split that starts past their frontier are skipped
    bps, _ = tda.verify_split_plan(mb, blk_len)
    expect = sum(hkv * g * sum(
        1 for c in range(cq) for s in range(-(-min((n + cq - 1) // blk_len
                                                   + 1, mb) // bps))
        if s * bps * blk_len > n + c) for n in lens)
    assert skipped == expect


# ---- the one-pass flash backward ----

@pytest.mark.parametrize("causal,hq,hk", [
    (True, 2, 2), (True, 8, 2), (False, 8, 2), (False, 2, 2)])
def test_onepass_bf16_matches_onepass_kernel(causal, hq, hk):
    """jax.grad of ``flash_attention`` (``flash_onepass_bwd`` on, the
    default) runs ``_onepass_bwd_kernel`` in interpret mode; the port's
    bf16 backward runs the one-pass plain core, which returns dK and dV
    per KV head."""
    rng = np.random.default_rng(41 + hq + hk)
    b, s, d = 1, 256, 64
    q, k, v, c = (_bf16_np(rng.standard_normal(shape).astype(np.float32))
                  for shape in ((b, s, hq, d), (b, s, hk, d), (b, s, hk, d),
                                (b, s, hq, d)))

    def loss(a, b_, c_):
        o = jfa.flash_attention(a, b_, c_, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(c))

    jg = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    cores = []
    real = tfa._bwd_core_onepass
    try:
        def spy(*args):
            out = real(*args)
            cores.append(out)
            return out
        tfa._bwd_core_onepass = spy
        out = tfa.flash_attention(tq, tk, tv, causal=causal)
        (out.float() * torch.from_numpy(c)).sum().backward()
    finally:
        tfa._bwd_core_onepass = real
    (dq, dk, dv), = cores
    assert dq.shape == (b, s, hq, d) and dk.shape == dv.shape == (b, s, hk, d)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2.0 ** -6 * np.abs(want).max(),
                                   rtol=2.0 ** -7)
    assert tfa.KERNEL_BWD.launches == 0
