#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpu_docker_api_tpu_torch/).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  0. print the card's name and power limit; build the three flash kernels
     from gpu_docker_api_tpu_torch/csrc with nvcc (sm_90a), all at once;
     the wgmma kernels (bf16 forward, dQ and dK/dV) must compile with no
     spill stores, no serialised wgmma and no ignored setmaxnreg, and each
     kernel library's machine code must hold wgmma and TMA instructions.
  1. hold each kernel against its plain PyTorch version on the same inputs:
     f32 and bf16; causal, full and windowed; GQA groups 1, 2 and 4;
     ragged and odd S; with and without an lse cotangent; bf16 at S=4096,
     causal and with
     a 1024 window (many trips round the kernels' load rings); and at the
     main path's shape, where the bf16 check must also reject every planted
     fault, a second run of each kernel must give the same bits, so must a
     first call on a fresh thread, and each kernel, its plain version and
     the SDPA yardsticks are timed.
  2. the main path: train_llama at the llama 1b config, B=4, S=2048, for a
     few steps, with the launch counters set to 0 just before and read just
     after; losses finite, the first near its value at init; every attention
     call went through the kernels. Then the 1b trunk's logits and loss
     gradients on a small input, through the kernels and through the
     reference attention: in f32 against each other, in bf16 each against
     the f32 run, where every planted fault standing in for its kernel must
     be rejected.
  3. resume: tiny config, 4 steps with checkpoints every 2, a restart, 2
     more steps; the metrics.jsonl step sequence must be 1..6 with no gap.
  4. serving at llama 1b (infer.py, workloads/serve.py; no kernel on this
     path): in f32, prefill and decode steps of the cached path held to
     llama_forward through the forward kernel (teacher forcing: logits
     within F32_TOL, greedy tokens its argmax, n_layers forward launches),
     and again with the int8 KV cache (KV8_TOL); then `python -m
     gpu_docker_api_tpu_torch.workloads.serve --config 1b` in a subprocess,
     driven over HTTP (healthz, greedy tokens equal to in-process
     generate(), top_k=1 greedy, a sampled request, the 400/404
     envelopes, the traceparent echo), killed in every case; then prefill
     and decode times in bf16 at B=1 and B=8, with the int8 KV cache and
     with w8 weights, each beside its bound and the device-busy share.
  5. the dense continuous batcher at llama 1b (batching.py, the _Batcher of
     workloads/serve.py; no kernel on this path). 5a, in-process, f32: six
     staggered requests into 4 slots, each greedy stream held to its solo
     (B=1) stream, where it may leave only at a near tie (top-2 gap under
     TIE_GAP, at most one stream a run); again with chunked prefill, the
     prefix cache and decode chunks over prompts sharing a 128-token prefix
     (a prefix hit counted), and with a mini draft (speculative rounds,
     acceptance printed); no flash kernel launched. 5b, bf16: `python -m
     gpu_docker_api_tpu_torch.workloads.serve --config 1b --batch-slots 8
     ...` under 32 requests from 16 clients, with --decode-chunk 1 and 8:
     every response served with the batching headers, healthz counting 32
     admissions, a two-row request refused; then --admit-queue 2 must shed
     with the 429 envelope; then, in-process, the device-busy share and
     step time of a traced window of 8-slot decode beside its bound.
  6. the paged KV cache at llama 1b (paging.py, the paged _Batcher; no
     kernel on this path). 6a, in-process, f32: 5a's runs over 16-token
     blocks, the staggered one on a pool of 60% of what its requests hold
     (an admission must find the pool short), each stream held to its
     solo stream as in 5a, every drained pool holding only the trie's
     blocks, then the KV handoff between two paged batchers; no flash
     kernel launched. 6b, bf16: 5b's burst against the serve process
     with --kv-block 16 --prefix-cache 8 --decode-chunk 1 (the KV sketch
     headers on every response, the pool drained to the trie's blocks),
     printed beside 5b's; then the paged 8-slot decode window, no sync in
     a decode step. 6c: a prefill replica and a decode replica (serve
     --kv-block 16 --batch-slots 4), three handoffs over HTTP each equal
     to the decode replica's full request, healthz counting the imports,
     a taken key a 404, an untaken export freed after its TTL.
  7. the MoE family at moe_1b (models/moe.py). 7a: train_llama --family
     moe at batch 8, seq 2048 for a few steps, the launch counters set to
     0 just before and read just after (every layer's attention through
     the kernels); losses finite, the first near its value at init; the
     model-FLOP share by the JAX bench's active-expert count; then the
     trunk in f32 through the kernels and the reference attention, each
     layer's routing recorded: a decision may differ only at a near tie
     (router probabilities within TIE_GAP, at most one), the logits
     compared before it. 7b, f32, in-process: the cached path against
     moe_forward through the forward kernel with a capacity under which
     nothing drops; the dense and the paged _Batcher driven by hand under
     one schedule at the real capacity, each paged stream equal to its
     dense one but where its routing moved for a reason schedule_moves
     allows; no launch, no sync in a decode step. 7c, bf16: `serve
     --family moe --config 1b --batch-slots 8` under a burst (headers,
     healthz count); decode times at B=1 and B=8, dense and w8, beside
     their bounds; --host-load in-process, its device peak under the int8
     tree plus one leaf and its tree equal to --quantize w8's; `serve
     --host-load --quantize w8` beside `serve --quantize w8`, equal greedy
     tokens.

  8. long context and sequence parallelism at llama 1b's attention width
     (16/8 heads of 128). 8a, in-process: blockwise_attention (chunk 2048)
     at S=16384, causal and with a 4096 window, bf16, forward and backward
     through the kernels (4 and 15 launches of each) against the f32
     whole-S kernels, at most TRUNK_MARGIN times the bf16 whole-S kernel's
     error, and in f32 at S=8192 within F32_TOL; fwd+bwd timed against the
     whole-S kernel. 8b: four processes on this one card in a gloo group
     (asked for by name: NCCL refuses two ranks on one GPU), S=8192 (2048 a
     rank) in bf16 and S=4096 in f32: the causal flash ring (rank + 1
     launches), the windowed ring, the einsum ring and Ulysses, each
     rank's output and q/k/v gradient shards against the same shards of
     the whole-S kernels run here, by 8a's rules. 8c, on the same ranks:
     the llama 1b trunk in f32 (B=1, S=1024) against one rank (logits
     shards, loss, gradients within F32_TOL), then Trainer at sp=4 in
     bf16 (B=1, S=8192, remat "dots", 2 steps, ring then Ulysses) against
     the one-rank Trainer run here (losses and grad norms within
     SP_LOSS_TOL / SP_NORM_TOL), step time and tokens/s labelled "gloo,
     4 ranks on one card".
  9. data parallelism and fully-sharded parameters at llama 1b's width
     and 10 of its 20 layers (bf16, B=4, S=2048, remat "dots"): the
     one-rank Trainer here, then four processes on this one card in a
     gloo group (as in phase 8) through 9a fsdp=4, 9b dp=2 x fsdp=2 and
     9c fsdp=2 x sp=2 (the ring; 2 steps each): every rank's loss and
     grad norm equal, each
     within SP_LOSS_TOL / SP_NORM_TOL of the one-rank run's; the bytes of
     each rank's parameters, mu and nu after init exactly the whole
     state's over fsdp, the norms whole (no rank keeps a replica); the
     kernels' launches a rank and step those of one rank (20/10/10 at 10
     layers; under the ring rank + 1 times as many); 9a's gathered
     checkpoint restored under the one-rank template, each leaf equal bit
     for bit to the ranks' shards. Step time and tokens/s labelled "gloo,
     4 ranks on one card", each rank's peak allocation.
 10. tensor parallelism (bf16, B=4, S=2048, remat "dots", phase 9's
     batches): four processes on this one card in a gloo group through
     10a tp=4, 10b fsdp=2 x tp=2 and 10c tp=2 x sp=2 (the ring) at phase
     9's llama 1b cut, and 10d tp=4 at llama_mini (4 q / 2 kv heads: the
     head-gather
     fallback); 2 steps each, against phase 9's one-rank run (10d against
     its own): every rank's loss and grad norm equal, each within
     SP_LOSS_TOL / SP_NORM_TOL of one rank's, the first near its value at
     init; each rank's params, mu and nu exactly 1/(fsdp * tp) of every
     matrix's bytes, the norms whole; launches a rank and step (20/10/10
     at 10 layers, the ring's in 10c, 8/4/4 in 10d), the q heads the
     forward kernel saw (H/tp, all H in the fallback) and the tp
     activation sums a step (5 a layer + 4 under "dots"); 10b's gathered
     checkpoint restored under the one-rank template, shard for shard
     over both axes. Step time and tokens/s labelled "gloo, 4 ranks on
     one card", each rank's peak allocation.
 11. expert parallelism and MoE over ranks at moe_1b, full width and
     depth (bf16, B=8, S=2048 as 7a, remat "dots"): the one-rank Trainer
     here (2 steps), then four
     processes on this one card in a gloo group through 11a ep=4, 11b
     fsdp=2 x ep=2 (MeshPlan.auto's plan for --ep 2 on four cards), 11c
     tp=4 (JAX's un-planned MoE launch on four cards) and 11d ep=2 x
     sp=2 (the ring; the interleaved global prefix); 2 steps each: every
     rank's loss and grad norm equal, each within EP_LOSS_TOL /
     EP_NORM_TOL of one rank's (the difference printed), the first near
     its value at init; each rank's params, mu and nu exactly each leaf's
     bytes over the axes its spec cuts (banks over ep too, the f32 router
     whole); launches a rank and step (32/16/16 at 16 layers, the ring's
     in 11d), heads and tp sums; the routing of every layer in an f32
     forward of the first batch at capacity factor EP_ROUTE_CAPACITY
     (choices drop), assembled over the ranks, against one rank's: a
     decision may differ only at a near tie (TIE_GAP), once at most, and
     the drops only where a decision does; 11b's gathered checkpoint restored
     under the one-rank template, shard for shard over fsdp and ep. Step
     time and tokens/s labelled "gloo, 4 ranks on one card".
 12. pipeline parallelism over the same four gloo ranks (2 steps, bf16,
     stage remat): 12a llama 1b, all 20 layers, pp=4 (GPipe, M=4, B=4),
     12b fsdp=2 x pp=2 interleaved (v=2, M=2), 12c pp=2 x sp=2 ring (M=2)
     against the one-rank llama 1b Trainer at phase 2's shape, 12d
     moe_1b pp=2 x ep=2 (M=2, B=8) against the plain microbatched
     version (pipeline.microbatched_loss: the same routing pools); the
     checks of phases 9-11 (bytes with the layers over pp, launches a
     stage's layers once a microbatch); 12b's checkpoint is grouped [2, 2,
     5, ...]: restored under its own template shard for shard, and
     through serve's loader ungrouped, equal bit for bit.

Prints one `{"kernels": [...]}` line (with each kernel's launches in 7a
and phases 8-12 too), the readings, one `{"serve": ...}` line, one
`{"batching": ...}` line, one `{"paged": ...}` line, one `{"moe": ...}`
line, one `{"sp": ...}` line, one `{"fsdp": ...}` line, one `{"tp": ...}`
line, one `{"ep": ...}` line, one `{"pp": ...}` line, the wall times of
the whole script and of phases 11 and 12, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores and HBM3.
# bound_ms is the larger of operations / peak and bytes / rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

MAIN_SHAPE = dict(b=4, s=2048, h=16, hkv=8, d=128)   # llama 1b, B=4, S=2048
MAIN_STEPS = 5
F32_TOL = 2e-3    # as tests/test_flash_bwd.py: |err| <= tol + tol * |ref|
# bf16, element by element: |err| <= BF16_TOL * (|ref| + the rms of ref over
# the element's band of BAND rows of one (batch, head)), and per tensor
# ||err|| <= BF16_FROB * ||ref||. The band's rms scales the limit with the
# values around it: under causal attention the first rows' outputs and the
# first keys' gradients are tens of times larger than the rest, so one limit
# for the whole tensor would let a fault in the late rows through. The
# kernels round P and dS to bf16 before the tensor-core products and their
# outputs to bf16, while the plain versions stay in f32 until the final
# cast. Both limits sit between the sound kernels' largest reading and the
# smallest reading of a planted fault (planted_faults), on the H100: ratio
# 0.024 against 1.26, Frobenius 0.0029 against 0.0126 (PERF.md).
BAND = 64
BF16_TOL = 0.1
BF16_FROB = 0.006
# bf16 trunk: the kernels' error against the f32 reference run may be at
# most this multiple of the bf16 reference attention's, and every planted
# fault's must exceed it. Set between the readings of
# scripts/torch_trunk_margin.py on the H100 over six seeds (PERF.md): sound
# kernels and controls at most 1.143 (the logits' largest error, one
# element's worst case, scatters by about 0.1 from seed to seed), planted
# faults at least 3.94.
TRUNK_MARGIN = 1.5
TRUNK_S = 256     # the trunk check's sequence length (B=1)

REPLACES = {
    "flash_fwd": "gpu_docker_api_tpu/ops/attention.py:108",
    "flash_bwd_dq": "gpu_docker_api_tpu/ops/attention.py:290",
    "flash_bwd_dkv": "gpu_docker_api_tpu/ops/attention.py:369",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn over `iters` back-to-back calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def band_rms(torch, ref):
    """rms of ref [B,S,H,D] over each (batch, band of BAND rows, head),
    broadcast back to [B,S,H,1]."""
    b, s, h, d = ref.shape
    n = -(-s // BAND)
    sq = torch.zeros(b, n * BAND, h, device=ref.device)
    sq[:, :s] = ref.square().sum(dim=-1)
    rows = (s - torch.arange(n, device=ref.device) * BAND).clamp(max=BAND)
    ms = sq.view(b, n, BAND, h).sum(dim=2) / (rows[:, None] * d)
    return ms.sqrt().repeat_interleave(BAND, dim=1)[:, :s, :, None]


def bf16_readings(torch, got, ref):
    """(largest |err| / (|ref| + band rms), ||err|| / ||ref||) of one
    bf16 output [B,S,H,D] against its f32-computed reference."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ratio = err / (ref.abs() + band_rms(torch, ref)).clamp_min(1e-30)
    return (float(ratio.max()),
            float(err.norm() / ref.norm().clamp_min(1e-30)))


def bf16_ok(readings):
    ratio, frob = readings
    return ratio <= BF16_TOL and frob <= BF16_FROB


def err_of(torch, got, ref, dtype):
    """(max_abs_err, within tolerance, bf16 readings or None) of a kernel
    output against the plain version's."""
    if not bool(torch.isfinite(got).all()):
        return float("inf"), False, None
    err = (got.float() - ref.float()).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if dtype == torch.float32:
        return max_err, bool((err <= F32_TOL + F32_TOL * ref.float().abs())
                             .all()), None
    readings = bf16_readings(torch, got, ref)
    return max_err, bf16_ok(readings), readings


def kernel_case(torch, att, *, b, s, h, hkv, d, dtype, causal=True, window=0,
                with_dlse=False, seed=0):
    """Run the three kernels and their plain versions on one input set.
    Returns ({kernel: max_abs_err}, {kernel: worst bf16 readings or None},
    the inputs, {kernel: plain outputs})."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, do = randn(b, s, h, d), randn(b, s, h, d)
    k, v = randn(b, s, hkv, d), randn(b, s, hkv, d)
    dlse = (torch.randn(b, h, s, generator=gen, device="cuda")
            if with_dlse else None)
    label = (f"{str(dtype).split('.')[-1]} B{b} S{s} H{h}/{hkv} D{d} "
             f"causal={causal} window={window} dlse={with_dlse}")

    o, lse = att.flash_fwd(q, k, v, causal, window)
    o_ref, lse_ref = att.flash_fwd_plain(q, k, v, causal, window)
    # the backward versions read the same residuals: the kernel's o and lse
    bwd = (q, k, v, o, do, lse, causal, window, dlse)
    dq, dq_ref = att.flash_bwd_dq(*bwd), att.flash_bwd_dq_plain(*bwd)
    (dk, dv), (dk_ref, dv_ref) = (att.flash_bwd_dkv(*bwd),
                                  att.flash_bwd_dkv_plain(*bwd))
    outputs = {
        "flash_fwd": [(o, o_ref, dtype), (lse, lse_ref, torch.float32)],
        "flash_bwd_dq": [(dq, dq_ref, dtype)],
        "flash_bwd_dkv": [(dk, dk_ref, dtype), (dv, dv_ref, dtype)],
    }
    errs, readings = {}, {}
    for name, pairs in outputs.items():
        results = [err_of(torch, got, ref, dt) for got, ref, dt in pairs]
        errs[name] = max(r[0] for r in results)
        rd = [r[2] for r in results if r[2] is not None]
        readings[name] = ((max(x[0] for x in rd), max(x[1] for x in rd))
                          if rd else None)
        check(all(r[1] for r in results),
              f"{name} disagrees ({label}): max abs err {errs[name]}, bf16 "
              f"(ratio, frob) {readings[name]}")
    torch.cuda.synchronize()
    print(f"  ok  {label}  " + "  ".join(
        f"{n}={e:.3g}" + ("" if readings[n] is None else
                          " (ratio {:.3g}, frob {:.3g})".format(*readings[n]))
        for n, e in errs.items()), flush=True)
    return errs, readings, (q, k, v, o, do, lse), {
        "flash_fwd": (o_ref,), "flash_bwd_dq": (dq_ref,),
        "flash_bwd_dkv": (dk_ref, dv_ref)}


def planted_faults(torch, att, q, k, v, o, do, lse):
    """What kernels with known bugs would output at these inputs (causal,
    bf16): each fault is modelled in f32 from the plain math and rounded to
    bf16 as the kernels round their outputs. Returns [(name, kernel, a
    function giving the kernel's outputs)]; the first entry of each kernel
    plants no fault (a control)."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    n = -(-s // BAND)
    idx = torch.arange(s, device=q.device)
    rows, cols = idx[:, None], idx[None, :]
    t_r, t_c = rows // BAND, cols // BAND
    last_head = (torch.arange(h, device=q.device) % group
                 == group - 1)[:, None, None]
    scores = att._scaled_scores(q, k, True, 0)
    p, ds = att._bwd_terms(q, k, v, o, do, lse, True, 0, None)
    vr, kr = att._repeat_kv(v, group), att._repeat_kv(k, group)
    bf = torch.bfloat16
    none = torch.zeros((s, s), dtype=torch.bool, device=q.device)

    def softmax_without(drop):
        return torch.softmax(scores.masked_fill(drop, float("-inf")),
                             dim=-1).nan_to_num(0.0)

    def out_of(probs):
        return (torch.einsum("bhqk,bkhd->bqhd", probs, vr).to(bf),)

    def no_rescale_at(j):
        # the accumulator keeps the earlier tiles' share scaled to the old
        # running max when tile j raises it (l is rescaled as it should be)
        j0 = j * BAND
        probs = torch.softmax(scores, dim=-1)
        m_prev = scores[..., :j0].amax(dim=-1, keepdim=True)
        m_cur = scores[..., :j0 + BAND].amax(dim=-1, keepdim=True)
        grow = torch.where(rows >= j0, (m_cur - m_prev).exp(), 1.0)
        return torch.cat([probs[..., :j0] * grow, probs[..., j0:]], dim=-1)

    def dq_of(drop):
        dq = torch.einsum("bhqk,bkhd->bqhd", ds.masked_fill(drop, 0.0), kr)
        return ((dq / math.sqrt(d)).to(bf),)

    def dq_rows_swapped():
        # a lane of the wgmma kernel holds rows r and r + 8 of each 16-row
        # group; here they trade their lse and delta (a partner at or past S
        # reads 0, as the kernel holds for such rows)
        partner = idx ^ 8
        inside = partner < s
        partner = partner.clamp(max=s - 1)
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
        lse_sw, delta_sw = (torch.where(inside, x[..., partner], 0.0)
                            for x in (lse, delta))
        dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
        ds_sw = att._probs(scores, lse_sw) * (dp - delta_sw[..., None])
        dq = torch.einsum("bhqk,bkhd->bqhd", ds_sw, kr)
        return ((dq / math.sqrt(d)).to(bf),)

    def dkv_of(drop):
        dv = torch.einsum("bhqk,bqhd->bkhd", p.masked_fill(drop, 0.0),
                          do.float())
        dk = torch.einsum("bhqk,bqhd->bkhd", ds.masked_fill(drop, 0.0),
                          q.float()) / math.sqrt(d)
        return tuple(x.reshape(b, s, h // group, group, d).sum(dim=3).to(bf)
                     for x in (dk, dv))

    faults = [
        ("none", "flash_fwd", lambda: out_of(softmax_without(none))),
        ("kv tile 0 skipped for the last q tile", "flash_fwd",
         lambda: out_of(softmax_without((t_r == n - 1) & (t_c == 0)))),
        (f"output not rescaled at kv tile {n // 2}", "flash_fwd",
         lambda: out_of(no_rescale_at(n // 2))),
        ("diagonal kv tile skipped", "flash_fwd",
         lambda: out_of(softmax_without(t_r == t_c))),
        ("causal mask col < row", "flash_fwd",
         lambda: out_of(softmax_without(rows == cols))),
        ("none", "flash_bwd_dq", lambda: dq_of(none)),
        ("kv tile 0 skipped for the last q tile", "flash_bwd_dq",
         lambda: dq_of((t_r == n - 1) & (t_c == 0))),
        ("diagonal kv tile skipped", "flash_bwd_dq",
         lambda: dq_of(t_r == t_c)),
        ("causal mask col < row", "flash_bwd_dq",
         lambda: dq_of(rows == cols)),
        ("rows r and r + 8 swap their lse and delta", "flash_bwd_dq",
         dq_rows_swapped),
        ("none", "flash_bwd_dkv", lambda: dkv_of(none)),
        (f"q tile {5 * n // 8} skipped for kv tile {n // 4}",
         "flash_bwd_dkv",
         lambda: dkv_of((t_r == 5 * n // 8) & (t_c == n // 4))),
        (f"the group's last q head skipped for kv tile {n // 2}",
         "flash_bwd_dkv", lambda: dkv_of(last_head & (t_c == n // 2))),
        ("last q tile skipped", "flash_bwd_dkv",
         lambda: dkv_of(t_r == n - 1)),
        ("causal mask col < row", "flash_bwd_dkv",
         lambda: dkv_of(rows == cols)),
    ]
    return faults


def check_planted_faults(torch, att, inputs, refs):
    """The bf16 check must pass the control and reject every planted fault.
    Returns {kernel: smallest (ratio, frob) over its faults}."""
    print(f"  planted faults at the main shape (bf16 check: ratio <= "
          f"{BF16_TOL}, frob <= {BF16_FROB})", flush=True)
    missed, least = [], {}
    for name, kernel, outputs in planted_faults(torch, att, *inputs):
        rd = [bf16_readings(torch, got, ref)
              for got, ref in zip(outputs(), refs[kernel])]
        readings = (max(x[0] for x in rd), max(x[1] for x in rd))
        caught = not bf16_ok(readings)
        print(f"    {kernel}: {name}: ratio {readings[0]:.4g}, frob "
              f"{readings[1]:.4g} -> {'rejected' if caught else 'passed'}",
              flush=True)
        if name == "none":
            check(not caught, f"{kernel}: the unfaulted model fails the "
                              f"bf16 check {readings}")
            continue
        if not caught:
            missed.append(f"{kernel}: {name}")
        old = least.get(kernel, (math.inf, math.inf))
        least[kernel] = (min(old[0], readings[0]), min(old[1], readings[1]))
    check(not missed, f"the bf16 check passes planted faults: {missed}")
    return least


def check_repeatable(torch, att, q, k, v, o, do, lse):
    """The kernels run twice on the same inputs must give the same bits:
    a ring stage released early, or a sum whose order depends on timing,
    shows up here before it shows up as a wrong number."""
    for name, run in (
            ("flash_fwd", lambda: att.flash_fwd(q, k, v)),
            ("flash_bwd_dq", lambda: (att.flash_bwd_dq(q, k, v, o, do, lse),)),
            ("flash_bwd_dkv", lambda: att.flash_bwd_dkv(q, k, v, o, do, lse))):
        first, second = run(), run()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        check(same, f"{name}: two runs on the same inputs differ")
    print("  bitwise repeat at the main shape: fwd (o, lse), dq, dkv (dk, dv) "
          "identical", flush=True)


def check_fresh_thread(torch, att, q, k, v, o, do, lse):
    """Each kernel's first call on a thread that has made no CUDA call yet
    (autograd runs the backward on such a thread) must launch and give the
    main thread's bits. The launch must not lean on a CUDA context that an
    earlier call on the thread left current, so the thread's outputs come
    from blocks the allocator already holds: no cudaMalloc there either."""
    import threading
    for name, run in (
            ("flash_fwd", lambda: att.flash_fwd(q, k, v)),
            ("flash_bwd_dq", lambda: (att.flash_bwd_dq(q, k, v, o, do, lse),)),
            ("flash_bwd_dkv", lambda: att.flash_bwd_dkv(q, k, v, o, do, lse))):
        want = run()
        run()   # its outputs are freed at once: the thread's run reuses them
        sync = torch.cuda.synchronize if q.is_cuda else (lambda: None)
        sync()
        got, error = [], []

        def body():
            try:
                got.extend(run())
                sync()
            except Exception as e:  # reported by the check below
                error.append(repr(e))

        thread = threading.Thread(target=body, daemon=True)
        thread.start()
        thread.join(timeout=300)
        check(not thread.is_alive(), f"{name} on a fresh thread: no return")
        check(not error, f"{name} on a fresh thread: {error}")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} on a fresh thread differs from the main thread's")
    print("  fresh thread: fwd, dq, dkv launch and give the same bits",
          flush=True)


def bounds(shape, dtype_bytes):
    """Least time (ms) and its bound for each kernel at a causal shape,
    counting the visible (row, col) pairs these inputs need."""
    b, s, h, hkv, d = (shape[x] for x in ("b", "s", "h", "hkv", "d"))
    pairs = b * h * s * (s + 1) // 2
    q_el, kv_el, rows = b * s * h * d, b * s * hkv * d, b * h * s
    work = {
        # QK^T and PV
        "flash_fwd": (4 * d * pairs,
                      (2 * q_el + 2 * kv_el) * dtype_bytes + 4 * rows),
        # QK^T, dO V^T, dS K
        "flash_bwd_dq": (6 * d * pairs,
                         (4 * q_el + 2 * kv_el) * dtype_bytes + 4 * rows),
        # QK^T, dO V^T, P^T dO, dS^T Q
        "flash_bwd_dkv": (8 * d * pairs,
                          (3 * q_el + 4 * kv_el) * dtype_bytes + 4 * rows),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_BF16_FLOPS
        t_bytes = nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_kernels(torch, att):
    print("phase 1: kernels against their plain versions", flush=True)
    small = [
        dict(b=2, s=128, h=4, hkv=4, d=64),                  # MHA, group 1
        dict(b=2, s=128, h=4, hkv=2, d=64),                  # GQA group 2
        dict(b=1, s=100, h=4, hkv=2, d=32),                  # ragged S
        dict(b=1, s=128, h=4, hkv=2, d=16, causal=False),    # full
        dict(b=1, s=192, h=4, hkv=2, d=64, window=48),       # windowed
        dict(b=1, s=160, h=4, hkv=2, d=128, window=70),      # window, ragged
        dict(b=1, s=128, h=4, hkv=2, d=64, with_dlse=True),  # lse cotangent
        dict(b=1, s=96, h=2, hkv=1, d=32, causal=False, with_dlse=True),
        dict(b=2, s=97, h=4, hkv=1, d=16, window=33),      # odd S, group 4
    ]
    long = [  # bf16 only: the f32 plain versions' [S, S] terms would not fit
        dict(b=1, s=4096, h=16, hkv=8, d=128),
        dict(b=1, s=4096, h=16, hkv=8, d=128, window=1024),
    ]
    sound = {}   # kernel -> worst bf16 (ratio, frob) of the kernels

    def case(**kw):
        errs, readings, inputs, refs = kernel_case(torch, att, **kw)
        for name, rd in readings.items():
            if rd is not None:
                old = sound.get(name, (0.0, 0.0))
                sound[name] = (max(old[0], rd[0]), max(old[1], rd[1]))
        return errs, inputs, refs

    for dtype in (torch.float32, torch.bfloat16):
        for i, kw in enumerate(small):
            case(dtype=dtype, seed=i, **kw)
    for i, kw in enumerate(long):
        case(dtype=torch.bfloat16, seed=50 + i, **kw)
    errs, inputs, refs = case(dtype=torch.bfloat16, seed=99, **MAIN_SHAPE)
    faults = check_planted_faults(torch, att, inputs, refs)
    del refs
    check_repeatable(torch, att, *inputs)
    check_fresh_thread(torch, att, *inputs)
    bf16_check = {name: {"kernels_ratio": sound[name][0],
                         "kernels_frob": sound[name][1],
                         "least_fault_ratio": faults[name][0],
                         "least_fault_frob": faults[name][1]}
                  for name in sound}
    print(f"  bf16 check {bf16_check}", flush=True)
    q, k, v, o, do, lse = inputs

    # timing at the main path's shape (bf16, causal)
    F = torch.nn.functional
    timings = {
        "flash_fwd": (lambda: att.flash_fwd(q, k, v),
                      lambda: att.flash_fwd_plain(q, k, v)),
        "flash_bwd_dq": (lambda: att.flash_bwd_dq(q, k, v, o, do, lse),
                         lambda: att.flash_bwd_dq_plain(q, k, v, o, do, lse)),
        "flash_bwd_dkv": (lambda: att.flash_bwd_dkv(q, k, v, o, do, lse),
                          lambda: att.flash_bwd_dkv_plain(q, k, v, o, do,
                                                          lse)),
    }
    # yardstick only: one PyTorch call computing the forward's function
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library = {
        "flash_fwd": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
    }
    results = {}
    for name, (kern, plain) in timings.items():
        lib = library.get(name)
        results[name] = {
            "max_abs_err": errs[name],
            "ms": time_ms(torch, kern, 20),
            "plain_ms": time_ms(torch, plain, 3),
            "library_ms": time_ms(torch, lib, 20) if lib else None,
        }
        print(f"  {name}: {results[name]}", flush=True)

    # yardstick: the kernels' whole forward + backward against SDPA's, both
    # through autograd with the same cotangent
    ours = [x.detach().requires_grad_(True) for x in (q, k, v)]
    lib = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
    do_t = do.transpose(1, 2).contiguous()
    fwd_bwd = {
        "kernels_fwd_bwd_ms": time_ms(torch, lambda: att.flash_attention(
            *ours).backward(do), 10),
        "sdpa_fwd_bwd_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            *lib, is_causal=True, enable_gqa=True).backward(do_t), 10),
    }
    # the pair dq + dkv against SDPA's backward alone (its fwd+bwd less its
    # forward)
    fwd_bwd["kernels_bwd_ms"] = (results["flash_bwd_dq"]["ms"]
                                 + results["flash_bwd_dkv"]["ms"])
    fwd_bwd["sdpa_bwd_ms"] = (fwd_bwd["sdpa_fwd_bwd_ms"]
                              - results["flash_fwd"]["library_ms"])
    print(f"  attention fwd+bwd: {fwd_bwd}", flush=True)
    return results, fwd_bwd, bf16_check


def read_metrics(path):
    with open(path, encoding="utf-8") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if "step" in r], recs


def phase_main_path(torch, att, steps: int):
    from gpu_docker_api_tpu_torch.models import llama
    from gpu_docker_api_tpu_torch.workloads import train_llama

    cfg = llama.LlamaConfig.llama_1b()
    b, s = MAIN_SHAPE["b"], MAIN_SHAPE["s"]
    print(f"phase 2: train_llama --config 1b --batch {b} --seq {s} "
          f"--steps {steps}", flush=True)
    with tempfile.TemporaryDirectory() as wd:
        att.reset_launches()
        rc = train_llama.main([
            "--config", "1b", "--batch", str(b), "--seq", str(s),
            "--steps", str(steps), "--checkpoint-every", str(steps),
            "--workdir", wd])
        torch.cuda.synchronize()
        launches = dict(att.LAUNCHES)
        check(rc == 0, f"train_llama exited {rc}")
        step_recs, _ = read_metrics(os.path.join(wd, "metrics.jsonl"))
    losses = [r["loss"] for r in step_recs]
    print(f"  losses {losses}", flush=True)
    print(f"  step_time_s {[r['step_time_s'] for r in step_recs]}",
          flush=True)
    print(f"  launches {launches}", flush=True)
    check([r["step"] for r in step_recs] == list(range(1, steps + 1)),
          f"step records {[r['step'] for r in step_recs]}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    # at init the logits are ~N(0, d_model * 0.02^2) (unit-RMS final norm
    # times an N(0, 0.02) lm_head), so the CE starts at ln(V) + sigma^2 / 2
    want0 = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    check(abs(losses[0] - want0) < 0.1,
          f"first loss {losses[0]} not near ln(V) + sigma^2/2 = {want0:.3f}")
    # the Trainer's default remat ("dots") reruns each layer's forward in
    # the backward, so the forward kernel runs twice per layer and step
    per_step = cfg.n_layers
    want = {"flash_fwd": 2 * per_step * steps,
            "flash_bwd_dq": per_step * steps,
            "flash_bwd_dkv": per_step * steps}
    check(launches == want, f"launches {launches}, want {want}")
    times = [r["step_time_s"] for r in step_recs[1:]]
    step_s = statistics.median(times)
    tokens_s = b * s / step_s

    trunk = trunk_check(torch, att, cfg)
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "step_times_s": times, "tokens_s": tokens_s, "trunk": trunk}


def trunk_fault_models(torch, att):
    """[(kernel, fault name)] of the entries of planted_faults at the
    trunk's length, the controls included."""
    q = torch.zeros(1, TRUNK_S, 2, 16, dtype=torch.bfloat16)
    kv = torch.zeros(1, TRUNK_S, 1, 16, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, TRUNK_S)
    return [(kernel, name) for name, kernel, _ in
            planted_faults(torch, att, q, kv, kv, q, q, lse)]


def planted_kernel(torch, att, index):
    """A stand-in for one kernel wrapper: entry `index` of planted_faults,
    computed from whatever inputs the trunk gives it (causal, no window, no
    lse cotangent). The forward's stand-in returns the plain version's lse."""
    kernel = trunk_fault_models(torch, att)[index][0]

    def model(q, k, v, o, do, lse):
        # contiguous, as the kernels write them (the next kernel checks it)
        return [t.contiguous() for t in
                planted_faults(torch, att, q, k, v, o, do, lse)[index][2]()]

    def fwd(q, k, v, causal=True, window=0, want_lse=True):
        o, lse = att.flash_fwd_plain(q, k, v, causal, window)
        return model(q, k, v, o, torch.zeros_like(q), lse)[0], lse

    def bwd(q, k, v, o, do, lse, causal=True, window=0, dlse=None):
        out = model(q, k, v, o, do, lse)
        return out[0] if kernel == "flash_bwd_dq" else tuple(out)

    return kernel, fwd if kernel == "flash_fwd" else bwd


def trunk_readings(torch, att, cfg, seed=7, faults=(), device="cuda"):
    """The 1b trunk at full width on a small input (B=1, S=TRUNK_S): logits
    and every parameter's gradient of the training loss, from one set of
    bf16-valued weights and tokens made from `seed`; in f32 and bf16,
    through the kernels ("auto") and the reference attention ("xla"), and in
    bf16 once more for each index in `faults`, with that entry of
    planted_faults standing in for its kernel. Returns (f32: the kernels'
    max |err| over max |ref| against the reference attention, bf16: {run:
    errors against the f32 reference run})."""
    from gpu_docker_api_tpu_torch.models import llama
    from gpu_docker_api_tpu_torch.train import loss_fn, tree_leaves, tree_map

    gen = torch.Generator(device=device).manual_seed(seed)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p16 = llama.init_params(cfg, gen)
    p32 = tree_map(lambda t: t.float(), p16)
    tokens = torch.randint(0, cfg.vocab_size, (1, TRUNK_S), generator=gen,
                           device=device)

    def run(params, c, impl):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        with torch.no_grad():
            logits = llama.llama_forward(params, tokens, c, impl=impl)
        check(bool(torch.isfinite(logits).all())
              and logits.shape == (1, TRUNK_S, cfg.vocab_size),
              f"1b logits ({c.dtype}, {impl}) not finite / wrong shape")
        return logits, torch.autograd.grad(
            loss_fn(params, tokens, c, impl=impl), leaves)

    def max_rel(got, ref):
        return float((got.float() - ref).abs().max()
                     / ref.abs().max().clamp_min(1e-30))

    ref_l, ref_g = run(p32, cfg32, "xla")
    logits, grads = run(p32, cfg32, "auto")
    f32 = {"logits": max_rel(logits, ref_l),
           "grads_worst_leaf": max(max_rel(g, r)
                                   for g, r in zip(grads, ref_g))}
    del logits, grads, p32

    def bf16_err(logits, grads):
        d_g = [(g.float() - r).norm() for g, r in zip(grads, ref_g)]
        r_g = [r.norm() for r in ref_g]
        return {"logits_frob": float((logits - ref_l).norm() / ref_l.norm()),
                "logits_max": max_rel(logits, ref_l),
                "grads_frob": float(torch.stack(d_g).norm()
                                    / torch.stack(r_g).norm()),
                "grads_worst_leaf": max(float(d / r.clamp_min(1e-30))
                                        for d, r in zip(d_g, r_g))}

    bf16 = {"kernels": bf16_err(*run(p16, cfg, "auto")),
            "reference": bf16_err(*run(p16, cfg, "xla"))}
    models = trunk_fault_models(torch, att)
    for i in faults:
        kernel, stand_in = planted_kernel(torch, att, i)
        real = getattr(att, kernel)
        setattr(att, kernel, stand_in)
        try:
            bf16[f"{kernel}: {models[i][1]}"] = bf16_err(
                *run(p16, cfg, "auto"))
        finally:
            setattr(att, kernel, real)
    return f32, bf16


def trunk_excess(bf16):
    """{run: the largest ratio, over the bf16 readings, of the run's error
    to the reference attention's} of every run but the reference."""
    ref = bf16["reference"]
    return {run: max(e[key] / ref[key] for key in ref)
            for run, e in bf16.items() if run != "reference"}


def trunk_check(torch, att, cfg):
    """The 1b trunk (trunk_readings) with every planted fault. In f32 the
    kernels must agree with the reference attention to F32_TOL. In bf16 the
    residual stream's roundings compound over the layers, so every bf16 run
    is held to the f32 reference run: the kernels' error, and each
    control's, may be at most TRUNK_MARGIN times the reference attention's,
    and each planted fault's must exceed it."""
    models = trunk_fault_models(torch, att)
    f32, bf16 = trunk_readings(torch, att, cfg, faults=range(len(models)))
    print(f"  1b f32 trunk (B=1, S={TRUNK_S}), kernels vs reference "
          f"attention, max |err| over max |ref|: {f32}", flush=True)
    check(all(e <= F32_TOL for e in f32.values()),
          f"1b f32 trunk err {f32} > {F32_TOL}")
    print(f"  1b bf16 trunk (B=1, S={TRUNK_S}) against the f32 reference "
          f"run: kernels {bf16['kernels']}, reference attention "
          f"{bf16['reference']}", flush=True)
    excess = trunk_excess(bf16)
    print(f"  1b bf16 trunk, error over the reference attention's (limit "
          f"{TRUNK_MARGIN}):", flush=True)
    over, missed = [], []
    for run, x in excess.items():
        control = run == "kernels" or run.endswith(": none")
        ok = x <= TRUNK_MARGIN
        print(f"    {run}: {x:.4g} -> {'passed' if ok else 'rejected'}",
              flush=True)
        if control and not ok:
            over.append(run)
        if not control and ok:
            missed.append(run)
    check(not over, f"1b bf16 trunk: error over {TRUNK_MARGIN} x the "
                    f"reference attention's in {over}")
    check(not missed, f"1b bf16 trunk: planted faults within "
                      f"{TRUNK_MARGIN} x the reference's: {missed}")
    return {"f32": f32, "bf16": bf16, "excess": excess}


def phase_resume():
    from gpu_docker_api_tpu_torch.workloads import train_llama

    print("phase 3: resume (tiny, 4 steps, restart, 2 more)", flush=True)
    with tempfile.TemporaryDirectory() as wd:
        base = ["--config", "tiny", "--batch", "4", "--seq", "64",
                "--checkpoint-every", "2", "--workdir", wd]
        check(train_llama.main(base + ["--steps", "4"]) == 0, "first run")
        check(train_llama.main(base + ["--steps", "6"]) == 0, "resumed run")
        step_recs, recs = read_metrics(os.path.join(wd, "metrics.jsonl"))
    steps = [r["step"] for r in step_recs]
    ckpts = [r["checkpoint"] for r in recs if "checkpoint" in r]
    print(f"  steps {steps}, checkpoints {ckpts}", flush=True)
    check(steps == [1, 2, 3, 4, 5, 6], f"step sequence {steps}")
    check(ckpts == [2, 4, 6], f"checkpoint markers {ckpts}")
    check(all(math.isfinite(r["loss"]) for r in step_recs), "non-finite loss")


# ---- phase 4: serving -------------------------------------------------------

SERVE_B = 2            # the f32 oracle and the HTTP requests: two rows
SERVE_PROMPT = 256     # the f32 oracle's prompt length
SERVE_STEPS = 32       # the f32 oracle's decode steps
HTTP_PROMPT = 128      # the HTTP greedy request: prompt, new tokens
HTTP_NEW = 32
TIME_CONTEXT = 512     # the timed prompt, and the decode steps' context
TIME_STEPS = 64
HTTP_DEADLINE_S = 300  # the serve subprocess must answer /healthz by then
# kv8 cache against the f32 full forward: |err| <= KV8_TOL * (1 + |ref|).
# Per-token-per-head int8 K/V moves the 1b logits far more than f32
# summation order does: the card read 0.113 at the oracle's inputs (the
# f32 cache 1.5e-5; PERF.md), and the limit sits at about twice that.
KV8_TOL = 0.2


def teacher_forced_check(torch, got, ref, tokens, tol, label):
    """The cached path's logits `got` [B, N, V] against the full forward's
    `ref` [B, N, V] on prompt + the tokens the cached path generated
    (teacher forcing), and its greedy `tokens` [B, N] against the full
    forward's argmax. Each logit must be within tol * (1 + |ref|). A token
    may differ from the argmax only at a near tie: where the full
    forward's logit of the token is within twice that limit of its
    largest logit, which the logits' check allows. Returns {"err": largest
    |err| / (1 + |ref|), "max_abs_err", "ties": the near ties taken}."""
    got, ref = got.float(), ref.float()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"{label}: logits {tuple(got.shape)} not finite or not "
          f"{tuple(ref.shape)}")
    err = (got - ref).abs()
    ratio = float((err / (1 + ref.abs())).max())
    check(ratio <= tol, f"{label}: logits off the full forward by "
                        f"{ratio:.4g} x (1 + |ref|) > {tol}")
    best, want = ref.max(dim=-1)
    picked = ref.gather(-1, tokens[..., None].long())[..., 0]
    limit = 2 * tol * (1 + best.abs())
    differ = tokens.long() != want
    check(bool((best - picked)[differ].le(limit[differ]).all()),
          f"{label}: greedy tokens differ from the full forward's argmax "
          f"beyond a near tie")
    return {"err": ratio, "max_abs_err": float(err.max()),
            "ties": int(differ.sum())}


def serve_oracle(torch, att, cfg, b, prompt_len, steps, kv_quant, tol,
                 device="cuda"):
    """The cached path (prefill, then `steps` decode_steps, greedy) against
    the family's full forward (llama_forward or moe_forward, impl="auto")
    on the same weights, in one call over the prompt and the fed tokens;
    generate() must give the same tokens. Returns the readings of
    teacher_forced_check plus the forward kernel's launches in the full
    forward."""
    from gpu_docker_api_tpu_torch import infer
    from gpu_docker_api_tpu_torch.models import family_for

    fam = family_for(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = fam.init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (b, prompt_len), generator=gen,
                           device=device)
    cache = infer.init_cache(cfg, b, prompt_len + steps + 1,
                             quantized=kv_quant, device=device)
    logits, cache = infer.prefill(params, prompt, cache, cfg)
    all_logits, tokens = [logits], [logits.argmax(dim=-1)]
    for _ in range(steps):
        logits, cache = infer.decode_step(params, tokens[-1], cache, cfg)
        all_logits.append(logits)
        tokens.append(logits.argmax(dim=-1))
    tokens = torch.stack(tokens, dim=1)                       # [B, steps+1]
    whole = infer.generate(params, prompt, cfg, steps + 1, kv_quant=kv_quant)
    check(torch.equal(whole, tokens),
          f"generate() differs from prefill + decode_step (kv8={kv_quant})")
    att.reset_launches()
    with torch.no_grad():
        ref = fam.forward(params, torch.cat([prompt, tokens[:, :-1]], dim=1),
                          cfg, impl="auto")
        ref = (ref[0] if fam.returns_extra_loss else ref)[:, prompt_len - 1:]
    launches = att.LAUNCHES["flash_fwd"]
    out = teacher_forced_check(torch, torch.stack(all_logits, dim=1), ref,
                               tokens, tol, f"{cfg.dtype} kv8={kv_quant}")
    out["flash_fwd_launches"] = launches
    return out


def leaf_bytes(t) -> int:
    """Bytes of one parameter leaf: a tensor, or an int8 weight with its
    scales."""
    from gpu_docker_api_tpu_torch.ops.quant import QTensor
    if isinstance(t, QTensor):
        return leaf_bytes(t.q) + leaf_bytes(t.s)
    return t.numel() * t.element_size()


def weight_bytes(params) -> int:
    """Bytes of the matrices a decode step reads: every projection and MLP
    weight (a MoE layer's router and every expert bank) and lm_head; the
    embedding's gathered rows and the norms are left out."""
    return (sum(leaf_bytes(w) for name, w in params["layers"].items()
                if not name.endswith("norm")) + leaf_bytes(params["lm_head"]))


def cache_bytes_per_token(cfg, kv_quant) -> int:
    """K and V of one token over every layer: bf16/f32 values, or int8 with
    an f32 scale per head."""
    per_head = (cfg.head_dim + 4 if kv_quant
                else cfg.head_dim * cfg.dtype.itemsize)
    return 2 * cfg.n_layers * cfg.n_kv_heads * per_head


def serve_bounds(cfg, w_bytes, b, t, ctx, kv_quant):
    """(least ms, "bytes" | "operations") of one cached forward of t tokens
    per row at context ctx: the weights read once, the cache read up to
    the frontier and written for the new tokens, against the matmul
    operations (2 per weight per token) and the attention's (4 * head_dim
    per visible (query, key) pair and head) over the bf16 peak. A MoE
    layer's FFN is its router (per token) and every expert's SwiGLU over
    its capacity: the gather dispatch runs 3 * d_model * d_ff weights on
    each of the E * C slots of the step (C = capacity(b * t)), used or
    not; its bytes are all the banks (w_bytes)."""
    per_tok = cache_bytes_per_token(cfg, kv_quant)
    keys = sum(ctx + i + 1 for i in range(t))            # visible pairs / row
    nbytes = w_bytes + b * (ctx + t) * per_tok
    swiglu = 3 * cfg.d_model * cfg.d_ff
    if hasattr(cfg, "n_experts"):
        ffn_tok = cfg.d_model * cfg.n_experts             # the router
        ffn_slots = swiglu * cfg.n_experts * cfg.capacity(b * t)
    else:
        ffn_tok, ffn_slots = swiglu, 0
    per_layer = (2 * cfg.d_model * cfg.head_dim
                 * (cfg.n_heads + cfg.n_kv_heads) + ffn_tok)
    n_matmul = cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size
    flops = (2 * n_matmul * b * t + 2 * cfg.n_layers * ffn_slots
             + 4 * cfg.head_dim * cfg.n_heads * cfg.n_layers * b * keys)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def busy_share(torch, windows):
    """{name: device-busy share} of windows {name: (fn, reps)}, all traced in
    one torch.profiler session: each window runs fn `reps` times under a
    record_function range and ends in a synchronize; its share is the union
    of the kernels' intervals inside the range over the span from the
    first such kernel's start to the last one's end (None when the
    profiler saw no device time there)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, (fn, reps) in windows.items():
            with record_function(f"busy:{name}"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the ranges also appear on the device as annotations spanning their
    # kernels: those are not kernels
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == cuda and not e.name.startswith("busy:")
                     and e.time_range.end > e.time_range.start)
    out = {}
    for name in windows:
        rng = next(e.time_range for e in events
                   if e.name == f"busy:{name}" and e.device_type != cuda)
        spans = [(s, e) for s, e in kernels
                 if s >= rng.start and e <= rng.end]
        if not spans:
            out[name] = None
            continue
        busy, (lo, hi) = 0.0, spans[0]
        for s, e in spans[1:]:
            if s > hi:
                busy, lo, hi = busy + hi - lo, s, e
            else:
                hi = max(hi, e)
        busy += hi - lo
        out[name] = busy / (spans[-1][1] - spans[0][0])
    return out


def serve_times(torch, cfg, params, label, b, kv_quant=False,
                context=TIME_CONTEXT, steps=TIME_STEPS):
    """Prefill of a `context`-token prompt, then `steps` decode steps from
    it; ms from the host clock around synchronised calls."""
    from gpu_docker_api_tpu_torch import infer

    gen = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (b, context),
                           generator=gen, device="cuda")

    def fresh():
        return infer.init_cache(cfg, b, context + 2 * steps + 1,
                                quantized=kv_quant)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    prefill_ms = []
    for _ in range(5):          # the first call warms up
        cache = fresh()
        ms, (logits, cache) = timed(
            lambda: infer.prefill(params, prompt, cache, cfg))
        prefill_ms.append(ms)
    token = logits.argmax(dim=-1)
    step_ms = []
    for _ in range(steps):
        ms, (logits, cache) = timed(
            lambda: infer.decode_step(params, token, cache, cfg))
        step_ms.append(ms)
        token = logits.argmax(dim=-1)
    state = {"cache": cache, "token": token}

    def one_step():
        logits, state["cache"] = infer.decode_step(
            params, state["token"], state["cache"], cfg)
        state["token"] = logits.argmax(dim=-1)

    w_bytes = weight_bytes(params)
    p_bound = serve_bounds(cfg, w_bytes, b, context, 0, kv_quant)
    d_bound = serve_bounds(cfg, w_bytes, b, 1, context + steps // 2,
                           kv_quant)
    busy = busy_share(torch, {
        "prefill": (lambda: infer.prefill(params, prompt, fresh(), cfg), 1),
        "decode": (one_step, 4)})
    out = {
        "batch": b, "context": context, "kv8": kv_quant,
        "prefill_ms": statistics.median(prefill_ms[1:]),
        "prefill_bound_ms": p_bound[0], "prefill_bound_by": p_bound[1],
        "prefill_busy": busy["prefill"],
        "decode_ms": statistics.median(step_ms),
        "decode_ms_p10_p90": [sorted(step_ms)[len(step_ms) // 10],
                              sorted(step_ms)[9 * len(step_ms) // 10]],
        "decode_bound_ms": d_bound[0], "decode_bound_by": d_bound[1],
        "decode_busy": busy["decode"],
        "weight_bytes": w_bytes,
    }
    print(f"  {label}: {out}", flush=True)
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(port, method, path, body=None, headers=None):
    """(envelope, response headers) of one request to the serve process."""
    from http.client import HTTPConnection
    conn = HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        check(resp.status == 200, f"{method} {path}: HTTP {resp.status}")
        return json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def start_serve(name, logs_dir, extra_args=()):
    """`python -m gpu_docker_api_tpu_torch.workloads.serve --config <name>`
    on a free port, its output in logs_dir/serve_subprocess.log, as the
    control plane starts it; waits for /healthz. Returns (process, port,
    seconds to /healthz, the /healthz envelope). The caller kills the
    process; so does this function when the wait fails."""
    return wait_serve(*spawn_serve(name, logs_dir, extra_args))


def spawn_serve(name, logs_dir, extra_args=(), env=None,
                log_name="serve_subprocess.log"):
    """start_serve's first half: the process (env: its environment, by
    default this one's; its output in logs_dir/<log_name>), not waited
    for. Returns (process, port, log path)."""
    port = free_port()
    log_path = os.path.join(logs_dir, log_name)
    repo = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w", encoding="utf-8") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gpu_docker_api_tpu_torch.workloads.serve",
             "--config", name, "--host", "127.0.0.1", "--port", str(port),
             *extra_args], cwd=repo, stdout=log, stderr=subprocess.STDOUT,
            env=env)
    return proc, port, log_path


def wait_serve(proc, port, log_path):
    """start_serve's second half: waits for /healthz, killing the process
    when the wait fails."""
    try:
        t0 = time.perf_counter()
        while True:
            check(proc.poll() is None, "the serve process exited: "
                  + open(log_path, encoding="utf-8").read()[-2000:])
            check(time.perf_counter() - t0 < HTTP_DEADLINE_S,
                  f"no /healthz within {HTTP_DEADLINE_S} s")
            try:
                health, _ = http_call(port, "GET", "/healthz")
                return proc, port, time.perf_counter() - t0, health
            except OSError:
                time.sleep(0.5)
    except BaseException:
        proc.kill()
        proc.wait(timeout=60)
        raise


def serve_http(torch, name, cfg, params, logs_dir, extra_args=()):
    """The serving entry point as the control plane starts it (start_serve;
    seed-0 weights, on the card unless extra_args ask for the CPU), driven
    over HTTP and held to in-process generate() on the same seed-0
    `params`. The subprocess is killed in every case."""
    from gpu_docker_api_tpu_torch import infer
    from gpu_docker_api_tpu_torch.workloads.serve import _n_params

    proc, port, ready_s, health = start_serve(name, logs_dir, extra_args)
    try:
        want = {"model": f"llama/{name}", "params": _n_params(params),
                "vocab": cfg.vocab_size, "maxSeqLen": cfg.max_seq_len}
        check(health["code"] == 200 and health["data"] == want,
              f"/healthz {health}, want data {want}")

        gen = torch.Generator().manual_seed(11)
        prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, HTTP_PROMPT),
                               generator=gen)
        tp = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
        t1 = time.perf_counter()
        greedy, hdrs = http_call(port, "POST", "/generate",
                                 {"tokens": prompt.tolist(),
                                  "max_new": HTTP_NEW},
                                 headers={"traceparent": tp})
        greedy_s = time.perf_counter() - t1
        check(greedy["code"] == 200, f"greedy /generate: {greedy}")
        check(hdrs.get("traceparent") == tp, "traceparent not echoed")
        direct = infer.generate(params, prompt.to(params["embed"].device),
                                cfg, HTTP_NEW)
        check(greedy["data"]["tokens"] == direct.tolist(),
              "greedy over HTTP differs from in-process generate()")
        topk1, _ = http_call(port, "POST", "/generate",
                             {"tokens": prompt.tolist(), "max_new": HTTP_NEW,
                              "temperature": 1.5, "top_k": 1})
        check(topk1["code"] == 200 and topk1["data"]["tokens"]
              == greedy["data"]["tokens"], "top_k=1 at 1.5 is not greedy")
        sampled, _ = http_call(port, "POST", "/generate",
                               {"tokens": prompt.tolist(), "max_new": 8,
                                "temperature": 0.8, "top_k": 50,
                                "top_p": 0.9})
        toks = sampled["data"]["tokens"] if sampled["code"] == 200 else None
        check(toks is not None and len(toks) == SERVE_B
              and all(len(r) == 8 and all(0 <= x < cfg.vocab_size for x in r)
                      for r in toks), f"sampled /generate: {sampled}")
        codes = {
            "out of range": http_call(port, "POST", "/generate", {
                "tokens": [[cfg.vocab_size]], "max_new": 2})[0],
            "POST /nope": http_call(port, "POST", "/nope", {})[0],
            "GET /nope": http_call(port, "GET", "/nope")[0],
            "GET /kv": http_call(port, "GET", "/kv?key=x")[0],
        }
        check([c["code"] for c in codes.values()] == [400, 404, 404, 404],
              f"error envelopes {codes}")
        check(codes["GET /kv"]["msg"] == "kv export not found",
              f"/kv {codes['GET /kv']}")
    finally:
        proc.kill()
        proc.wait(timeout=60)
    out = {"ready_s": ready_s, "greedy_request_s": greedy_s,
           "greedy_tokens_equal": True}
    print(f"  HTTP: /healthz {health['data']}; {out}", flush=True)
    return out


def phase_serve(torch, att):
    """Phase 4: the serving path at llama 1b on the card."""
    from gpu_docker_api_tpu_torch.models import llama
    from gpu_docker_api_tpu_torch.ops.quant import quantize_params
    from gpu_docker_api_tpu_torch.train import Trainer
    from gpu_docker_api_tpu_torch.workloads.serve import _load_params

    cfg = llama.LlamaConfig.llama_1b()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    print(f"phase 4: serving, llama 1b (f32 oracle B={SERVE_B}, prompt "
          f"{SERVE_PROMPT}, {SERVE_STEPS} decode steps)", flush=True)
    t0 = time.perf_counter()
    oracle = {}
    for kv8, tol in ((False, F32_TOL), (True, KV8_TOL)):
        r = serve_oracle(torch, att, cfg32, SERVE_B, SERVE_PROMPT,
                         SERVE_STEPS, kv8, tol)
        print(f"  f32 kv8={kv8} against llama_forward (tol {tol}): {r}",
              flush=True)
        check(r["flash_fwd_launches"] == cfg.n_layers,
              f"the oracle's full forward launched flash_fwd "
              f"{r['flash_fwd_launches']} times, want {cfg.n_layers}")
        oracle["kv8" if kv8 else "f32"] = r
        torch.cuda.empty_cache()

    # the serve process's own weights: a fresh seed-0 init on the card
    wall = {"oracle_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    params = _load_params(Trainer.create(cfg), "")
    with tempfile.TemporaryDirectory() as logs:
        http = serve_http(torch, "1b", cfg, params, logs)
    wall["http_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("  times (bf16, host clock around synchronised calls)", flush=True)
    times = {
        "bf16_b1": serve_times(torch, cfg, params, "bf16 B=1", 1),
        "bf16_b8": serve_times(torch, cfg, params, "bf16 B=8", 8),
        "kv8_b8": serve_times(torch, cfg, params, "kv8 B=8", 8,
                              kv_quant=True),
    }
    w8 = quantize_params(params, "w8")
    del params
    times["w8_b1"] = serve_times(torch, cfg, w8, "w8 B=1", 1)
    wall["times_s"] = time.perf_counter() - t0
    print(f"  phase 4 wall time {wall}", flush=True)
    return {"oracle": oracle, "http": http, "times": times, "wall": wall}


# ---- phase 5: the dense continuous batcher ----------------------------------

# 5a, in-process, f32: the batcher's greedy streams against each prompt's
# solo stream (B=1). A stream may leave its solo stream only at a near tie,
# where the solo logits' top two are closer than TIE_GAP: a row decoded in
# a batch of slots goes through other GEMM shapes than at B=1, and its
# logits may differ by rounding. At most one stream a run may do so.
BATCH_EXACT = dict(slots=4, max_len=512, lens=(37, 64, 100, 160, 200, 256),
                   new=24, prefix=128, suffixes=(16, 40, 72, 100),
                   prefill_chunk=64, prefix_cache=4, decode_chunk=8, gamma=4)
TIE_GAP = 1e-4
STAGGER_S = 0.2        # request i goes in i * STAGGER_S after the first
# 5b, the serve process over HTTP, bf16: the batcher's flags, then the
# traffic: requests from concurrent clients, prompt lengths and max_new drawn
# from numpy.random.default_rng(5) (inclusive ranges)
BATCH_SERVE = ("--batch-slots", "8", "--batch-max-len", "1024",
               "--batch-prefill-chunk", "256")
BATCH_TRAFFIC = dict(requests=32, clients=16, prompt=(128, 512),
                     new=(64, 128))
BATCH_ADMIT_QUEUE = 2
BUSY_WINDOW_STEPS = 64  # the timed window of steady 8-slot decode, in steps
BUSY_STEPS = 16        # the traced decode steps (a multiple of 8)
BATCH_HEADERS = ("X-TDAPI-Slots", "X-TDAPI-Active", "X-TDAPI-Queued",
                 "X-TDAPI-Queue-Wait-EWMA-Ms", "X-TDAPI-Queue-Wait-Ms")
MULTIROW_REFUSAL = (
    "bad request: server runs in continuous-batching mode: send "
    "single-sequence requests (one row; greedy or sampling), or start "
    "without --batch-slots for multi-row batches")


def solo_reference(torch, params, cfg, prompt, n):
    """The B=1 greedy stream of prompt [T] (prefill, then decode_step:
    generate()'s path, as phase 4 checks) and, per token, the gap between
    the top two logits it was picked from."""
    from gpu_docker_api_tpu_torch import infer
    cache = infer.init_cache(cfg, 1, prompt.shape[0] + n,
                             device=prompt.device)
    logits, cache = infer.prefill(params, prompt[None], cache, cfg)
    tokens, top2 = [], []
    for j in range(n):
        tokens.append(logits.argmax(dim=-1))
        top2.append(logits[0].topk(2).values)
        if j + 1 < n:
            logits, cache = infer.decode_step(params, tokens[-1], cache, cfg)
    top2 = torch.stack(top2)
    return torch.cat(tokens).tolist(), (top2[:, 0] - top2[:, 1]).tolist()


def near_tie_check(stream, solo, gaps, label) -> bool:
    """False when `stream` equals the solo stream; True when it leaves it
    first at a near tie (solo top-2 gap under TIE_GAP); fails otherwise."""
    check(len(stream) == len(solo),
          f"{label}: {len(stream)} tokens, want {len(solo)}")
    for j, (got, want) in enumerate(zip(stream, solo)):
        if got != want:
            check(gaps[j] < TIE_GAP,
                  f"{label}: token {j} is {got}, the solo stream's is {want},"
                  f" at a top-2 gap of {gaps[j]:.3g} (a near tie is under "
                  f"{TIE_GAP})")
            return True
    return False


def batcher_streams(torch, cfg, params, prompts, max_new, first_alone=False,
                    **kw):
    """Each prompt submitted from a thread of its own to a new
    _Batcher(cfg, params, **kw), request i going in i * STAGGER_S after the
    first, so later ones join mid-decode (first_alone: the rest only once
    the first prompt is in the prefix store). A paged batcher's admissions
    that found the pool short are counted, and once every request is back
    its free blocks must equal the pool less scratch and the trie's blocks
    (no leak). Returns (streams, the batcher, wall s, shortages). The
    batcher is closed in every case."""
    import threading
    from gpu_docker_api_tpu_torch.workloads.serve import _Batcher

    b = _Batcher(cfg, params, **kw)
    out, errors = [None] * len(prompts), []
    shortages = [0]
    if b._paged:
        # nothing is admitted before the first submit: the scheduler
        # thread calls the wrapper from then on
        alloc = b._alloc.alloc

        def counted(n):
            got = alloc(n)
            shortages[0] += got is None
            return got
        b._alloc.alloc = counted

    def ask(i):
        try:
            out[i] = b.submit(prompts[i], max_new)
        except Exception as e:  # reported by the check below
            errors.append(repr(e))

    t0 = time.perf_counter()
    try:
        threads = []
        for i in range(len(prompts)):
            if i == 1 and first_alone:
                while (not b._prefixes and threads[0].is_alive()
                       and time.perf_counter() - t0 < 600):
                    time.sleep(0.01)
            elif i:
                time.sleep(STAGGER_S)
            threads.append(threading.Thread(target=ask, args=(i,),
                                            daemon=True))
            threads[-1].start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads),
              "a batcher request did not return")
        check(not errors, f"batcher requests failed: {errors}")
        if b._paged:
            check_no_leak(b, "the drained pool")
        return out, b, time.perf_counter() - t0, shortages[0]
    finally:
        b.close()


def check_no_leak(b, label):
    """A paged batcher with no request in flight and no export pending
    holds only the trie's blocks (block 0 is scratch)."""
    held = len(b._trie) if b._trie is not None else 0
    free = b._alloc.free_blocks
    check(not b._kv_exports and free == b.kv_pool_blocks - 1 - held,
          f"{label}: {free} free blocks, want {b.kv_pool_blocks - 1 - held} "
          f"(pool {b.kv_pool_blocks}, {held} held by the trie; "
          f"{len(b._kv_exports)} exports pending)")


def batcher_exactness(torch, att, cfg, params, draft, sizes=BATCH_EXACT,
                      device="cuda", paged=None, label="5a"):
    """5a: three _Batcher runs on seed-made prompts, each stream held to
    its solo stream under the near-tie rule: staggered admissions; chunked
    prefill, the prefix cache and decode chunks over prompts sharing a
    prefix (a prefix hit must be counted); speculative rounds with `draft`
    (config, params). No flash kernel may launch: the serving path runs
    none. Returns the readings.

    paged (6a: {"kv_block", "pool_share"}): the same runs over the paged
    cache, the staggered one with a pool of pool_share of the blocks its
    six requests hold at once, where an admission must find the pool
    short; every drained pool must hold only the trie's blocks; then the
    KV handoff between two paged batchers (handoff_exactness)."""
    gen = torch.Generator(device=device).manual_seed(21)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=device)

    plain = [prompt(n) for n in sizes["lens"]]
    base = prompt(sizes["prefix"])
    shared = [torch.cat([base, prompt(n)]) for n in sizes["suffixes"]]
    n = sizes["new"]
    t0 = time.perf_counter()
    solo = {id(p): solo_reference(torch, params, cfg, p, n)
            for p in plain + shared}
    slot_kw = dict(slots=sizes["slots"], max_len=sizes["max_len"])
    small_pool = {}
    if paged:
        blk = paged["kv_block"]
        slot_kw["kv_block"] = blk
        need = sum(-(-(p.shape[0] + n) // blk) for p in plain)
        small_pool = dict(kv_pool_blocks=1 + math.ceil(
            paged["pool_share"] * need))
    runs = {
        "staggered": (plain, small_pool, False),
        "chunked prefill, prefix cache, decode chunk": (shared, dict(
            prefill_chunk=sizes["prefill_chunk"],
            prefix_cache=sizes["prefix_cache"],
            decode_chunk=sizes["decode_chunk"]), not paged),
        "speculative": (plain, dict(draft=draft, gamma=sizes["gamma"]),
                        False),
    }
    out = {"solo_s": time.perf_counter() - t0}
    att.reset_launches()
    for name, (prompts, kw, first_alone) in runs.items():
        streams, b, wall, short = batcher_streams(
            torch, cfg, params, prompts, n, first_alone, **slot_kw, **kw)
        ties = sum(near_tie_check(s, *solo[id(p)],
                                  f"{label} {name}, request {i}")
                   for i, (s, p) in enumerate(zip(streams, prompts)))
        check(ties <= 1, f"{label} {name}: {ties} streams left their solo "
                         f"streams at near ties (at most 1)")
        r = {"requests": len(prompts), "near_ties": ties, "wall_s": wall,
             "prefix_hits": b.prefix_hits}
        if paged:
            r.update(pool_blocks=b.kv_pool_blocks, shortages=short,
                     evictions=b.prefix_evictions)
        if "kv_pool_blocks" in kw:
            check(short >= 1, f"{label} {name}: no admission found the "
                              f"{b.kv_pool_blocks}-block pool short")
        if "prefix_cache" in kw:
            check(b.prefix_hits >= 1, f"{label} {name}: no prefix hit")
        if "draft" in kw:
            r["speculative"] = {
                "rounds": b.spec_rounds, "proposed": b.spec_proposed,
                "accepted": b.spec_accepted, "emitted": b.spec_emitted,
                "accept_rate": b.spec_accepted / max(b.spec_proposed, 1)}
        out[name] = r
        print(f"  {label} {name}: {r}", flush=True)
    if paged:
        out["handoff"] = r = handoff_exactness(
            torch, cfg, params, plain[:2], n, solo, label, **slot_kw)
        print(f"  {label} handoff: {r}", flush=True)
    launches = dict(att.LAUNCHES)
    check(not any(launches.values()),
          f"the batcher launched flash kernels: {launches}")
    out["launches"] = launches
    return out


def handoff_exactness(torch, cfg, params, prompts, n, solo, label, **kw):
    """The prefill/decode handoff between two paged batchers in-process: a
    prefill-phase request exports each prompt's KV (one token), the
    export is taken (once) and spliced into the decode batcher under
    prompt + that token, and the one token plus the decode stream must be
    the prompt's solo stream under the near-tie rule. Both pools drain
    back to their free blocks. Returns the readings."""
    from gpu_docker_api_tpu_torch.workloads.serve import _Batcher
    pre, dec = _Batcher(cfg, params, **kw), _Batcher(cfg, params, **kw)
    try:
        ties = 0
        for i, p in enumerate(prompts):
            key = f"smoke-{i}"
            first = pre.submit(p, 1, kv_key=key)
            e = pre.kv_take(key)
            check(e is not None and pre.kv_take(key) is None,
                  f"{label} handoff {i}: the export is not taken once")
            check(all(a.dtype.name in ("float32", "int8")
                      for a in e["bufs"].values()),
                  f"{label} handoff {i}: wire dtypes "
                  f"{[a.dtype.name for a in e['bufs'].values()]}")
            row = torch.cat([p, p.new_tensor(first)])
            rest = dec.submit(row, n - 1, kv_import={
                "tokens": e["tokens"], "bufs": e["bufs"]})
            ties += near_tie_check(first + rest, *solo[id(p)],
                                   f"{label} handoff {i}")
        check(ties <= 1, f"{label} handoff: {ties} near ties (at most 1)")
        check(dec.kv_handoffs_in == len(prompts),
              f"{label} handoff: {dec.kv_handoffs_in} imports, want "
              f"{len(prompts)}")
        deadline = time.perf_counter() + 30
        while pre._kv_exports and time.perf_counter() < deadline:
            time.sleep(0.01)         # the scheduler frees taken exports
        for b, name in ((pre, "prefill"), (dec, "decode")):
            check_no_leak(b, f"{label} handoff, the {name} batcher")
        return {"requests": len(prompts), "near_ties": ties,
                "handoffs_in": dec.kv_handoffs_in}
    finally:
        pre.close()
        dec.close()


def http_traffic(vocab, traffic=BATCH_TRAFFIC, seed=5):
    """[(prompt tokens, max_new)] of 5b's requests."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = traffic["prompt"]
    lens = rng.integers(lo, hi + 1, traffic["requests"])
    lo, hi = traffic["new"]
    news = rng.integers(lo, hi + 1, traffic["requests"])
    return [(rng.integers(0, vocab, int(n)).tolist(), int(m))
            for n, m in zip(lens, news)]


def percentile(values, q):
    """Nearest-rank percentile q in [0, 1] of a non-empty list."""
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def check_batching_headers(hdrs, label):
    """The batcher's response headers: every BATCH_HEADERS entry, numbers
    all of them."""
    missing = [h for h in BATCH_HEADERS if h not in hdrs]
    check(not missing, f"{label}: headers {missing} missing")
    for h in BATCH_HEADERS:
        float(hdrs[h])


def check_sketch_headers(hdrs, label):
    """A paged batcher's KV-affinity headers (with --prefix-cache): the
    sketch as SKETCH_WORDS 64-bit words of hex, the occupied blocks as a
    count."""
    sketch, occ = hdrs.get("X-TDAPI-KV-Sketch"), hdrs.get("X-TDAPI-KV-Occ")
    check(sketch is not None and occ is not None,
          f"{label}: the KV sketch headers are missing")
    check(re.fullmatch(r"[0-9a-f]{64}", sketch) is not None
          and occ.isdigit(), f"{label}: sketch {sketch!r}, occupancy {occ!r}")


def drive_traffic(port, requests, clients):
    """Every (tokens, max_new) of `requests` POSTed to /generate from
    `clients` concurrent clients. Returns ([(envelope, headers, latency
    s)], wall s)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(req):
        tokens, max_new = req
        t0 = time.perf_counter()
        env, hdrs = http_call(port, "POST", "/generate",
                              {"tokens": [tokens], "max_new": max_new})
        return env, hdrs, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as ex:
        results = list(ex.map(one, requests))
    return results, time.perf_counter() - t0


def batching_http(torch, name, cfg, logs_dir, decode_chunk,
                  traffic=BATCH_TRAFFIC, extra_args=(), paged=False):
    """5b: the serve process with the batcher (BATCH_SERVE, --decode-chunk)
    under http_traffic from concurrent clients: every response code 200
    with its tokens and the batching headers, healthz counting every
    admission, a two-row request refused with the JAX server's message.
    paged (6b, extra_args with --kv-block and --prefix-cache): every
    response also carries the KV sketch headers, and healthz the paged
    pool's block, drained back to what the trie holds. Returns the
    readings. The subprocess is killed in every case."""
    requests = http_traffic(cfg.vocab_size, traffic)
    proc, port, ready_s, health = start_serve(
        name, logs_dir, (*BATCH_SERVE, "--decode-chunk", str(decode_chunk),
                         *extra_args))
    try:
        check(health["data"]["batching"]["alive"] is True,
              f"/healthz {health}")
        results, wall = drive_traffic(port, requests, traffic["clients"])
        for i, ((env, hdrs, _), (_, max_new)) in enumerate(
                zip(results, requests)):
            toks = env["data"]["tokens"] if env["code"] == 200 else None
            check(toks is not None and len(toks) == 1
                  and len(toks[0]) == max_new
                  and all(0 <= x < cfg.vocab_size for x in toks[0]),
                  f"5b request {i}: {str(env)[:300]}")
            check_batching_headers(hdrs, f"5b request {i}")
            if paged:
                check_sketch_headers(hdrs, f"6b request {i}")
        health, _ = http_call(port, "GET", "/healthz")
        count = health["data"]["batching"]["queueWait"]["count"]
        check(count == len(requests),
              f"healthz queueWait.count {count}, want {len(requests)}")
        if paged:
            pool = health["data"]["batching"]["paged"]
            trie = health["data"]["batching"]["prefixCache"]
            check(pool["freeBlocks"] == pool["poolBlocks"] - 1
                  - trie["blocks"], f"6b healthz after the burst: {pool}, "
                                    f"the trie holds {trie['blocks']}")
        refusal, _ = http_call(port, "POST", "/generate",
                               {"tokens": [[1, 2], [3, 4]], "max_new": 2})
        check(refusal == {"code": 400, "msg": MULTIROW_REFUSAL, "data": None},
              f"two-row request: {refusal}")
    finally:
        proc.kill()
        proc.wait(timeout=60)
    latency = [r[2] for r in results]
    waits = [float(r[1]["X-TDAPI-Queue-Wait-Ms"]) for r in results]
    extra = ({"paged": pool, "prefix_cache": {
        k: trie[k] for k in ("entries", "blocks", "evictions")}}
        if paged else {})
    return {**extra, "decode_chunk": decode_chunk, "ready_s": ready_s,
            "requests": len(requests), "wall_s": wall,
            "tokens_s": sum(m for _, m in requests) / wall,
            "latency_s_p50_p90": [percentile(latency, 0.5),
                                  percentile(latency, 0.9)],
            "queue_wait_ms_p50_p90": [percentile(waits, 0.5),
                                      percentile(waits, 0.9)]}


def batching_shed(torch, name, cfg, logs_dir, traffic=BATCH_TRAFFIC,
                  serve_args=BATCH_SERVE, extra_args=()):
    """5b with --admit-queue: the same burst must see at least one request
    shed with the 429 envelope (Retry-After, X-TDAPI-Shed); every other
    request is served. Returns the counts."""
    requests = http_traffic(cfg.vocab_size, traffic)
    proc, port, _, _ = start_serve(
        name, logs_dir, (*serve_args, "--admit-queue",
                         str(BATCH_ADMIT_QUEUE), *extra_args))
    try:
        results, _ = drive_traffic(port, requests, traffic["clients"])
    finally:
        proc.kill()
        proc.wait(timeout=60)
    shed = [(env, hdrs) for env, hdrs, _ in results if env["code"] == 429]
    served = sum(env["code"] == 200 for env, _, _ in results)
    check(shed, f"--admit-queue {BATCH_ADMIT_QUEUE}: no request shed")
    for env, hdrs in shed:
        check(env == {"code": 429, "msg": "replica queue full", "data": None}
              and hdrs.get("Retry-After") == "1"
              and hdrs.get("X-TDAPI-Shed") == "1", f"shed response {env}")
    check(served + len(shed) == len(requests),
          "requests neither served nor shed")
    return {"admit_queue": BATCH_ADMIT_QUEUE, "shed": len(shed),
            "served": served}


def batcher_busy(torch, cfg, params, decode_chunk, slots=8, max_len=1024,
                 prompt_len=256, window_steps=BUSY_WINDOW_STEPS, **kw):
    """Steady decode with every slot decoding, in-process on the serve
    process's weights and batcher settings (kw: more of them, such as
    kv_block): the step time over an untraced window of the scheduler
    thread, window_steps decode steps long (host clock over the steps the
    slots' host lengths moved); then, with that thread stopped and its
    slots kept, the device-busy share of BUSY_STEPS decode steps of the
    same scheduler ticks (_tick) run on this thread, since the profiler
    records the CPU side of its own thread only; then
    check_decode_sync_free on the same slots; and the bound of one full
    decode step at the mean context (serve_bounds).

    The requests ask for every token the cache holds, and the windows are
    counted in steps: the scheduler thread stops itself after
    window_steps, so no slot can run out of budget inside the windows,
    however fast the host. The batcher is closed after them."""
    import threading
    from gpu_docker_api_tpu_torch.workloads.serve import _Batcher

    budget = max_len - prompt_len
    check(window_steps + BUSY_STEPS + 2 * decode_chunk + 10 < budget,
          f"a {window_steps}-step window does not fit a {budget}-token "
          f"budget")
    b = _Batcher(cfg, params, slots=slots, max_len=max_len,
                 prefill_chunk=256, decode_chunk=decode_chunk, **kw)
    gen = torch.Generator(device=params["embed"].device).manual_seed(9)
    prompts = torch.randint(0, cfg.vocab_size, (slots, prompt_len),
                            generator=gen, device=gen.device)

    def ask(p):
        try:
            b.submit(p, max_len - prompt_len)
        except RuntimeError:       # closed after the window
            pass

    threads = [threading.Thread(target=ask, args=(p,), daemon=True)
               for p in prompts]
    try:
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        while not all(s is not None and s.get("stream") is not None
                      for s in b.slots):
            check(time.perf_counter() - t0 < 300 and b.alive,
                  "the batcher never filled its slots")
            time.sleep(0.01)

        # the window: the scheduler thread's own next ticks, until they
        # have made window_steps decode steps; then it stops itself. Steps
        # are counted on the host mirror of the lengths, which moves a step
        # at a time inside a decode chunk too. This thread only waits: a
        # thread polling here would take the GIL from the scheduler
        marks, done, tick = [], threading.Event(), b._tick

        def counted_tick():
            if not marks:
                marks.append((time.perf_counter(),
                              sum(b.cache["host_lengths"])))
            out = tick()
            if sum(b.cache["host_lengths"]) - marks[0][1] >= (
                    window_steps * slots):
                marks.append((time.perf_counter(),
                              sum(b.cache["host_lengths"])))
                b._stop = True
                done.set()
            return out

        b._tick = counted_tick
        w0 = time.perf_counter()
        while not done.wait(timeout=1.0):
            check(b._dead is None and time.perf_counter() - w0 < 600,
                  "the decode window did not end")
        (t0, before), (t1, after) = marks
        window = t1 - t0
        steps, ctx = (after - before) / slots, (before + after) / 2 / slots
        del b._tick

        def emitted():
            return sum(len(s["stream"]) for s in b.slots if s is not None)

        b.thread.join(timeout=60)
        check(not b.thread.is_alive(), "the scheduler thread did not stop")
        before = emitted()
        with torch.no_grad():
            busy = busy_share(torch, {"decode": (
                b._tick, BUSY_STEPS // decode_chunk)})["decode"]
        check(steps > 0 and emitted() - before == BUSY_STEPS * slots
              and all(s is not None for s in b.slots),
              "the slots did not decode through the windows")
        check_decode_sync_free(torch, b)
    finally:
        b.close()
        for t in threads:
            t.join(timeout=60)
    bound = serve_bounds(cfg, weight_bytes(params), slots, 1, ctx, False)
    return {"decode_chunk": decode_chunk, "steps": steps, "busy": busy,
            "step_ms": window * 1e3 / steps, "context": ctx,
            "bound_ms": bound[0], "bound_by": bound[1]}


def check_decode_sync_free(torch, b):
    """A greedy decode step, a sampled one and a decode chunk over every
    slot of the stopped batcher `b` (dense or paged: its own entry points)
    queue their work without one device sync (torch.cuda's sync debug mode
    "error"): the per-row frontiers and the number of pages read are host
    ints, and the active mask and tokens go up through pinned memory. They
    move the cache past the streams; `b` is closed after."""
    n = len(b.slots)
    toks = torch.zeros(n, dtype=torch.long, device=b.device)
    sample = (*b._sample_vectors(), b._gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            b._fn("slot_decode")(b.params, toks, b.cache, [True] * n,
                                 b.config)
            b._fn("slot_decode_pick")(b.params, toks, b.cache, [True] * n,
                                      *sample, b.config)
            b._fn("slot_decode_multi")(b.params, toks, b.cache, [True] * n,
                                       [8] * n, b.config, 8, sample=sample)
    except RuntimeError as e:
        raise SmokeFailure(f"a slot decode step synchronised: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def phase_batching(torch, att):
    """Phase 5: the dense continuous batcher at llama 1b, full width and
    depth: 5a in-process in f32, 5b the serve process over HTTP in bf16."""
    from gpu_docker_api_tpu_torch.models import llama
    from gpu_docker_api_tpu_torch.train import Trainer
    from gpu_docker_api_tpu_torch.workloads.serve import _load_params

    cfg = llama.LlamaConfig.llama_1b()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    mini32 = dataclasses.replace(llama.LlamaConfig.llama_mini(),
                                 dtype=torch.float32)
    print(f"phase 5: continuous batcher, llama 1b (5a f32 in-process: "
          f"{BATCH_EXACT}; 5b bf16 serve process: {' '.join(BATCH_SERVE)}, "
          f"{BATCH_TRAFFIC})", flush=True)
    wall = {}
    t0 = time.perf_counter()
    params = llama.init_params(cfg32, torch.Generator(device="cuda")
                               .manual_seed(0))
    draft = (mini32, llama.init_params(mini32, torch.Generator(
        device="cuda").manual_seed(1)))
    exact = batcher_exactness(torch, att, cfg32, params, draft)
    del params, draft
    torch.cuda.empty_cache()
    wall["5a_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    http, busy = {}, {}
    with tempfile.TemporaryDirectory() as logs:
        for chunk in (1, 8):
            http[f"decode_chunk_{chunk}"] = r = batching_http(
                torch, "1b", cfg, logs, chunk)
            print(f"  5b HTTP: {r}", flush=True)
        shed = batching_shed(torch, "1b", cfg, logs)
        print(f"  5b --admit-queue: {shed}", flush=True)
    wall["5b_http_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = _load_params(Trainer.create(cfg), "")     # the server's weights
    for chunk in (1, 8):
        busy[f"decode_chunk_{chunk}"] = r = batcher_busy(torch, cfg, params,
                                                         chunk)
        print(f"  5b in-process decode window: {r}", flush=True)
    del params
    torch.cuda.empty_cache()
    wall["5b_busy_s"] = time.perf_counter() - t0
    print(f"  phase 5 wall time {wall}", flush=True)
    return {"exact": exact, "http": http, "shed": shed, "busy": busy,
            "wall": wall}


# ---- phase 6: the paged cache and the KV handoff ----------------------------

# 6a, in-process, f32: 5a's runs over the paged cache (blocks of 16 tokens;
# the staggered run's pool holds 60% of the blocks its six requests hold at
# once, so admissions wait on blocks), then the handoff between two paged
# batchers. 6b: 5b's serve process and burst with the paged cache and the
# prefix trie, --decode-chunk 1. 6c: two paged serve processes, a prefill
# replica and a decode replica, over HTTP.
PAGED_EXACT = dict(kv_block=16, pool_share=0.6)
PAGED_SERVE = ("--kv-block", "16", "--prefix-cache", "8")
HANDOFF_SERVE = ("--kv-block", "16", "--batch-slots", "4")
# prompt lengths drawn from default_rng(seed), none a whole number of
# blocks, so every export ends in a partial block
HANDOFF = dict(requests=3, prompt=(200, 300), new=16, ttl_s=2.0, seed=7)


def handoff_requests(vocab, spec=HANDOFF):
    """[prompt tokens] of 6c: lengths off the block edges."""
    import numpy as np
    rng = np.random.default_rng(spec["seed"])
    out = []
    while len(out) < spec["requests"]:
        n = int(rng.integers(spec["prompt"][0], spec["prompt"][1] + 1))
        if n % 16:
            out.append(rng.integers(0, vocab, n).tolist())
    return out


def handoff_http(torch, name, cfg, logs_dir, spec=HANDOFF, extra_args=()):
    """6c: a prefill replica and a decode replica (HANDOFF_SERVE, the
    decode one with --prefix-cache so healthz counts its imports), both
    with a TDAPI_KV_EXPORT_TTL_S of spec["ttl_s"]. For each prompt: the
    prefill phase (X-TDAPI-Phase: prefill, X-TDAPI-KV-Key) on the prefill
    replica gives one token; the decode phase (the key and X-TDAPI-KV-Source)
    on the decode replica continues prompt + that token; a second GET /kv of
    the key is a 404; and a full request of the same row to the decode
    replica must give the same tokens. The same full request to the prefill
    replica, which recomputes every position, is read beside it. healthz
    counts one import per prompt; the prefill replica's blocks come back
    once the exports are taken, and an export nobody takes is freed after
    the TTL. Returns the readings; both processes are killed in every
    case."""
    env = dict(os.environ, TDAPI_KV_EXPORT_TTL_S=str(spec["ttl_s"]))
    procs = []
    try:
        procs.append(spawn_serve(name, logs_dir, (*HANDOFF_SERVE, *extra_args),
                                 env, "serve_prefill.log"))
        procs.append(spawn_serve(name, logs_dir, (
            *HANDOFF_SERVE, "--prefix-cache", "4", *extra_args), env,
            "serve_decode.log"))
        (_, pport, ready_p, _), (_, dport, ready_d, _) = (
            wait_serve(*pr) for pr in procs)

        def generate(port, row, max_new, headers=None):
            out, hdrs = http_call(port, "POST", "/generate",
                                  {"tokens": [row], "max_new": max_new},
                                  headers)
            check(out["code"] == 200, f"6c /generate: {str(out)[:300]}")
            return out["data"]["tokens"][0], hdrs

        def health(port):
            return http_call(port, "GET", "/healthz")[0]["data"]["batching"]

        n, rows, recompute = spec["new"], [], []
        prompts = handoff_requests(cfg.vocab_size, spec)
        t0 = time.perf_counter()
        for i, prompt in enumerate(prompts):
            key = f"smoke-{i}"
            first, _ = generate(pport, prompt, n, {
                "X-TDAPI-Phase": "prefill", "X-TDAPI-KV-Key": key})
            check(len(first) == 1, f"6c prefill phase {i}: {first}")
            row = prompt + first
            got, hdrs = generate(dport, row, n - 1, {
                "X-TDAPI-KV-Key": key,
                "X-TDAPI-KV-Source": f"127.0.0.1:{pport}"})
            check_sketch_headers(hdrs, f"6c decode phase {i}")
            again, _ = http_call(pport, "GET", f"/kv?key={key}")
            check(again == {"code": 404, "msg": "kv export not found",
                            "data": None}, f"6c second /kv of {key}: {again}")
            full, _ = generate(dport, row, n - 1)
            check(got == full, f"6c request {i}: the handoff gave {got}, a "
                               f"full request {full}")
            other, _ = generate(pport, row, n - 1)
            recompute.append(next((j for j, (a, b) in enumerate(
                zip(got, other)) if a != b), None))
            rows.append(len(prompt))
        wall = time.perf_counter() - t0
        dec = health(dport)["prefixCache"]
        check(dec["handoffsIn"] == len(rows),
              f"6c decode healthz: handoffsIn {dec['handoffsIn']}, want "
              f"{len(rows)}")
        pool = health(pport)["paged"]
        check(pool["freeBlocks"] == pool["poolBlocks"] - 1,
              f"6c prefill replica after the takes: {pool}")
        # an export nobody takes holds its blocks until the TTL
        generate(pport, prompts[0], n, {"X-TDAPI-Phase": "prefill",
                                        "X-TDAPI-KV-Key": "orphan"})
        held = pool["poolBlocks"] - 1 - health(pport)["paged"]["freeBlocks"]
        check(held == -(-rows[0] // 16), f"6c orphan export holds {held} "
                                          f"blocks")
        t1 = time.perf_counter()
        while health(pport)["paged"]["freeBlocks"] != pool["poolBlocks"] - 1:
            check(time.perf_counter() - t1 < spec["ttl_s"] + 30,
                  "6c the orphan export outlived its TTL")
            time.sleep(0.25)
        freed_s = time.perf_counter() - t1
    finally:
        for proc, _, _ in procs:
            proc.kill()
            proc.wait(timeout=60)
    return {"requests": len(rows), "prompt_lens": rows, "new": n,
            "handoffs_in": dec["handoffsIn"], "ready_s": [ready_p, ready_d],
            "wall_s": wall, "orphan_blocks": held, "orphan_freed_s": freed_s,
            "recompute_first_mismatch": recompute}


def phase_paged(torch, att, dense):
    """Phase 6: the paged cache at llama 1b, full width and depth: 6a
    in-process in f32, 6b the paged serve process over HTTP in bf16 and its
    decode window in-process, 6c the handoff between two serve processes.
    `dense`: phase 5's readings, printed beside 6b's."""
    from gpu_docker_api_tpu_torch.models import llama
    from gpu_docker_api_tpu_torch.train import Trainer
    from gpu_docker_api_tpu_torch.workloads.serve import _load_params

    cfg = llama.LlamaConfig.llama_1b()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    mini32 = dataclasses.replace(llama.LlamaConfig.llama_mini(),
                                 dtype=torch.float32)
    print(f"phase 6: paged KV, llama 1b (6a f32 in-process: {PAGED_EXACT}; "
          f"6b bf16 serve process: {' '.join(BATCH_SERVE + PAGED_SERVE)} "
          f"--decode-chunk 1; 6c {' '.join(HANDOFF_SERVE)}: {HANDOFF})",
          flush=True)
    wall = {}
    t0 = time.perf_counter()
    params = llama.init_params(cfg32, torch.Generator(device="cuda")
                               .manual_seed(0))
    draft = (mini32, llama.init_params(mini32, torch.Generator(
        device="cuda").manual_seed(1)))
    exact = batcher_exactness(torch, att, cfg32, params, draft,
                              paged=PAGED_EXACT, label="6a")
    del params, draft
    torch.cuda.empty_cache()
    wall["6a_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as logs:
        http = batching_http(torch, "1b", cfg, logs, 1,
                             extra_args=PAGED_SERVE, paged=True)
        print(f"  6b HTTP: {http}", flush=True)
        wall["6b_http_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        handoff = handoff_http(torch, "1b", cfg, logs)
        print(f"  6c handoff: {handoff}", flush=True)
        wall["6c_s"] = time.perf_counter() - t0
    base = dense["http"]["decode_chunk_1"]
    print("  6b against 5b's dense burst of this call (paged / dense): "
          + ", ".join(f"{k} {http[k]} / {base[k]}" for k in (
              "tokens_s", "latency_s_p50_p90", "queue_wait_ms_p50_p90")),
          flush=True)
    t0 = time.perf_counter()
    params = _load_params(Trainer.create(cfg), "")     # the server's weights
    att.reset_launches()
    busy = batcher_busy(torch, cfg, params, 1, kv_block=16)
    launches = dict(att.LAUNCHES)
    check(not any(launches.values()),
          f"the paged decode window launched flash kernels: {launches}")
    del params
    torch.cuda.empty_cache()
    wall["6b_busy_s"] = time.perf_counter() - t0
    base = dense["busy"]["decode_chunk_1"]
    print(f"  6b in-process paged decode window: {busy}; the dense window "
          f"of this call: step {base['step_ms']} ms, busy {base['busy']}",
          flush=True)
    print(f"  phase 6 wall time {wall}", flush=True)
    return {"exact": exact, "http": http, "busy": busy, "handoff": handoff,
            "wall": wall}


# ---- phase 7: the MoE family ------------------------------------------------

# 7a: JAX's MoE training cell (bench.py:346-347): moe_1b, batch 8, seq 2048,
# accum_steps 1, at full width and depth. Then the trunk on a small input.
MOE_TRAIN = dict(b=8, s=2048, steps=5)
MOE_TRUNK_S = 256
# 7b, in-process, f32: the cached path against moe_forward with a capacity
# factor under which nothing drops (a one-token decode step and the full
# forward route different token sets, and agree only without drops); then
# the dense and the paged batcher under one schedule at the real capacity:
# request i submitted just before scheduler tick at[i]
MOE_ORACLE = dict(b=2, prompt=128, steps=16, capacity_factor=8.0)
MOE_BATCH = dict(slots=4, max_len=512, lens=(37, 100, 64, 200, 160, 256),
                 at=(0, 1, 2, 5, 9, 14), new=24, kv_block=16)
# 7c, bf16: the serve process with the batcher under a burst (prompts and
# max_new from default_rng(5)); decode times at B=1 and B=8 from 128-token
# prompts, dense and w8 (the JAX moe_w8 cell, bench.py:630-656); the
# host-load path; serve --host-load --quantize w8 beside serve --quantize w8
MOE_SERVE = ("--family", "moe")
MOE_TRAFFIC = dict(requests=16, clients=8, prompt=(128, 512), new=(64, 64))
MOE_TIME = dict(context=128, steps=32)
MOE_GREEDY = dict(b=2, prompt=128, new=16, seed=13)


def moe_train_flops(cfg, batch, seq) -> float:
    """Model FLOPs of one training step by the JAX bench's count
    (bench.py:241-251): 6 per active matmul weight per token, the active
    weights being the attention projections, top_k experts' SwiGLU and the
    router in each layer plus lm_head; plus the causal attention's
    products (half the keys on average), three times for fwd + bwd."""
    kq, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    ffn = cfg.top_k * 3 * cfg.d_model * cfg.d_ff + cfg.d_model * cfg.n_experts
    per_layer = cfg.d_model * (kq + 2 * kv) + kq * cfg.d_model + ffn
    n_matmul = cfg.n_layers * per_layer + cfg.vocab_size * cfg.d_model
    attn_fwd = (2 * 2 * batch * cfg.n_heads * seq * (seq / 2) * cfg.head_dim
                * cfg.n_layers)
    return 6.0 * n_matmul * batch * seq + 3.0 * attn_fwd


def moe_first_loss(cfg) -> float:
    """The loss at init: the CE's ln V + sigma^2 / 2 (sigma^2 = d_model *
    0.02^2, the logits' variance) plus the router term of every layer,
    aux_weight * 1 (balanced routing) + z_weight * (ln E + var / 2)^2, the
    router logits being N(0, var) with var = d_model * 0.02^2 too."""
    var = cfg.d_model * 0.02 ** 2
    router = (cfg.router_aux_weight
              + cfg.router_z_weight * (math.log(cfg.n_experts) + var / 2) ** 2)
    return math.log(cfg.vocab_size) + var / 2 + cfg.n_layers * router


class RoutingRecorder:
    """While active, appends every moe._route call to `calls`: (gate_idx,
    keep, the top_k + 1 largest router probabilities), one entry a layer
    of a forward."""

    def __init__(self, moe, calls=None):
        self.moe = moe
        self.calls = [] if calls is None else calls

    def __enter__(self):
        real = self.real = self.moe._route

        def recording(ht, router, config, *over_ranks):
            out = real(ht, router, config, *over_ranks)
            probs, gate_idx, keep = out[1], out[3], out[6]
            top = probs.sort(dim=-1, descending=True, stable=True).values
            self.calls.append((gate_idx.clone(), keep.clone(),
                               top[:, :config.top_k + 1].clone()))
            return out
        self.moe._route = recording
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real


def routing_flips(ref, got, label, tie_gap=TIE_GAP):
    """Routing of two runs of the same forward (RoutingRecorder.calls, one
    entry a layer). A decision (a token's top-k experts in order) may
    differ only at a near tie: where the reference's router probabilities
    of ranks 0..k are within tie_gap of each other, and at most once a
    run. Only the first layer that differs counts: later layers see
    hidden states the flip moved. Drops (keep) may differ only in a layer
    where a decision flipped: alike decisions give alike slots. Returns
    (flips [(layer, token, gap)], the first token whose decisions or drops
    differ in that layer: the positions before it are comparable, S when
    none differs)."""
    s = ref[0][0].shape[0]
    for layer, ((ri, rk, rtop), (gi, gk, _)) in enumerate(zip(ref, got)):
        flipped = (ri != gi).any(dim=-1)
        if not bool(flipped.any()) and bool((rk == gk).all()):
            continue
        gaps = (rtop[:, :-1] - rtop[:, 1:]).min(dim=-1).values
        flips = [(layer, int(t), float(gaps[t]))
                 for t in flipped.nonzero().flatten().tolist()]
        check(flips or bool((rk == gk).all()),
              f"{label}: layer {layer} drops other choices with every "
              f"routing decision alike: the capacity or the slot order "
              f"differs")
        wide = [f for f in flips if f[2] >= tie_gap]
        check(not wide, f"{label}: routing differs at a router-probability "
                        f"gap of {tie_gap} or more: {wide}")
        check(len(flips) <= 1, f"{label}: {len(flips)} routing decisions "
                               f"differ at near ties (at most 1): {flips}")
        changed = flipped | (rk != gk).any(dim=-1)
        return flips, int(changed.nonzero().min())
    return [], s


def moe_trunk_check(torch, cfg, seed=7, s=MOE_TRUNK_S, device="cuda"):
    """The moe_1b trunk at full width on a small input (B=1,
    S=MOE_TRUNK_S, f32): logits and router loss through the kernels
    ("auto") against the reference attention ("xla"), each layer's
    routing recorded. The routing may flip only at a near tie
    (routing_flips), and the logits are compared before the first token a
    flip moves; with no flip, the router loss and every parameter's
    gradient of the training loss are compared too, all within F32_TOL of
    the reference's largest magnitude."""
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.train import loss_fn, tree_leaves

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = moe.init_params(cfg32, gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                           device=device)
    leaves = tree_leaves(params)

    def run(impl):
        with torch.no_grad(), RoutingRecorder(moe) as rec:
            logits, rloss = moe.moe_forward(params, tokens, cfg32, impl=impl)
        check(bool(torch.isfinite(logits).all()) and logits.shape
              == (1, s, cfg.vocab_size),
              f"moe 1b logits ({impl}) not finite / wrong shape")
        return logits, rloss, rec.calls

    def max_rel(got, ref):
        return float((got - ref).abs().max()
                     / ref.abs().max().clamp_min(1e-30))

    ref_l, ref_r, ref_routes = run("xla")
    logits, rloss, routes = run("auto")
    flips, upto = routing_flips(ref_routes, routes, "moe 1b f32 trunk")
    out = {"flips": flips, "compared_positions": upto,
           "logits": max_rel(logits[:, :upto], ref_l[:, :upto])}
    if not flips:
        out["router_loss"] = abs(float(rloss - ref_r)) / abs(float(ref_r))
        for p in leaves:
            p.requires_grad_(True)
        ref_g = torch.autograd.grad(
            loss_fn(params, tokens, cfg32, impl="xla"), leaves)
        grads = torch.autograd.grad(
            loss_fn(params, tokens, cfg32, impl="auto"), leaves)
        out["grads_worst_leaf"] = max(max_rel(g, r)
                                      for g, r in zip(grads, ref_g))
    print(f"  moe 1b f32 trunk (B=1, S={s}), kernels vs reference "
          f"attention, max |err| over max |ref|: {out}", flush=True)
    errs = {k: v for k, v in out.items()
            if k not in ("flips", "compared_positions")}
    check(all(e <= F32_TOL for e in errs.values()),
          f"moe 1b f32 trunk err {errs} > {F32_TOL}")
    return out


def moe_train(torch, att, cfg):
    """7a: train_llama --family moe at moe_1b through the kernels, the
    launch counters set to 0 just before and read just after; then the
    trunk (moe_trunk_check)."""
    from gpu_docker_api_tpu_torch.workloads import train_llama

    b, s, steps = MOE_TRAIN["b"], MOE_TRAIN["s"], MOE_TRAIN["steps"]
    with tempfile.TemporaryDirectory() as wd:
        att.reset_launches()
        rc = train_llama.main([
            "--family", "moe", "--config", "1b", "--batch", str(b),
            "--seq", str(s), "--steps", str(steps), "--checkpoint-every",
            str(steps), "--workdir", wd])
        torch.cuda.synchronize()
        launches = dict(att.LAUNCHES)
        check(rc == 0, f"train_llama --family moe exited {rc}")
        step_recs, _ = read_metrics(os.path.join(wd, "metrics.jsonl"))
    losses = [r["loss"] for r in step_recs]
    want0 = moe_first_loss(cfg)
    print(f"  7a losses {losses} (at init, ln V + sigma^2/2 + router term = "
          f"{want0:.4f})", flush=True)
    print(f"  7a step_time_s {[r['step_time_s'] for r in step_recs]}",
          flush=True)
    print(f"  7a launches {launches}", flush=True)
    check([r["step"] for r in step_recs] == list(range(1, steps + 1)),
          f"moe step records {[r['step'] for r in step_recs]}")
    check(all(math.isfinite(x) for x in losses),
          f"non-finite moe loss {losses}")
    check(abs(losses[0] - want0) < 0.1,
          f"first moe loss {losses[0]} not near {want0:.3f}")
    # remat "dots" reruns each layer's forward in the backward
    want = {"flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps}
    check(launches == want, f"moe launches {launches}, want {want}")
    step_s = statistics.median(r["step_time_s"] for r in step_recs[1:])
    flops = moe_train_flops(cfg, b, s)
    out = {"launches": launches, "losses": losses, "first_loss_want": want0,
           "step_s": step_s, "tokens_s": b * s / step_s,
           "model_tflop_step": flops / 1e12,
           "flop_share": flops / step_s / PEAK_BF16_FLOPS}
    print(f"  7a step {step_s:.4f} s, {out['tokens_s']:.0f} tokens/s, model "
          f"FLOP share {out['flop_share']:.4f} ({flops / 1e12:.2f} TFLOP a "
          f"step, {flops / PEAK_BF16_FLOPS * 1e3:.1f} ms at the peak)",
          flush=True)
    out["trunk"] = moe_trunk_check(torch, cfg)
    return out


def scheduled_streams(b, tick, prompts, at, max_new, log=None):
    """Drive batcher `b` (the port's or the JAX package's) by hand: its
    scheduler thread is stopped, request i is submitted from a thread of
    its own just before tick at[i], and `tick` runs on this thread until
    every stream is back. A MoE decode step routes the whole slot batch
    together, so a stream depends on the schedule: this one is the same
    for every batcher it drives. log (a dict, the port's batchers only,
    unchunked prefill) receives what _record_schedule records. Returns the
    streams; the caller closes `b`."""
    b._stop = True
    b.thread.join(timeout=60)
    check(not b.thread.is_alive(), "the scheduler thread did not stop")
    b._stop = False
    if log is not None:
        _record_schedule(b, log)
    out, threads = [None] * len(prompts), []

    def ask(i):
        out[i] = b.submit(prompts[i], max_new)

    try:
        _drive(b, tick, ask, at, threads)
    finally:
        if log is not None:             # the batcher's own methods again
            del b._arm_or_finish, b._fn
    check(all(o is not None for o in out), "a scheduled request failed")
    return out


def _drive(b, tick, ask, at, threads):
    """scheduled_streams' loop: ask(i) on a new thread just before tick
    at[i], ticks until every thread is done."""
    import threading
    for k in range(100000):
        for i in [i for i, at_i in enumerate(at) if at_i == k]:
            before = b.queue.qsize()
            threads.append(threading.Thread(target=ask, args=(i,),
                                            daemon=True))
            threads[-1].start()
            t0 = time.perf_counter()
            while b.queue.qsize() == before:
                check(time.perf_counter() - t0 < 60, "a submit never queued")
                time.sleep(0.001)
        if k >= max(at) and not any(t.is_alive() for t in threads):
            break
        tick()
    for t in threads:
        t.join(timeout=60)


def _record_schedule(b, log):
    """Log a port batcher's steps (unchunked prefill, greedy decode):
    log["gaps"][prompt] gets the top-2 logit gap each of the request's
    tokens was picked at; log["events"] gets ("prefill", prompt) before
    each prefill and ("decode", [the prompt in each row, None where the
    row is inactive]) before each decode step, into which a
    RoutingRecorder on the same list appends each layer's routing."""
    arm, fn = b._arm_or_finish, b._fn
    gaps, events = log.setdefault("gaps", {}), log.setdefault("events", [])

    def arm_gap(i, item):
        top2 = item["_last_logits"][0].topk(2).values
        gaps[tuple(item["prompt"].tolist())] = [float(top2[0] - top2[1])]
        return arm(i, item)

    def fn_logged(name):
        f = fn(name)
        if name == "slot_prefill":
            def prefill(params, piece, cache, slot, config, append=False):
                events.append(("prefill", tuple(piece[0].tolist())))
                return f(params, piece, cache, slot, config, append=append)
            return prefill
        if name != "slot_decode":
            return f

        def decode(params, toks, cache, active, config):
            rows = [tuple(s["prompt"].tolist()) if a else None
                    for s, a in zip(b.slots, active)]
            events.append(("decode", rows))
            logits, cache = f(params, toks, cache, active, config)
            top2 = logits.topk(2, dim=-1).values
            g = (top2[:, 0] - top2[:, 1]).tolist()
            for i, key in enumerate(rows):
                if key is not None:
                    gaps[key].append(g[i])
            return logits, cache
        return decode

    b._arm_or_finish, b._fn = arm_gap, fn_logged


def schedule_moves(ref, got, label, tie_gap=TIE_GAP):
    """Two logs (_record_schedule) of the same schedule on two batchers.
    A request's routing may move from the reference's in two ways only:
    its own decision flips at a near tie (the reference's router
    probabilities of ranks 0..k within tie_gap; at most one such flip a
    run), or a capacity drop changes because another row's decision
    differs in the same layer: an inactive row (it decodes token 0 over a
    cache that the dense and the paged layouts hold differently) or a row
    already moved. Returns ({prompt: the index of its first token that
    may differ}, [near-tie flips (event, row, gap)])."""
    check(len(ref) == len(got), f"{label}: the logs differ in length")
    moved, emitted, flips = {}, {}, []
    for n, (r, g) in enumerate(zip(ref, got)):
        if isinstance(r[0], str):
            check(r == g, f"{label}: the schedules differ at step {n}")
            kind, what = r
            if kind == "prefill":
                # its layers route the request's T prompt tokens, whose
                # logits give token 0
                owner, token = None, {what: 0}
                emitted[what] = 1
                prefilled = what
            else:
                # one row a slot; each active row's step gives its next token
                owner, prefilled = what, None
                token = {k: emitted[k] for k in what if k is not None}
                for k in token:
                    emitted[k] += 1
            continue
        (ri, rk, rtop), (gi, gk, _) = r, g
        gate = (ri != gi).any(dim=-1).tolist()
        drop = (rk != gk).any(dim=-1).tolist()
        if not any(gate) and not any(drop):
            continue
        gaps = (rtop[:, :-1] - rtop[:, 1:]).min(dim=-1).values.tolist()
        rows = owner if prefilled is None else [prefilled] * len(gate)
        for i, key in enumerate(rows):
            if key is None or key in moved or not (gate[i] or drop[i]):
                continue
            if gate[i]:
                check(gaps[i] < tie_gap,
                      f"{label}: a routing decision differs at a router-"
                      f"probability gap of {gaps[i]:.3g} (a near tie is "
                      f"under {tie_gap})")
                flips.append((n, i, gaps[i]))
            moved[key] = token[key]
    check(len(flips) <= 1, f"{label}: {len(flips)} routing decisions "
                           f"differ at near ties (at most 1): {flips}")
    return moved, flips


def moe_batchers(torch, att, cfg, params, sizes=MOE_BATCH, device="cuda"):
    """7b's batchers: the dense and the paged _Batcher under one schedule
    (scheduled_streams), at the real capacity, every layer's routing
    logged. A paged stream must equal its dense stream up to the token
    where its routing moved for a reason schedule_moves allows, but at a
    near tie (the dense stream's top-2 gap under TIE_GAP, at most one
    stream); no flash kernel launches; then decode steps of both batchers
    make no device sync (on the card)."""
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.workloads.serve import _Batcher

    gen = torch.Generator(device=device).manual_seed(23)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=device) for n in sizes["lens"]]
    kw = dict(slots=sizes["slots"], max_len=sizes["max_len"])
    att.reset_launches()
    runs, logs, walls = {}, {}, {}
    for name, extra in (("dense", {}), ("paged",
                                         {"kv_block": sizes["kv_block"]})):
        b = _Batcher(cfg, params, **kw, **extra)
        log = logs[name] = {"events": []}
        try:
            def tick(b=b):
                with torch.no_grad():
                    b._tick()
            t0 = time.perf_counter()
            with RoutingRecorder(moe, log["events"]):
                runs[name] = scheduled_streams(
                    b, tick, prompts, sizes["at"], sizes["new"], log)
            walls[name] = time.perf_counter() - t0
            if b._paged:
                check_no_leak(b, "7b paged batcher")
            if device == "cuda":
                check_decode_sync_free(torch, b)
        finally:
            b.close()
    moved, flips = schedule_moves(logs["dense"]["events"],
                                  logs["paged"]["events"], "7b")
    keys = [tuple(q.tolist()) for q in prompts]
    ties, compared = 0, 0
    for i, (p, d, key) in enumerate(zip(runs["paged"], runs["dense"], keys)):
        m = moved.get(key, len(d))
        compared += m
        ties += near_tie_check(p[:m], d[:m], logs["dense"]["gaps"][key],
                               f"7b paged request {i}")
    check(ties <= 1, f"7b: {ties} paged streams left their dense streams at "
                     f"near ties (at most 1)")
    launches = dict(att.LAUNCHES)
    check(not any(launches.values()),
          f"the MoE batchers launched flash kernels: {launches}")
    return {"requests": len(prompts), "near_ties": ties,
            "routing_near_ties": flips,
            "moved": {keys.index(k): t for k, t in moved.items()},
            "tokens_compared": compared,
            "tokens": sum(len(d) for d in runs["dense"]),
            "streams_equal": sum(p == d for p, d in zip(runs["paged"],
                                                          runs["dense"])),
            "wall_s": walls, "launches": launches}


def host_load_limit(cfg, served) -> tuple[int, int]:
    """(bytes of the served int8 tree, bytes of the largest dense leaf):
    what --host-load's device peak may reach, their sum, since the device
    holds at most the int8 tree and one leaf in flight."""
    from gpu_docker_api_tpu_torch.models import param_shapes
    from gpu_docker_api_tpu_torch.train import tree_leaves
    tree = sum(leaf_bytes(t) for t in tree_leaves(served))
    largest = max(math.prod(shape) * dtype.itemsize
                  for shape, dtype in tree_leaves(param_shapes(cfg)))
    return tree, largest


def moe_host_load(torch, cfg):
    """--host-load in-process at moe_1b (w8): the device's peak allocation
    from a reset must stay within host_load_limit, and the tree must equal
    quantize_params of the ordinary seed-0 init bit for bit."""
    from gpu_docker_api_tpu_torch.ops.quant import QTensor, quantize_params
    from gpu_docker_api_tpu_torch.train import Trainer, tree_leaves
    from gpu_docker_api_tpu_torch.workloads.serve import _host_load, _load_params

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = _host_load(Trainer.create(cfg), "", "w8")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    tree, largest = host_load_limit(cfg, served)
    out = {"peak_bytes": peak, "int8_tree_bytes": tree,
           "largest_leaf_bytes": largest, "wall_s": wall}
    print(f"  7c host-load: {out}", flush=True)
    check(peak <= tree + largest,
          f"host-load peak {peak} bytes > int8 tree {tree} + largest leaf "
          f"{largest}")
    want = quantize_params(_load_params(Trainer.create(cfg), ""), "w8")
    for a, b in zip(tree_leaves(want), tree_leaves(served)):
        same = (torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
                if isinstance(a, QTensor) else torch.equal(a, b))
        check(same, "the host-load tree differs from --quantize w8's")
    out["equals_quantize_tree"] = True
    return out


def moe_host_load_http(torch, cfg, logs_dir, spec=MOE_GREEDY, name="1b",
                       extra_args=()):
    """serve --host-load --quantize w8 and serve --quantize w8, started
    together: the same greedy request to both must give the same tokens
    (and healthz the same data)."""
    gen = torch.Generator().manual_seed(spec["seed"])
    prompt = torch.randint(0, cfg.vocab_size, (spec["b"], spec["prompt"]),
                           generator=gen).tolist()
    procs = [spawn_serve(name, logs_dir, (*MOE_SERVE, *extra, *extra_args),
                         log_name=f"serve_moe_{i}.log")
             for i, extra in enumerate((("--quantize", "w8"),
                                        ("--host-load", "--quantize", "w8")))]
    try:
        ready = [wait_serve(*pr) for pr in procs]
        answers = [http_call(port, "POST", "/generate",
                             {"tokens": prompt, "max_new": spec["new"]})[0]
                   for _, port, _, _ in ready]
    finally:
        for proc, _, _ in procs:
            proc.kill()
            proc.wait(timeout=60)
    health = [h["data"] for _, _, _, h in ready]
    check(all(a["code"] == 200 for a in answers), f"greedy: {answers}")
    check(health[0] == health[1], f"healthz {health}")
    check(answers[0]["data"]["tokens"] == answers[1]["data"]["tokens"],
          "serve --host-load --quantize w8 and --quantize w8 differ")
    out = {"ready_s": [r[2] for r in ready], "tokens_equal": True,
           "params": health[0]["params"]}
    print(f"  7c host-load over HTTP: {out}", flush=True)
    return out


def phase_moe(torch, att):
    """Phase 7: the MoE family at moe_1b, full width and depth: 7a
    training through the kernels and the trunk; 7b serving in f32
    in-process; 7c serving in bf16 (the batcher over HTTP, decode times,
    --host-load)."""
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.ops.quant import quantize_params
    from gpu_docker_api_tpu_torch.train import Trainer
    from gpu_docker_api_tpu_torch.workloads.serve import _load_params

    cfg = moe.MoEConfig.moe_1b()
    print(f"phase 7: MoE, moe_1b (7a train_llama --family moe --config 1b "
          f"{MOE_TRAIN}; 7b f32 {MOE_ORACLE}, {MOE_BATCH}; 7c bf16 "
          f"{MOE_TRAFFIC}, {MOE_TIME})", flush=True)
    wall = {}
    t0 = time.perf_counter()
    train = moe_train(torch, att, cfg)
    torch.cuda.empty_cache()
    wall["7a_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    oracle = serve_oracle(
        torch, att, dataclasses.replace(
            cfg32, capacity_factor=MOE_ORACLE["capacity_factor"]),
        MOE_ORACLE["b"], MOE_ORACLE["prompt"], MOE_ORACLE["steps"], False,
        F32_TOL)
    print(f"  7b f32 against moe_forward (capacity factor "
          f"{MOE_ORACLE['capacity_factor']}, tol {F32_TOL}): {oracle}",
          flush=True)
    check(oracle["flash_fwd_launches"] == cfg.n_layers,
          f"the 7b oracle's forward launched flash_fwd "
          f"{oracle['flash_fwd_launches']} times, want {cfg.n_layers}")
    params = moe.init_params(cfg32, torch.Generator(device="cuda")
                             .manual_seed(0))
    batchers = moe_batchers(torch, att, cfg32, params)
    print(f"  7b batchers: {batchers}", flush=True)
    del params
    torch.cuda.empty_cache()
    wall["7b_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as logs:
        http = batching_http(torch, "1b", cfg, logs, 1, traffic=MOE_TRAFFIC,
                             extra_args=MOE_SERVE)
        print(f"  7c HTTP: {http}", flush=True)
        wall["7c_http_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        host_http = moe_host_load_http(torch, cfg, logs)
        wall["7c_host_load_http_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = _load_params(Trainer.create(cfg), "")
    times = {}
    for b in (1, 8):
        times[f"bf16_b{b}"] = serve_times(torch, cfg, params, f"moe bf16 B={b}",
                                          b, **MOE_TIME)
    w8 = quantize_params(params, "w8")
    del params
    for b in (1, 8):
        times[f"w8_b{b}"] = serve_times(torch, cfg, w8, f"moe w8 B={b}", b,
                                        **MOE_TIME)
    del w8
    torch.cuda.empty_cache()
    wall["7c_times_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_load = moe_host_load(torch, cfg)
    torch.cuda.empty_cache()
    wall["7c_host_load_s"] = time.perf_counter() - t0
    print(f"  phase 7 wall time {wall}", flush=True)
    return {"train": train, "oracle": oracle, "batchers": batchers,
            "http": http, "times": times, "host_load": host_load,
            "host_load_http": host_http, "wall": wall}


# ---- phase 8: long context and sequence parallelism ----------------------

LONG_HEADS = dict(h=16, hkv=8, d=128)   # llama 1b's attention width
LONG_CHUNK = 2048                        # ops/attention.FLASH_CHUNK_SEQ
LONG_S = 16384                           # 8a: 8 chunks
LONG_F32_S = 8192                        # 8a: the f32 case
LONG_WINDOW = 4096                       # mistral_7b's sliding window
LONG_TIME_ITERS = 10
SP_RANKS = 4
SP_S = 8192                              # 8b: 2048 tokens a rank
SP_F32_S = 4096                          # 8b's f32 cases: the first 4096
SP_CONFIG = "1b"                         # 8c: llama 1b, full depth
SP_TRUNK_S = 1024                        # 8c: the f32 trunk, B=1
SP_TRAIN = dict(b=1, s=8192, steps=2)    # 8c: bf16, remat "dots"
SP_DEADLINE_S = 480                      # the ranks' whole run
# 8c: the sp=4 trainer's losses and grad norms against sp=1's, relative.
# scripts/torch_sp_margin.py on the H100 over four seeds (24 readings each,
# ring and Ulysses, PERF.md): losses at most 5.3e-5 apart, grad norms
# 1.6e-3; the limits sit at about 4x and 3x those (bf16 summation order:
# the shards' GEMMs, the f32 all-reduce, the ring's merges).
SP_LOSS_TOL = 2e-4
SP_NORM_TOL = 5e-3
GRAD_NAMES = ("out", "dq", "dk", "dv")


def blockwise_launches(s, chunk, window=0, stack=32) -> int:
    """Launches of each kernel in one causal blockwise_attention forward
    (the same in the backward, for dq and dk/dv): without a window one
    stacked diagonal launch plus the n(n-1)/2 past pairs in groups of the
    largest power of two up to `stack` that fits; with one, n windowed
    diagonals plus the past pairs wholly inside the window."""
    n = s // chunk
    if not window:
        pairs, groups = n * (n - 1) // 2, 0
        while pairs:
            pairs -= 1 << min(pairs.bit_length(), stack.bit_length()) - 1
            groups += 1
        return 1 + groups
    return n + sum(1 for i in range(n) for j in range(i)
                   if (i - j) * chunk <= window - chunk)


def sp_launches(case, rank) -> int:
    """Launches of each kernel on `rank` for one forward and backward of
    an 8b case: the causal flash ring runs the pairs at or behind the
    diagonal (rank + 1), the windowed ring its diagonal only (the shards
    behind are banded einsums), Ulysses one whole-sequence call, the
    einsum ring none."""
    return {"ring": rank + 1, "ring-window": 1, "ring-einsum": 0,
            "ulysses": 1}[case]


def long_readings(torch, got, ref):
    """(||err|| / ||ref||, max |err| / max |ref|) of one tensor against its
    f32 reference."""
    got, ref = got.float(), ref.float()
    err = got - ref
    return (float(err.norm() / ref.norm().clamp_min(1e-30)),
            float(err.abs().max() / ref.abs().max().clamp_min(1e-30)))


def long_check(torch, got, ref, kernel, label):
    """Each of out, dq, dk, dv: f32 (`kernel` None) within F32_TOL of
    `ref` element by element; bf16 within phase 1's element-by-element
    check of `ref` (bf16_ok), and its Frobenius error at most TRUNK_MARGIN
    times the bf16 whole-S kernel's (`kernel`), both against the f32
    `ref`. The largest element's error is read, not held: every value is
    rounded to bf16 once more for each partial a pair or a hop adds, and
    where two roundings fall the same way one element's error doubles.
    Returns {name: readings}; raises SmokeFailure."""
    out = {}
    for name, g, r, k in zip(GRAD_NAMES, got, ref,
                             kernel or [None] * len(got)):
        check(bool(torch.isfinite(g).all()), f"{label} {name}: not finite")
        if k is None:
            err = (g.float() - r.float()).abs()
            ok = bool((err <= F32_TOL + F32_TOL * r.float().abs()).all())
            out[name] = float(err.max())
            check(ok, f"{label} {name}: max |err| {out[name]} past "
                      f"{F32_TOL} (1 + |ref|)")
            continue
        mine, base = long_readings(torch, g, r), long_readings(torch, k, r)
        band = bf16_readings(torch, g, r)
        out[name] = {"frob": mine[0], "max": mine[1], "kernel_frob": base[0],
                     "kernel_max": base[1],
                     "excess": mine[0] / max(base[0], 1e-30),
                     "band_ratio": band[0]}
        check(bf16_ok(band), f"{label} {name}: bf16 (ratio, frob) {band} "
                             f"past ({BF16_TOL}, {BF16_FROB})")
        check(out[name]["excess"] <= TRUNK_MARGIN,
              f"{label} {name}: Frobenius error {mine[0]} over "
              f"{TRUNK_MARGIN} x the whole-S bf16 kernel's {base[0]}")
    return out


def long_inputs(torch, s, seed, dtype=None, device="cuda"):
    """q, k, v, do [1, s, H, D] at llama 1b's attention width, bf16-valued
    (from `seed`), in `dtype` (bf16 by default)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, hkv, d = (LONG_HEADS[x] for x in ("h", "hkv", "d"))
    return [torch.randn(1, s, n, d, generator=gen, device=device)
            .to(torch.bfloat16).to(dtype or torch.bfloat16)
            for n in (h, hkv, hkv, h)]


def fwd_bwd(torch, fn, q, k, v, do):
    """[out, dq, dk, dv] of fn(q, k, v) with the cotangent do."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    return [out.detach(), *torch.autograd.grad(out, leaves, do)]


def long_blockwise(torch, att, device="cuda"):
    """8a: blockwise_attention at llama 1b's attention width in one
    process, against the whole-S kernels."""
    out = {}
    for window in (0, LONG_WINDOW):
        label = f"blockwise bf16 S={LONG_S} window={window}"
        q, k, v, do = long_inputs(torch, LONG_S, 80 + window, device=device)

        def whole(q, k, v, window=window):
            return att.flash_attention(q, k, v, window=window)

        def blocks(q, k, v, window=window):
            return att.blockwise_attention(q, k, v, window=window,
                                           chunk=LONG_CHUNK)

        ref = fwd_bwd(torch, whole, *(x.float() for x in (q, k, v, do)))
        kernel = fwd_bwd(torch, whole, q, k, v, do)
        att.reset_launches()
        got = fwd_bwd(torch, blocks, q, k, v, do)
        torch.cuda.synchronize()
        launches = dict(att.LAUNCHES)
        want = blockwise_launches(LONG_S, LONG_CHUNK, window)
        check(launches == dict.fromkeys(launches, want),
              f"{label}: launches {launches}, want {want} of each")
        readings = long_check(torch, got, ref, kernel, label)
        del ref, kernel, got
        times = {"blockwise_ms": time_ms(torch, lambda: fwd_bwd(
                     torch, blocks, q, k, v, do), LONG_TIME_ITERS),
                 "whole_ms": time_ms(torch, lambda: fwd_bwd(
                     torch, whole, q, k, v, do), LONG_TIME_ITERS)}
        out[f"bf16_window{window}"] = {"launches": launches,
                                       "readings": readings, **times}
        print(f"  8a {label}: launches {launches}, fwd+bwd {times}, "
              f"readings {readings}", flush=True)
        q32, k32, v32, do32 = long_inputs(torch, LONG_F32_S, 90 + window,
                                          torch.float32, device)
        label = f"blockwise f32 S={LONG_F32_S} window={window}"
        got = fwd_bwd(torch, lambda q, k, v: att.blockwise_attention(
            q, k, v, window=window, chunk=LONG_CHUNK), q32, k32, v32, do32)
        ref = fwd_bwd(torch, lambda q, k, v: att.flash_attention(
            q, k, v, window=window), q32, k32, v32, do32)
        out[f"f32_window{window}"] = long_check(torch, got, ref, None, label)
        print(f"  8a {label}: max |err| {out[f'f32_window{window}']}",
              flush=True)
        del q, k, v, do, q32, k32, v32, do32, got, ref
        torch.cuda.empty_cache()
    return out


SP_CASES = {  # name: (function, impl, window)
    "ring": ("ring", "auto", 0),
    "ring-window": ("ring", "auto", LONG_WINDOW),
    "ring-einsum": ("ring", "xla", 0),
    "ulysses": ("ulysses", "auto", 0),
}


def sp_rank(rank, world, tmp, spec):
    """One of phase 8's ranks (distributed.launch, gloo, every rank on
    spec["device"], cuda:0): 8b's cases on its shard of tmp/inputs.pt, then
    8c's f32 trunk and bf16 training of llama spec["config"]; its results
    to tmp/rank<r>.pt."""
    import torch

    from gpu_docker_api_tpu_torch.device import resolve_device
    from gpu_docker_api_tpu_torch.models import named_config
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan

    device = resolve_device(spec["device"])
    cfg = named_config("llama", spec["config"])
    groups = MeshGroups.build(MeshPlan(sp=world))
    inputs = torch.load(os.path.join(tmp, "inputs.pt"))
    res = {"cases": sp_cases(torch, groups.sp, device, inputs,
                             (torch.bfloat16, torch.float32), spec["f32_s"])}
    del inputs
    torch.cuda.empty_cache()
    res["trunk"] = sp_trunk(torch, groups, device, cfg, spec["trunk_s"])
    torch.cuda.empty_cache()
    for attn in ("ring", "ulysses"):
        res[f"train_{attn}"] = sp_train(torch, device, cfg, spec["train"],
                                        attn, groups)
        torch.cuda.empty_cache()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def sp_cases(torch, sp, device, inputs, dtypes, f32_s=None):
    """8b on this rank: each of SP_CASES in each dtype on the rank's shard
    of the global `inputs` (q, k, v, do; f32 on their first f32_s
    positions). -> {(name, dtype): {launches, shards: [out, dq, dk, dv] on
    the host}}."""
    from gpu_docker_api_tpu_torch.ops import attention as att
    from gpu_docker_api_tpu_torch.parallel import comm, ring, ulysses

    out = {}
    for dtype in dtypes:
        s = f32_s if dtype == torch.float32 else None
        q, k, v, do = (comm.local_shard(x[:, :s], sp).to(device, dtype)
                       for x in inputs)
        for name, (fn, impl, window) in SP_CASES.items():
            f = (ring.ring_attention if fn == "ring"
                 else ulysses.ulysses_attention)
            att.reset_launches()
            got = [t.cpu() for t in fwd_bwd(torch, lambda q, k, v: f(
                q, k, v, sp, impl=impl, window=window), q, k, v, do)]
            out[(name, str(dtype))] = {"launches": dict(att.LAUNCHES),
                                       "shards": got}
    return out


def sp_refs(torch, att, q, k, v, do):
    """{window: {"f32": the f32 whole-S kernels' [out, dq, dk, dv],
    "bf16": the bf16 whole-S kernels', "f32_short": the f32 whole-S
    kernels' on the first SP_F32_S positions}} on the host, for each window
    of SP_CASES."""
    refs = {}
    for window in sorted({w for _, _, w in SP_CASES.values()}):
        def whole(q, k, v, window=window):
            return att.flash_attention(q, k, v, window=window)
        refs[window] = {
            "f32": [t.cpu() for t in fwd_bwd(torch, whole, *(
                x.float() for x in (q, k, v, do)))],
            "bf16": [t.cpu() for t in fwd_bwd(torch, whole, q, k, v, do)],
            "f32_short": [t.cpu() for t in fwd_bwd(torch, whole, *(
                x[:, :SP_F32_S].float() for x in (q, k, v, do)))]}
    return refs


def sp_trunk(torch, groups, device, cfg, s, seed=7):
    """8c, on each rank of an sp plan (parallel.mesh.MeshGroups): the trunk
    of cfg in f32 (B=1, S=s) from rank 0's init, its logits shard, its
    global loss and its gradients summed over the group, against the
    one-rank forward and loss on the same init and batch (the gradients on
    rank 0). Readings: max |err| over max |ref|."""
    from gpu_docker_api_tpu_torch.models import llama
    from gpu_docker_api_tpu_torch.parallel import comm
    from gpu_docker_api_tpu_torch.train import Trainer, loss_fn, tree_leaves

    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    sp = groups.sp
    trainer = Trainer.create(cfg, groups.plan, device=device, groups=groups)
    params = trainer.init(seed=seed)["params"]
    leaves = tree_leaves(params)
    tokens = torch.randint(0, cfg.vocab_size, (1, s),
                           generator=torch.Generator().manual_seed(seed)
                           ).to(device)
    s_loc = s // sp.size

    def max_rel(got, ref):
        return float((got - ref).abs().max() / ref.abs().max().clamp_min(
            1e-30))

    with torch.no_grad():
        logits = llama.llama_forward(
            params, comm.local_shard(tokens, sp), cfg, sp=sp)
        ref = llama.llama_forward(params, tokens, cfg)
        out = {"logits": max_rel(logits, comm.local_shard(ref, sp))}
        check(logits.shape == (1, s_loc, cfg.vocab_size),
              f"logits shard {tuple(logits.shape)}")
    del logits, ref
    loss = loss_fn(params, tokens, cfg, sp=sp)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    comm.all_reduce_sum([*grads, loss], sp)
    out["loss"] = float(loss)
    if sp.rank == 0:
        ref_loss = loss_fn(params, tokens, cfg)
        ref_grads = torch.autograd.grad(ref_loss, leaves)
        out["loss_ref"] = float(ref_loss)
        out["grads_worst_leaf"] = max(max_rel(g, r) for g, r in
                                      zip(grads, ref_grads))
        del ref_grads
    del grads, params, leaves, trainer
    return out


def sp_train(torch, device, cfg, train, attn, groups=None, seed=0,
             microbatches=0):
    """8c and phase 9's one-rank run: Trainer of cfg (remat "dots"),
    B=train["b"], S=train["s"], for train["steps"] steps from init `seed`
    on batches drawn from (seed, step); over `groups`
    (parallel.mesh.MeshGroups) this rank's part. With `microbatches` (one
    rank, phase 12's MoE reference) the loss is the pipeline's plain
    version, pipeline.microbatched_loss: the microbatches one after
    another, each routed on its own. -> losses, grad norms, step times
    (host clock, each ending in the loss read)."""
    from gpu_docker_api_tpu_torch.parallel import pipeline
    from gpu_docker_api_tpu_torch.train import Trainer

    cfg = dataclasses.replace(cfg, sp_attn=attn)
    b, s = train["b"], train["s"]
    trainer = Trainer.create(cfg, groups.plan if groups else None,
                             device=device, groups=groups)
    if microbatches:
        trainer._loss = lambda params, tokens: pipeline.microbatched_loss(
            params, tokens, cfg, microbatches, remat="dots")
    state = trainer.init(seed=seed)
    losses, norms, times = [], [], []
    for step in range(train["steps"]):
        tokens = trainer.shard_batch(train_batch(torch, cfg, b, s, seed,
                                                 step))
        t0 = time.perf_counter()
        state, m = trainer.step(state, tokens)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
    del state, trainer
    return {"losses": losses, "grad_norms": norms, "step_times_s": times}


def train_batch(torch, cfg, b, s, seed, step):
    """The global batch of (seed, step) on the host, as every rank and the
    one-rank run draw it."""
    return torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(
                             1000 * seed + step))


def sp_train_check(one, ranks, label, tols=None):
    """8c's bf16 runs: every rank reports the same global numbers; the
    first loss near its value at init; each step's loss and grad norm
    within tols (relative; SP_LOSS_TOL / SP_NORM_TOL by default) of the
    one-rank run's."""
    loss_tol, norm_tol = tols or (SP_LOSS_TOL, SP_NORM_TOL)
    for r in ranks:
        check(r["losses"] == ranks[0]["losses"]
              and r["grad_norms"] == ranks[0]["grad_norms"],
              f"{label}: ranks report different numbers")
    got = ranks[0]
    rel = {"loss": [abs(a / b - 1) for a, b in zip(got["losses"],
                                                    one["losses"])],
           "grad_norm": [abs(a / b - 1) for a, b in zip(got["grad_norms"],
                                                         one["grad_norms"])]}
    check(all(math.isfinite(x) for x in got["losses"] + got["grad_norms"]),
          f"{label}: non-finite {got}")
    check(max(rel["loss"]) <= loss_tol and max(rel["grad_norm"]) <= norm_tol,
          f"{label}: against sp=1 {rel}, limits {loss_tol} / "
          f"{norm_tol}")
    return rel


def long_launches(sp, name):
    """{path: launches of kernel `name`} of phase 8's paths: blockwise
    causal and windowed (8a), the causal flash ring and Ulysses over the
    ranks (8b, bf16, summed over ranks)."""
    out = {f"blockwise_window{w}": sp["blockwise"][f"bf16_window{w}"]
           ["launches"][name] for w in (0, LONG_WINDOW)}
    for case in ("ring", "ulysses"):
        out[f"{case}_{SP_RANKS}_ranks"] = sum(
            r[name] for r in sp["cases"][f"{case} torch.bfloat16"]["launches"])
    return out


def phase_sp(torch, att, device="cuda"):
    """Phase 8: long context and sequence parallelism at llama 1b's
    attention width. 8a blockwise_attention in this process; 8b ring and
    Ulysses attention over SP_RANKS processes on this one card (a gloo
    group, named: NCCL refuses two ranks on one GPU); 8c the trainer over
    them, against one rank."""
    from gpu_docker_api_tpu_torch import distributed
    from gpu_docker_api_tpu_torch.models import named_config

    cfg = named_config("llama", SP_CONFIG)
    print(f"phase 8: long context and sp (8a blockwise S={LONG_S}, chunk "
          f"{LONG_CHUNK}; 8b ring/ulysses over {SP_RANKS} gloo ranks on one "
          f"card, S={SP_S}, f32 at {SP_F32_S}; 8c llama 1b trainer over "
          f"them, {SP_TRAIN})",
          flush=True)
    wall = {}
    t0 = time.perf_counter()
    blockwise = long_blockwise(torch, att, device)
    wall["8a_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    q, k, v, do = long_inputs(torch, SP_S, 88, device=device)
    refs = sp_refs(torch, att, q, k, v, do)
    one = sp_train(torch, device, cfg, SP_TRAIN, "ring")
    torch.cuda.empty_cache()
    wall["8bc_parent_s"] = time.perf_counter() - t0
    print(f"  8c one rank: {one}", flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save([x.cpu() for x in (q, k, v, do)],
                   os.path.join(tmp, "inputs.pt"))
        del q, k, v, do
        spec = {"device": f"{device}:0" if device == "cuda" else device,
                "config": SP_CONFIG, "trunk_s": SP_TRUNK_S,
                "f32_s": SP_F32_S,
                "train": SP_TRAIN}
        distributed.launch(sp_rank, (tmp, spec), SP_RANKS, "gloo",
                           timeout=SP_DEADLINE_S)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(SP_RANKS)]
    wall["8bc_ranks_s"] = time.perf_counter() - t0

    cases = {}
    for (name, dtype), _ in ranks[0]["cases"].items():
        window = SP_CASES[name][2]
        bf16 = dtype == str(torch.bfloat16)
        label = f"8b {name} {dtype} over {SP_RANKS} ranks"
        per_rank = []
        for r, res in enumerate(ranks):
            got = res["cases"][(name, dtype)]
            want = sp_launches(name, r)
            check(got["launches"] == dict.fromkeys(got["launches"], want),
                  f"{label}: rank {r} launches {got['launches']}, want "
                  f"{want} of each")

            def shard(ts):
                return [t.chunk(SP_RANKS, dim=1)[r] for t in ts]
            per_rank.append(long_check(
                torch, got["shards"],
                shard(refs[window]["f32" if bf16 else "f32_short"]),
                shard(refs[window]["bf16"]) if bf16 else None,
                f"{label}, rank {r}"))
        cases[f"{name} {dtype}"] = {
            "launches": [res["cases"][(name, dtype)]["launches"]
                         for res in ranks], "readings": per_rank}
        print(f"  {label}: launches "
              f"{cases[f'{name} {dtype}']['launches']}, readings {per_rank}",
              flush=True)

    trunk = [r["trunk"] for r in ranks]
    print(f"  8c f32 trunk (B=1, S={SP_TRUNK_S}) over {SP_RANKS} ranks "
          f"against one: {trunk}", flush=True)
    check(all(t["logits"] <= F32_TOL for t in trunk),
          f"8c f32 logits shards past {F32_TOL}: {trunk}")
    check(abs(trunk[0]["loss"] / trunk[0]["loss_ref"] - 1) <= F32_TOL
          and all(t["loss"] == trunk[0]["loss"] for t in trunk),
          f"8c f32 loss {trunk}")
    check(trunk[0]["grads_worst_leaf"] <= F32_TOL,
          f"8c f32 grads past {F32_TOL}: {trunk[0]['grads_worst_leaf']}")

    want0 = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    check(abs(one["losses"][0] - want0) < 0.1,
          f"8c first loss {one['losses'][0]} not near {want0:.3f}")
    train = {"one_rank": one}
    tokens = SP_TRAIN["b"] * SP_TRAIN["s"]
    for attn in ("ring", "ulysses"):
        runs = [r[f"train_{attn}"] for r in ranks]
        rel = sp_train_check(one, runs, f"8c bf16 {attn}")
        step_s = statistics.median(runs[0]["step_times_s"][1:])
        train[attn] = {**runs[0], "rel_to_one_rank": rel,
                       "step_s_gloo_4_ranks_one_card": step_s,
                       "tokens_s_gloo_4_ranks_one_card": tokens / step_s}
        print(f"  8c bf16 {attn} (gloo, 4 ranks on one card): "
              f"{train[attn]}", flush=True)
    train["one_rank"]["step_s"] = statistics.median(one["step_times_s"][1:])
    train["one_rank"]["tokens_s"] = tokens / train["one_rank"]["step_s"]
    print(f"  phase 8 wall time {wall}", flush=True)
    return {"blockwise": blockwise, "cases": cases, "trunk": trunk,
            "train": train, "wall": wall}


# ---- phase 9: data parallelism and fully-sharded parameters -----------------

FSDP_RANKS = 4
# llama 1b at full width, 10 of its 20 layers: the depth cut that makes
# room for phase 11 (PERF.md §4); phase 10 takes the same
FSDP_CONFIG = ("llama", "1b", 10)
FSDP_TRAIN = dict(b=4, s=2048, steps=2)  # phase 2's shape; bf16, "dots"
FSDP_LAYOUTS = {                         # name: (plan, steps)
    "9a": ({"fsdp": 4}, 2),
    "9b": ({"dp": 2, "fsdp": 2}, 2),
    "9c": ({"fsdp": 2, "sp": 2}, 2),     # the ring
}
LAYOUTS_DEADLINE_S = 600                 # a phase's ranks' whole run


def smoke_config(spec):
    """The config of a multi-rank phase: a llama config name at full
    depth, or (family, name, n_layers), n_layers None for the full
    depth."""
    from gpu_docker_api_tpu_torch.models import named_config
    family, name, depth = (("llama", spec, None) if isinstance(spec, str)
                           else spec)
    cfg = named_config(family, name)
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def first_loss(cfg) -> float:
    """The loss at init of cfg's family: ln V + sigma^2 / 2 (llama), plus
    the router term for MoE (moe_first_loss)."""
    from gpu_docker_api_tpu_torch.models import family_for
    if family_for(cfg).returns_extra_loss:
        return moe_first_loss(cfg)
    return math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2


def shard_bytes(cfg, plan) -> dict:
    """{path: the bytes of one rank's shard of each parameter leaf} under
    `plan` (MeshPlan fields): each leaf's whole bytes over the sizes of
    the axes its spec cuts it by (mesh.split_dims of train.param_specs: a
    matrix 1/(fsdp * tp), an expert bank also 1/ep, under pp every layer
    leaf also 1/pp, the norms and the f32 router whole)."""
    from gpu_docker_api_tpu_torch.models import param_shapes
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshPlan, split_dims
    from gpu_docker_api_tpu_torch.train import param_specs, tree_map_named

    mplan = MeshPlan(**plan)

    def one(_, shape_dtype, spec):
        shape, dtype = shape_dtype
        cut = math.prod(getattr(mplan, a) for a, _ in split_dims(spec, mplan))
        return math.prod(shape) * dtype.itemsize // cut
    return dict(flat_leaves(tree_map_named(
        one, param_shapes(cfg), param_specs(cfg, mplan.pp > 1))))


def state_bytes(cfg, plan) -> int:
    """What one rank of `plan` (MeshPlan fields) must hold of the
    parameters, mu and nu (shard_bytes, three times over: the moments are
    in the params' dtype)."""
    return 3 * sum(shard_bytes(cfg, plan).values())


def fsdp_state_bytes(cfg, fsdp, tp=1) -> int:
    """state_bytes of one rank of an fsdp x tp group."""
    return state_bytes(cfg, {"fsdp": fsdp, "tp": tp})


def fsdp_launches(plan, sp_rank, n_layers, microbatches=1) -> dict:
    """Launches of each kernel a rank makes in one step under remat
    "dots" (the forward reruns in the backward), or under pp the stage's
    remat: one flash call a layer visit, or under sp the causal ring's
    sp_rank + 1 pairs. Under pp a rank visits its n_layers/pp layers once
    a microbatch (bubble ticks compute nothing)."""
    pairs = sp_rank + 1 if plan.get("sp", 1) > 1 else 1
    pp = plan.get("pp", 1)
    visits = n_layers // pp * (microbatches if pp > 1 else 1)
    return {"flash_fwd": 2 * pairs * visits,
            "flash_bwd_dq": pairs * visits,
            "flash_bwd_dkv": pairs * visits}


def leaf_digest(t) -> str:
    """sha256 of a tensor's bytes."""
    import hashlib

    import torch
    return hashlib.sha256(t.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy()).hexdigest()


def flat_leaves(tree) -> list:
    """[(path, leaf)] of a nested dict, paths as "layers.wq"."""
    from gpu_docker_api_tpu_torch.train import tree_leaves, tree_map_named
    return tree_leaves(tree_map_named(lambda path, t: (path, t), tree))


def state_digests(state) -> dict:
    """{"params" | "mu" | "nu": {path: leaf_digest}} of a train state."""
    opt = state["opt_state"]
    return {part: {path: leaf_digest(t) for path, t in flat_leaves(tree)}
            for part, tree in (("params", state["params"]), ("mu", opt["mu"]),
                               ("nu", opt["nu"]))}


def layout_fields(entry) -> tuple:
    """(config spec, plan, sp_attn, steps, opts) of a layout of phases
    9-12; opts (phase 12): "tc", TrainConfig fields (n_microbatches,
    virtual_stages), and "b", the layout's own batch."""
    return (*entry[:4], entry[4] if len(entry) > 4 else {})


def layout_rank(rank, world, tmp, spec):
    """One rank of phases 9-12 (distributed.launch, gloo, every rank on
    spec["device"]): each layout of spec["layouts"] ({name: (config spec,
    plan, sp_attn, steps[, opts])}, smoke_config, layout_fields) in turn,
    a Trainer over its groups from init 0; the bytes of each leaf of its params, mu and nu
    after init; a step at a time (spec["train"]'s batches) its launches,
    tp sums, the q heads the forward kernel saw, losses, grad norms and
    step times; for MoE, first, each layer's routing of the first batch in
    an f32 forward (f32_routes); its peak allocation; after
    spec["checkpoint"]'s last step the gathered checkpoint (rank 0 writes
    it to tmp/ckpt) and this rank's shard digests. Results to
    tmp/rank<r>.pt."""
    import torch

    from gpu_docker_api_tpu_torch.device import resolve_device
    from gpu_docker_api_tpu_torch.models import family_for
    from gpu_docker_api_tpu_torch.ops import attention as att
    from gpu_docker_api_tpu_torch.parallel import comm
    from gpu_docker_api_tpu_torch.parallel.mesh import (
        MeshGroups, MeshPlan, coords,
    )
    from gpu_docker_api_tpu_torch.train import (
        Trainer, TrainConfig, save_checkpoint,
    )

    device = resolve_device(spec["device"])
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()   # the allocator, before its peak is reset
    sums, heads = TpSums(comm), record_heads(att)
    s = spec["train"]["s"]
    res = {}
    for name, entry in spec["layouts"].items():
        config, plan_d, attn, steps, opts = layout_fields(entry)
        b = opts.get("b", spec["train"]["b"])
        plan = MeshPlan(**plan_d)
        cfg = dataclasses.replace(smoke_config(config), sp_attn=attn)
        # the f32 routing check reads one forward's calls in layer order:
        # phase 11's layouts (a pipeline's stages see their own layers)
        routed = family_for(cfg).returns_extra_loss and plan.pp == 1
        groups = MeshGroups.build(plan)
        routes = (f32_routes(torch, cfg, groups, device, train_batch(
            torch, cfg, b, s, 0, 0)) if routed else None)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        trainer = Trainer.create(cfg, plan, tc=TrainConfig(
            **opts.get("tc", {})), device=device, groups=groups)
        state = trainer.init(seed=0)
        opt = state["opt_state"]
        out = {"leaf_bytes": {part: {path: leaf_bytes(t)
                                     for path, t in flat_leaves(tree)}
                              for part, tree in (("params", state["params"]),
                                                 ("mu", opt["mu"]),
                                                 ("nu", opt["nu"]))},
               "launches": [], "tp_sums": [], "heads": [], "losses": [],
               "grad_norms": [], "step_times_s": [],
               "sp_rank": coords(plan, rank)["sp"],
               "coords": coords(plan, rank), "routes": routes}
        for step in range(steps):
            tokens = trainer.shard_batch(train_batch(torch, cfg, b, s, 0,
                                                     step))
            att.reset_launches()
            sums.take()
            heads.clear()
            t0 = time.perf_counter()
            state, m = trainer.step(state, tokens)
            out["losses"].append(float(m["loss"]))
            out["step_times_s"].append(time.perf_counter() - t0)
            out["grad_norms"].append(float(m["grad_norm"]))
            out["launches"].append(dict(att.LAUNCHES))
            out["tp_sums"].append(sums.take())
            out["heads"].append(sorted(heads))
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                             if on_card else None)
        if name == spec["checkpoint"]:
            t0 = time.perf_counter()
            full = trainer.full_state(state)
            if full is not None:
                save_checkpoint(os.path.join(tmp, "ckpt"), full, steps)
            del full
            out["digests"] = state_digests(state)
            out["checkpoint_s"] = time.perf_counter() - t0
        res[name] = out
        del state, opt, trainer, m
        if on_card:
            torch.cuda.empty_cache()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def layout_template(cfg, plan, tc=None):
    """(the abstract state a layout's checkpoint is restored under, its
    parameters' specs): the one-rank template, but under the interleaved
    schedule the trainer's own, the layers grouped [v, pp, Lc, ...]."""
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan
    from gpu_docker_api_tpu_torch.train import (
        Trainer, TrainConfig, param_specs,
    )

    mplan, tc = MeshPlan(**plan), TrainConfig(**(tc or {}))
    if mplan.pp > 1 and tc.virtual_stages > 1:
        tr = Trainer.create(cfg, mplan, tc=tc, device="cpu",
                            groups=MeshGroups(mplan, 0))
    else:
        tr = Trainer.create(cfg, device="cpu")
    return (tr.abstract_state(),
            param_specs(cfg, mplan.pp > 1, tc.virtual_stages))


def check_resharded_checkpoint(path, cfg, ranks, plan, steps,
                               layout="9a", tc=None) -> int:
    """A layout's gathered checkpoint restored under its template
    (layout_template: the one-rank one, grouped under the interleaved
    schedule): its step and count, and each leaf of params, mu and nu
    equal, bit for bit, to the ranks' shards reassembled over the plan's
    axes (by their digests: each rank's digest is that of its slice of
    the restored leaf, mesh.shard; the norms whole on every rank). -> the
    shards compared."""
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshPlan, shard
    from gpu_docker_api_tpu_torch.train import restore_checkpoint

    template, specs = layout_template(cfg, plan, tc)
    state, step = restore_checkpoint(path, template)
    opt = state["opt_state"]
    check(step == steps and state["step"] == steps
          and opt["count"] == steps,
          f"{layout} checkpoint at step {step}, state {state['step']}, "
          f"count {opt['count']}; want {steps}")
    specs = dict(flat_leaves(specs))
    plan = MeshPlan(**plan)
    n = 0
    for part, tree in (("params", state["params"]), ("mu", opt["mu"]),
                       ("nu", opt["nu"])):
        for path, t in flat_leaves(tree):
            for r, res in enumerate(ranks):
                piece = shard(t, specs[path], plan, r, path)
                check(leaf_digest(piece) ==
                      res[layout]["digests"][part][path],
                      f"{layout} checkpoint {part} {path}: rank {r}'s shard "
                      f"differs")
                n += 1
    return n


def fsdp_kernel_launches(readings, name) -> dict:
    """{layout: [launches of kernel `name` a step, a rank]} of phase 9's
    or phase 10's readings."""
    return {k: [launches[name] for launches in v["launches_a_step"]]
            for k, v in readings["layouts"].items()}


def run_layouts(torch, device, layouts, train, checkpoint, ranks_n):
    """ranks_n processes on this one card (a gloo group, named: NCCL
    refuses two ranks on one GPU) through `layouts` (layout_rank), then
    the `checkpoint` layout's gathered checkpoint restored under the
    one-rank template, shard for shard. -> (each rank's results, the
    shards compared, wall times)."""
    from gpu_docker_api_tpu_torch import distributed

    wall = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spec = {"device": f"{device}:0" if device == "cuda" else device,
                "layouts": layouts, "train": train, "checkpoint": checkpoint}
        distributed.launch(layout_rank, (tmp, spec), ranks_n, "gloo",
                           timeout=LAYOUTS_DEADLINE_S)
        wall["ranks_s"] = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(ranks_n)]
        t0 = time.perf_counter()
        config, plan, _, steps, opts = layout_fields(layouts[checkpoint])
        tc = opts.get("tc", {})
        n = check_resharded_checkpoint(
            os.path.join(tmp, "ckpt"), smoke_config(config), ranks, plan,
            steps, checkpoint, tc)
        wall["restore_s"] = time.perf_counter() - t0
        if tc.get("virtual_stages", 1) > 1:
            t0 = time.perf_counter()
            check_served_ungrouped(os.path.join(tmp, "ckpt"),
                                   smoke_config(config), checkpoint)
            wall["serve_restore_s"] = time.perf_counter() - t0
    print(f"  {checkpoint} checkpoint: {n} shards equal to the restored "
          f"leaves, gathered and saved in "
          f"{[r[checkpoint]['checkpoint_s'] for r in ranks]} s", flush=True)
    return ranks, n, wall


def check_served_ungrouped(path, cfg, layout) -> int:
    """A grouped checkpoint through serve's loader (_restore_params, one
    rank): the served parameters hold the canonical one-rank shapes, and
    each leaf equals the checkpoint's, bit for bit, its layers the grouped
    leaves ungrouped. -> the leaves compared."""
    import torch

    from gpu_docker_api_tpu_torch.train import Trainer, restore_checkpoint
    from gpu_docker_api_tpu_torch.workloads import serve

    one = Trainer.create(cfg, device="cpu")
    served, _ = serve._restore_params(one, path, "cpu")
    stored, _ = restore_checkpoint(path)
    stored = dict(flat_leaves(stored["params"]))
    n = 0
    for path_, t in flat_leaves(served):
        want = stored[path_]
        check(t.dim() == want.dim() - (2 if path_.startswith("layers.")
                                       else 0)
              and torch.equal(t.detach().reshape(want.shape), want.detach()),
              f"{layout}: served {path_} {tuple(t.shape)} is not the "
              f"checkpoint's {tuple(want.shape)} ungrouped")
        n += 1
    print(f"  {layout} checkpoint served ungrouped: {n} leaves equal",
          flush=True)
    return n


def check_layouts(att, ranks, layouts, ones, device, tokens) -> dict:
    """Phases 9-12's checks of each layout's runs over the ranks against
    its config's one-rank run (ones[config]): every rank the same loss and
    grad norm, within SP_LOSS_TOL / SP_NORM_TOL of one rank's (MoE:
    EP_LOSS_TOL / EP_NORM_TOL), the first near its value at init; each
    leaf of params, mu and nu exactly shard_bytes (no rank keeps a whole
    matrix or bank); launches a rank
    and step fsdp_launches (none on the CPU, where the wrappers take the
    plain versions); the q heads tp_heads; the tp sums tp_sums_a_step;
    for MoE the f32 routing of the first batch, assembled over the ranks,
    against one rank's (routing_ranks). -> readings by layout, step times
    labelled gloo_4_ranks_one_card."""
    from gpu_docker_api_tpu_torch.models import family_for

    readings = {}
    for name, entry in layouts.items():
        config, plan, attn, steps, opts = layout_fields(entry)
        m = opts.get("tc", {}).get("n_microbatches", 1)
        cfg = smoke_config(config)
        moe = family_for(cfg).returns_extra_loss
        runs = [r[name] for r in ranks]
        label = f"{name} {config} {plan}"
        rel = sp_train_check(ones[config], runs, label,
                             (EP_LOSS_TOL, EP_NORM_TOL) if moe else None)
        want0 = first_loss(cfg)
        check(abs(runs[0]["losses"][0] - want0) < 0.1,
              f"{label}: first loss {runs[0]['losses'][0]} not near "
              f"{want0:.3f}")
        want_bytes = shard_bytes(cfg, plan)
        heads = tp_heads(cfg, plan)
        sums = tp_sums_a_step(cfg.n_layers, plan, moe)
        for r, run in enumerate(runs):
            for part, held in run["leaf_bytes"].items():
                check(held == want_bytes,
                      f"{label}: rank {r} {part} bytes {held}, want "
                      f"{want_bytes}")
            want = (fsdp_launches(plan, run["sp_rank"], cfg.n_layers, m)
                    if device == "cuda" else dict.fromkeys(att.LAUNCHES, 0))
            check(all(got == want for got in run["launches"]),
                  f"{label}: rank {r} launches {run['launches']}, want "
                  f"{want} a step")
            check(all(h == [heads] for h in run["heads"]),
                  f"{label}: rank {r}'s forward kernel saw q heads "
                  f"{run['heads']}, want {heads}")
            check(all(s["calls"] == sums for s in run["tp_sums"]),
                  f"{label}: rank {r} tp sums {run['tp_sums']}, want "
                  f"{sums} a step")
        step_s = statistics.median(runs[0]["step_times_s"][1:])
        readings[name] = {
            "config": config, "plan": plan, "sp_attn": attn, "steps": steps,
            "losses": runs[0]["losses"], "grad_norms": runs[0]["grad_norms"],
            "rel_to_one_rank": rel, "q_heads_a_rank": heads,
            "loss_minus_one_rank": [a - b for a, b in zip(
                runs[0]["losses"], ones[config]["losses"])],
            "state_bytes_a_rank": [sum(sum(part.values()) for part in
                                       run["leaf_bytes"].values())
                                   for run in runs],
            "launches_a_step": [run["launches"][0] for run in runs],
            "tp_sums_a_step": runs[0]["tp_sums"][0],
            "peak_bytes_a_rank": [run["peak_bytes"] for run in runs],
            "step_times_s": [run["step_times_s"] for run in runs],
            "step_s_gloo_4_ranks_one_card": step_s,
            "tokens_s_gloo_4_ranks_one_card": tokens / step_s}
        if moe and runs[0]["routes"] is not None:
            readings[name]["routing_flips"] = routing_ranks(
                ones[config]["routes"], runs, plan, label,
                tokens // ones[config]["s"], ones[config]["s"])
        print(f"  {label} (gloo, 4 ranks on one card): {readings[name]}",
              flush=True)
    return readings


def f32_routes(torch, cfg, groups, device, tokens, seed=0):
    """Each layer's routing (RoutingRecorder.calls, on the host) in a
    forward of the loss on `tokens` (a global batch; this rank's rows and
    sequence shard under `groups`, MeshGroups or None for one rank) at
    cfg's width and depth in f32, from init `seed`, at capacity factor
    EP_ROUTE_CAPACITY, under which choices drop: bf16's roundings move
    router probabilities by more than TIE_GAP where the GEMMs' shapes
    differ (a rank's rows are fewer), f32's by about 1e-7, and a wrong
    capacity or slot order moves the drops (routing_flips)."""
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.train import Trainer

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                capacity_factor=EP_ROUTE_CAPACITY)
    trainer = Trainer.create(cfg32, groups.plan if groups else None,
                             device=device, groups=groups)
    params = trainer.init(seed=seed)["params"]
    with torch.no_grad(), RoutingRecorder(moe) as rec:
        trainer._loss(params, trainer.shard_batch(tokens))
    return [tuple(t.cpu() for t in call) for call in rec.calls]


def route_drops(routes) -> list:
    """The dropped choices of each layer of f32_routes."""
    return [int((~keep).sum()) for _, keep, _ in routes]


def routing_ranks(ref, runs, plan, label, b, s):
    """The f32 routing of each layer (f32_routes) over the ranks of `plan`
    (each rank reports its tokens': its rows of the [b, s] batch, a row
    shard of dp x fsdp x ep, ep minor, and its sequence shard; the tp
    ranks of a row shard must route alike) assembled in the global order
    and held to one rank's (`ref`) by routing_flips: a decision may differ
    only at a near tie (TIE_GAP), at most once. -> flips [(layer, token,
    gap)]."""
    n_rows = plan.get("dp", 1) * plan.get("fsdp", 1) * plan.get("ep", 1)
    n_sp = plan.get("sp", 1)
    rb, sl = b // n_rows, s // n_sp
    got = []
    for layer in range(len(ref)):
        whole = [None] * 3      # gate_idx, keep, the top router probs
        seen = {}
        for run in runs:
            c = run["coords"]
            row = (c["dp"] * plan.get("fsdp", 1) + c["fsdp"]) * plan.get(
                "ep", 1) + c["ep"]
            call = run["routes"][layer]
            if (row, c["sp"]) in seen:      # another tp rank, same tokens
                check(all(bool((x == y).all()) for x, y in zip(
                    call, seen[row, c["sp"]])),
                      f"{label}: tp ranks route layer {layer} apart")
                continue
            seen[row, c["sp"]] = call
            for i, x in enumerate(call):
                if whole[i] is None:
                    whole[i] = x.new_empty((b, s, *x.shape[1:]))
                whole[i][row * rb:(row + 1) * rb, c["sp"] * sl:
                         (c["sp"] + 1) * sl] = x.reshape(rb, sl, *x.shape[1:])
        got.append(tuple(x.reshape(b * s, *x.shape[2:]) for x in whole))
    flips, _ = routing_flips(ref, got, f"{label} f32 routing")
    return flips


def phase_fsdp(torch, att, device="cuda", config=FSDP_CONFIG,
               train=FSDP_TRAIN):
    """Phase 9: dp and fsdp at llama `config`. The one-rank Trainer here,
    then FSDP_RANKS processes on this one card through each layout of
    FSDP_LAYOUTS (run_layouts), held to it (check_layouts); 9a's gathered
    checkpoint restored under the one-rank template."""
    cfg = smoke_config(config)
    print(f"phase 9: dp and fsdp, {config} ({cfg.n_layers} layers, {train}, "
          f"{cfg.dtype}, dots) over {FSDP_RANKS} gloo ranks on one card: "
          f"{FSDP_LAYOUTS}", flush=True)
    t0 = time.perf_counter()
    one = sp_train(torch, device, cfg, train, "ring")
    if device == "cuda":
        torch.cuda.empty_cache()
    one_rank_s = time.perf_counter() - t0
    print(f"  9 one rank: {one}", flush=True)
    want0 = first_loss(cfg)
    check(abs(one["losses"][0] - want0) < 0.1,
          f"9 first loss {one['losses'][0]} not near {want0:.3f}")
    layouts = {name: (config, plan, "ring", steps)
               for name, (plan, steps) in FSDP_LAYOUTS.items()}
    ranks, _, wall = run_layouts(torch, device, layouts, train, "9a",
                                 FSDP_RANKS)
    wall["one_rank_s"] = one_rank_s
    tokens = train["b"] * train["s"]
    readings = check_layouts(att, ranks, layouts, {config: one}, device,
                             tokens)
    one["step_s"] = statistics.median(one["step_times_s"][1:])
    one["tokens_s"] = tokens / one["step_s"]
    one["state_bytes"] = fsdp_state_bytes(cfg, 1)
    print(f"  phase 9 wall time {wall}", flush=True)
    return {"one_rank": one, "layouts": readings, "wall": wall}


# ---- phase 10: tensor parallelism -------------------------------------------

TP_RANKS = 4
TP_CONFIGS = {"main": FSDP_CONFIG,  # 10a-10c: phase 9's llama 1b cut
              "fallback": "mini"}  # 10d: 4 q / 2 kv heads, tp=4 gathers them
TP_TRAIN = dict(b=4, s=2048, steps=2)    # phase 9's batches; bf16, "dots"
TP_LAYOUTS = {                           # name: (config, plan, sp_attn)
    "10a": ("main", {"tp": 4}, "ring"),
    "10b": ("main", {"fsdp": 2, "tp": 2}, "ring"),
    "10c": ("main", {"tp": 2, "sp": 2}, "ring"),
    "10d": ("fallback", {"tp": 4}, "ring"),
}
TP_CHECKPOINT = "10b"                    # saved after its last step


class TpSums:
    """Counts the tp activation sums a rank runs (comm._sum_f32, which
    copy_to_group's backward and reduce_from_group's forward call) and the
    f32 bytes each puts on the wire, while installed."""

    def __init__(self, comm):
        self.calls = self.bytes = 0
        inner = comm._sum_f32

        def counted(x, g):
            self.calls += 1
            self.bytes += 4 * x.numel()
            return inner(x, g)
        comm._sum_f32 = counted

    def take(self) -> dict:
        """The counts since the last take, and reset."""
        out = {"calls": self.calls, "bytes": self.bytes}
        self.calls = self.bytes = 0
        return out


def record_heads(att) -> set:
    """The q head counts the forward kernel's wrapper is called with from
    now on (att.flash_fwd wrapped), in a set the caller clears."""
    seen = set()
    inner = att.flash_fwd

    def flash_fwd(q, *args, **kwargs):
        seen.add(q.shape[2])
        return inner(q, *args, **kwargs)
    att.flash_fwd = flash_fwd
    return seen


def tp_sums_a_step(n_layers, plan, moe=False) -> int:
    """The tp activation sums of one step under remat "dots" (none
    without tp): per layer two in the forward (wo, w2), two in the
    backward (the cotangents of the inputs to wq/wk/wv and w1/w3) and one
    in the recompute (wo's: the recompute stops once the last saved
    tensor, w2's input, is made, before w2's sum); the embedding's sum and
    the loss's two (the sum of exps, the target logit) in the forward;
    lm_head's input cotangent in the backward. An MoE layer has six: wo's
    and the experts' outputs' in the forward and again in the recompute
    (the combine saves the outputs it weighs), the cotangents of the
    inputs to wq/wk/wv and to the banks in the backward."""
    if plan.get("tp", 1) == 1:
        return 0
    return (6 if moe else 5) * n_layers + 4


def tp_heads(cfg, plan) -> int:
    """The q heads each rank's attention runs over: H/tp when both head
    counts divide by tp (mesh.head_axis_for), all H in the fallback."""
    from gpu_docker_api_tpu_torch.parallel.mesh import head_axis_for
    tp = plan.get("tp", 1)
    split = head_axis_for(tp, cfg.n_heads, cfg.n_kv_heads) == "tp"
    return cfg.n_heads // tp if split else cfg.n_heads


def phase_tp(torch, att, one=None, device="cuda", configs=None,
             train=TP_TRAIN):
    """Phase 10: tensor parallelism. The one-rank Trainer of each config
    (`one`: phase 9's run of the main config on the same batches, if
    given), then TP_RANKS processes on this one card through each layout
    of TP_LAYOUTS (run_layouts), held to it (check_layouts: the same loss
    and grad norm on every rank, within SP_LOSS_TOL / SP_NORM_TOL of one
    rank; each leaf 1/(fsdp * tp) of the whole, the norms whole;
    launches, tp sums and the heads the forward kernel ran over, a rank
    and step); TP_CHECKPOINT's gathered checkpoint restored under the
    one-rank template, shard for shard."""
    configs = configs or TP_CONFIGS
    print(f"phase 10: tp, {configs} ({train}, dots) over {TP_RANKS} gloo "
          f"ranks on one card: {TP_LAYOUTS}", flush=True)
    t0 = time.perf_counter()
    ones = {name: one if role == "main" and one is not None
            else sp_train(torch, device, smoke_config(name), train, "ring")
            for role, name in configs.items()}
    if device == "cuda":
        torch.cuda.empty_cache()
    one_rank_s = time.perf_counter() - t0
    for name, run in ones.items():
        print(f"  10 one rank, {name}: {run}", flush=True)
    layouts = {name: (configs[role], plan, attn, train["steps"])
               for name, (role, plan, attn) in TP_LAYOUTS.items()}
    ranks, n, wall = run_layouts(torch, device, layouts, train,
                                 TP_CHECKPOINT, TP_RANKS)
    wall["one_rank_s"] = one_rank_s
    readings = check_layouts(att, ranks, layouts, ones, device,
                             train["b"] * train["s"])
    print(f"  phase 10 wall time {wall}", flush=True)
    return {"one_rank": {str(name): {k: run[k] for k in (
                "losses", "grad_norms", "step_times_s")}
                         for name, run in ones.items()},
            "layouts": readings, "checkpoint_shards": n, "wall": wall}


# ---- phase 11: expert parallelism and MoE over ranks ------------------------

EP_RANKS = 4
EP_CONFIG = ("moe", "1b", None)          # moe_1b, full width and depth
EP_TRAIN = dict(b=8, s=2048, steps=2)    # 7a's shape; bf16, "dots"
EP_LAYOUTS = {                           # name: (plan, sp_attn)
    "11a": ({"ep": 4}, "ring"),
    "11b": ({"fsdp": 2, "ep": 2}, "ring"),   # MeshPlan.auto(4, ep=2)
    "11c": ({"tp": 4}, "ring"),              # JAX's un-planned MoE launch
    "11d": ({"ep": 2, "sp": 2}, "ring"),     # the interleaved prefix
}
EP_CHECKPOINT = "11b"                    # banks gathered over fsdp and ep
# the f32 routing check's capacity factor (f32_routes): at 0.5 (the CPU
# tests' factor) about half the choices drop from the first layer on, so a
# wrong capacity or prefix shows in layer 0; at moe_1b's 1.25 the first
# layer drops nothing at init, and a near-tie flip may end the comparison
# before a layer that does (PERF.md)
EP_ROUTE_CAPACITY = 0.5
# phase 11's bf16 trainers against one rank, relative (moe_1b, 2 steps):
# about 3x the largest of scripts/torch_moe_margin.py's readings over
# seeds 0-3 (1.78e-4 and 4.19e-3: bf16 routing flips move MoE's numbers
# more than llama's), under the planted rank-local route's 5.0e-2 grad
# norm (PERF.md)
EP_LOSS_TOL = 5e-4
EP_NORM_TOL = 1.25e-2


def phase_ep(torch, att, device="cuda", config=EP_CONFIG, train=EP_TRAIN):
    """Phase 11: ep and MoE over ranks. The one-rank Trainer of `config`
    here and the f32 routing of its first batch; then EP_RANKS processes on
    this one card through each layout of EP_LAYOUTS (run_layouts), held
    to it (check_layouts: the same loss and grad norm on every rank,
    within EP_LOSS_TOL / EP_NORM_TOL of one rank, the difference printed;
    each leaf's bytes over the axes its spec cuts, banks over ep too;
    launches, tp sums and heads a rank and step; the f32 routing of the
    first batch assembled over the ranks against one rank's, a flip only
    at a near tie);
    EP_CHECKPOINT's gathered checkpoint restored under the one-rank
    template, shard for shard."""
    cfg = smoke_config(config)
    print(f"phase 11: ep and MoE over ranks, {config} ({cfg.n_layers} "
          f"layers, {train}, {cfg.dtype}, dots) over {EP_RANKS} gloo ranks "
          f"on one card: {EP_LAYOUTS}", flush=True)
    t0 = time.perf_counter()
    one = sp_train(torch, device, cfg, train, "ring")
    if device == "cuda":
        torch.cuda.empty_cache()
    one["routes"] = f32_routes(torch, cfg, None, device, train_batch(
        torch, cfg, train["b"], train["s"], 0, 0))
    one["s"] = train["s"]
    one["f32_drops"] = route_drops(one["routes"])
    check(one["f32_drops"][0] > 0,
          f"11: no choice drops in the f32 routing's first layer at "
          f"capacity factor {EP_ROUTE_CAPACITY}: {one['f32_drops']}")
    if device == "cuda":
        torch.cuda.empty_cache()
    one_rank_s = time.perf_counter() - t0
    print(f"  11 one rank: "
          f"{({k: v for k, v in one.items() if k != 'routes'})}", flush=True)
    layouts = {name: (config, plan, attn, train["steps"])
               for name, (plan, attn) in EP_LAYOUTS.items()}
    ranks, n, wall = run_layouts(torch, device, layouts, train,
                                 EP_CHECKPOINT, EP_RANKS)
    wall["one_rank_s"] = one_rank_s
    tokens = train["b"] * train["s"]
    readings = check_layouts(att, ranks, layouts, {config: one}, device,
                             tokens)
    del one["routes"]
    one["step_s"] = statistics.median(one["step_times_s"][1:])
    one["tokens_s"] = tokens / one["step_s"]
    one["state_bytes"] = fsdp_state_bytes(cfg, 1)
    print(f"  phase 11 wall time {wall}", flush=True)
    return {"one_rank": one, "layouts": readings, "checkpoint_shards": n,
            "wall": wall}


# ---- phase 12: pipeline parallelism ----------------------------------------

PP_RANKS = 4
PP_CONFIGS = {"llama": ("llama", "1b", None),   # 12a-12c: all 20 layers
              "moe": ("moe", "1b", None)}       # 12d: moe_1b, full depth
PP_TRAIN = dict(b=4, s=2048, steps=2)    # phase 2's shape; bf16, stage remat
PP_LAYOUTS = {  # name: (family, plan, sp_attn, TrainConfig fields, B / b)
    "12a": ("llama", {"pp": 4}, "ring", dict(n_microbatches=4), 1),
    "12b": ("llama", {"fsdp": 2, "pp": 2}, "ring",
            dict(n_microbatches=2, virtual_stages=2), 1),
    "12c": ("llama", {"pp": 2, "sp": 2}, "ring", dict(n_microbatches=2), 1),
    "12d": ("moe", {"pp": 2, "ep": 2}, "ring", dict(n_microbatches=2), 2),
}
PP_CHECKPOINT = "12b"                    # stored grouped, [2, 2, 5, ...]


def pp_layouts(configs, train) -> dict:
    """PP_LAYOUTS as run_layouts takes them: (config spec, plan, sp_attn,
    steps, {"tc": TrainConfig fields, "b": the layout's batch})."""
    return {name: (configs[fam], plan, attn, train["steps"],
                   {"tc": tc, "b": train["b"] * scale})
            for name, (fam, plan, attn, tc, scale) in PP_LAYOUTS.items()}


def phase_pp(torch, att, device="cuda", configs=None, train=PP_TRAIN):
    """Phase 12: pipeline parallelism. The one-rank references here: the
    llama Trainer (the pipeline changes no number of llama's) and, for
    MoE, the plain microbatched version (the pipeline's routing pools, M
    of them); then PP_RANKS processes on this one card through each layout
    of PP_LAYOUTS (run_layouts), held to them (check_layouts: the same
    loss and grad norm on every rank, within SP_LOSS_TOL / SP_NORM_TOL of
    one rank, MoE within EP_LOSS_TOL / EP_NORM_TOL; each leaf's bytes over
    the axes its spec cuts, the layers over pp too; launches a rank and
    step, a stage's layers once a microbatch); PP_CHECKPOINT's grouped
    checkpoint restored under its template shard for shard, and through
    serve's loader ungrouped, bit for bit."""
    configs = configs or PP_CONFIGS
    layouts = pp_layouts(configs, train)
    print(f"phase 12: pp, {configs} ({train}, stage remat) over {PP_RANKS} "
          f"gloo ranks on one card: {layouts}", flush=True)
    for name, entry in layouts.items():
        config, plan, _, _, opts = layout_fields(entry)
        cfg = smoke_config(config)
        print(f"  {name} predicted: {state_bytes(cfg, plan)} state bytes a "
              f"rank, launches a step "
              f"{[fsdp_launches(plan, r, cfg.n_layers, opts['tc']['n_microbatches']) for r in range(plan.get('sp', 1))]}",
              flush=True)
    t0 = time.perf_counter()
    llama, moe = configs["llama"], configs["moe"]
    m = PP_LAYOUTS["12d"][3]["n_microbatches"]
    moe_train = dict(train, b=layouts["12d"][4]["b"])
    ones = {llama: sp_train(torch, device, smoke_config(llama), train,
                            "ring")}
    if device == "cuda":
        torch.cuda.empty_cache()
    ones[moe] = sp_train(torch, device, smoke_config(moe), moe_train, "ring",
                         microbatches=m)
    if device == "cuda":
        torch.cuda.empty_cache()
    one_rank_s = time.perf_counter() - t0
    for name, run in ones.items():
        print(f"  12 one rank, {name}: {run}", flush=True)
    ranks, n, wall = run_layouts(torch, device, layouts, train,
                                 PP_CHECKPOINT, PP_RANKS)
    wall["one_rank_s"] = one_rank_s
    readings = {}
    for config, b in ((llama, train["b"]), (moe, moe_train["b"])):
        mine = {k: v for k, v in layouts.items() if v[0] == config}
        readings.update(check_layouts(att, ranks, mine, ones, device,
                                      b * train["s"]))
    print(f"  phase 12 wall time {wall}", flush=True)
    return {"one_rank": {str(name): {k: run[k] for k in (
                "losses", "grad_norms", "step_times_s")}
                         for name, run in ones.items()},
            "layouts": readings, "checkpoint_shards": n, "wall": wall}


def build_kernels(torch):
    """Phase 0: the card's name and power limit, then the kernels' build.
    Returns (nvidia-smi line, the attention module)."""
    check(torch.cuda.is_available(), "CUDA is not available")
    try:
        from gpu_docker_api_tpu_torch import _build
        from gpu_docker_api_tpu_torch.ops import attention as att
    except ImportError as e:
        raise SmokeFailure(f"the port is not importable here: {e}") from e
    # f32 products in full f32 (the f32 paths' reference numerics)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"phase 0: built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in sorted(reports.items()):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        print(f"  ptxas {name}: {len(regs)} instantiations, registers <= "
              f"{max(regs, default=0)}, spill stores <= "
              f"{max(spills, default=0)} bytes", flush=True)
        for fn, fn_regs, fn_spill in ptxas_entries(log):
            if "wgmma" in fn:
                print(f"    {fn}: {fn_regs} registers, {fn_spill} bytes "
                      f"spill stores", flush=True)
                check(fn_spill == 0, f"{fn} spills {fn_spill} bytes")
        for line in log.splitlines():
            if "Performance Loss" in line or "warning" in line.lower():
                print(f"    {line.strip()}", flush=True)
        lost = ptxas_wgmma_losses(log)
        check(not lost, f"{name}: ptxas undid the wgmma design: {lost}")
    check_sass(_build)
    return smi, att


def check_sass(_build):
    """Every kernel library's machine code must hold the Hopper
    instructions its bf16 kernel was written for: HGMMA (wgmma) and UTMALDG
    (TMA loads); UTMASTG (the TMA-store epilogue) is printed."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in _build.KERNELS:
        sass = subprocess.run([cuobjdump, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass))
                  for op in ("HGMMA", "UTMALDG", "UTMASTG")}
        print(f"  sass {name}: {counts}", flush=True)
        check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
              f"{name}: no wgmma / TMA instructions in its machine code")


def ptxas_entries(log):
    """(demangled-ish kernel name, registers, spill-store bytes) of each
    entry function in an `nvcc -Xptxas -v` report."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((re.sub(r"^_ZN5flash3hop\d+|EEEv.*$", "", name),
                        int(m.group(1)), spill))
            name, spill = None, 0
    return out


def ptxas_wgmma_losses(log):
    """ptxas's "Potential Performance Loss" notes that undo the wgmma
    kernels' design without a spill: wgmmas serialised in a *_wgmma
    function (each waits for the one before), or a setmaxnreg ignored (only
    the wgmma kernels reallocate registers; the note names no function)."""
    lost = []
    for line in log.splitlines():
        if "Performance Loss" not in line:
            continue
        m = re.search(r"wgmma\.mma_async instructions are serialized.*"
                      r"function '(\w+)'", line)
        if (m and "wgmma" in m.group(1)) or "'setmaxnreg' ignored" in line:
            lost.append(line.split("Performance Loss:")[-1].strip())
    return lost


def main() -> int:
    import torch

    start = time.perf_counter()
    try:
        smi, att = build_kernels(torch)
        kernels, yardstick, bf16_check = phase_kernels(torch, att)
        m = phase_main_path(torch, att, MAIN_STEPS)
        phase_resume()
        serve = phase_serve(torch, att)
        batching = phase_batching(torch, att)
        paged = phase_paged(torch, att, batching)
        moe = phase_moe(torch, att)
        sp = phase_sp(torch, att)
        fsdp = phase_fsdp(torch, att)
        tp = phase_tp(torch, att, one=fsdp["one_rank"])
        before_ep = time.perf_counter() - start
        ep = phase_ep(torch, att)
        before_pp = time.perf_counter() - start
        pp = phase_pp(torch, att)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    bnd = bounds(MAIN_SHAPE, 2)
    line = []
    for name, k in kernels.items():
        line.append({
            "name": name, "route": "cuda",
            "source": f"gpu_docker_api_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": m["launches"][name],
            "launches_moe": moe["train"]["launches"][name],
            "launches_long": long_launches(sp, name),
            "launches_fsdp": fsdp_kernel_launches(fsdp, name),
            "launches_tp": fsdp_kernel_launches(tp, name),
            "launches_ep": fsdp_kernel_launches(ep, name),
            "launches_pp": fsdp_kernel_launches(pp, name),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": bnd[name][0],
            "bound_by": bnd[name][1], "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"main_path": {
        "config": "llama 1b", "batch": MAIN_SHAPE["b"],
        "seq": MAIN_SHAPE["s"], "step_s": m["step_s"],
        "step_times_s": m["step_times_s"], "tokens_s": m["tokens_s"],
        "losses": m["losses"]}}), flush=True)
    print(json.dumps({"attention_fwd_bwd": yardstick, "bf16_check": bf16_check,
                      "trunk": m["trunk"]}), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"batching": batching}), flush=True)
    print(json.dumps({"paged": paged}), flush=True)
    print(json.dumps({"moe": moe}), flush=True)
    print(json.dumps({"sp": sp}), flush=True)
    print(json.dumps({"fsdp": fsdp}), flush=True)
    print(json.dumps({"tp": tp}), flush=True)
    print(json.dumps({"ep": ep}), flush=True)
    print(json.dumps({"pp": pp}), flush=True)
    wall = time.perf_counter() - start
    print(f"wall time: the whole script {wall:.1f} s, phases 0-10 "
          f"{before_ep:.1f} s, phase 11 {before_pp - before_ep:.1f} s, "
          f"phase 12 {wall - before_pp:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
