"""The bf16 check of chip_smoke.py, on the CPU: the band rms it scales each
element's limit by, and that it passes the plain versions while rejecting
every fault that planted_faults models (the same functions the script runs
on the card at the main path's shape, here at a small one)."""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from gpu_docker_api_tpu_torch.ops import attention as att  # noqa: E402

torch.set_num_threads(1)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


@pytest.mark.parametrize("s", [64, 100, 256])
def test_band_rms_is_the_rms_of_each_band_of_rows(s):
    rng = np.random.default_rng(s)
    ref = torch.from_numpy(rng.standard_normal((2, s, 3, 8)).astype(np.float32))
    got = cs.band_rms(torch, ref)
    assert got.shape == (2, s, 3, 1)
    for lo in range(0, s, cs.BAND):
        band = ref[:, lo:lo + cs.BAND]
        want = band.square().mean(dim=(1, 3)).sqrt()          # [B, H]
        for r in range(lo, min(lo + cs.BAND, s)):
            torch.testing.assert_close(got[:, r, :, 0], want, rtol=1e-5,
                                       atol=0)


@pytest.fixture(scope="module")
def faults_case():
    rng = np.random.default_rng(0)
    b, s, h, hkv, d = 1, 256, 4, 2, 32
    q, do = _bf16(rng, b, s, h, d), _bf16(rng, b, s, h, d)
    k, v = _bf16(rng, b, s, hkv, d), _bf16(rng, b, s, hkv, d)
    o, lse = att.flash_fwd_plain(q, k, v)
    refs = {"flash_fwd": (o,),
            "flash_bwd_dq": (att.flash_bwd_dq_plain(q, k, v, o, do, lse),),
            "flash_bwd_dkv": att.flash_bwd_dkv_plain(q, k, v, o, do, lse)}
    return (q, k, v, o, do, lse), refs


def test_bf16_check_passes_the_plain_versions(faults_case):
    _, refs = faults_case
    for outputs in refs.values():
        for ref in outputs:
            assert cs.bf16_ok(cs.bf16_readings(torch, ref, ref.float()))


def test_bf16_check_rejects_every_planted_fault(faults_case):
    inputs, refs = faults_case
    least = cs.check_planted_faults(torch, att, inputs, refs)
    assert set(least) == set(refs)
    for ratio, frob in least.values():
        assert ratio > cs.BF16_TOL or frob > cs.BF16_FROB


def test_repeat_check_passes_deterministic_kernels(faults_case):
    inputs, _ = faults_case
    cs.check_repeatable(torch, att, *inputs)


def test_repeat_check_rejects_a_kernel_whose_bits_change(faults_case,
                                                          monkeypatch):
    inputs, _ = faults_case
    calls = []

    def drifting(*args, **kw):
        calls.append(1)
        dk, dv = att.flash_bwd_dkv_plain(*args, **kw)
        return dk, dv + (len(calls) % 2) * 2.0 ** -6

    monkeypatch.setattr(att, "flash_bwd_dkv", drifting)
    with pytest.raises(cs.SmokeFailure, match="flash_bwd_dkv"):
        cs.check_repeatable(torch, att, *inputs)


def test_fresh_thread_check_passes_kernels_that_launch_anywhere(faults_case):
    inputs, _ = faults_case
    cs.check_fresh_thread(torch, att, *inputs)


def test_fresh_thread_check_rejects_a_kernel_that_fails_off_the_main_thread(
        faults_case, monkeypatch):
    import threading
    inputs, _ = faults_case

    def main_thread_only(*args, **kw):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("flash_bwd_dq kernel launch failed: CUDA error 1")
        return att.flash_bwd_dq_plain(*args, **kw)

    monkeypatch.setattr(att, "flash_bwd_dq", main_thread_only)
    with pytest.raises(cs.SmokeFailure, match="flash_bwd_dq on a fresh thread"):
        cs.check_fresh_thread(torch, att, *inputs)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN5flash3hop22flash_fwd_kernel_wgmmaILi128EEEv14CUtensorMap_stS2_S2_S2_Pfiiifii' for 'sm_90a'
ptxas info    : Function properties for _ZN5flash3hop22flash_fwd_kernel_wgmmaILi128EEEv14CUtensorMap_stS2_S2_S2_Pfiiifii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN5flash3hop26flash_bwd_dkv_kernel_wgmmaILi64EEEv14CUtensorMap_stS2_S2_S2_S2_S2_PKfS4_iiifii' for 'sm_90a'
    32 bytes stack frame, 36 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN5flash16flash_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_Pfiiifii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
"""


def test_ptxas_entries_reads_registers_and_spills_per_kernel():
    got = cs.ptxas_entries(PTXAS_LOG)
    assert got == [("flash_fwd_kernel_wgmmaILi128", 168, 0),
                   ("flash_bwd_dkv_kernel_wgmmaILi64", 168, 36),
                   ("_ZN5flash16flash_fwd_kernelIfLi128", 40, 0)]


PTXAS_NOTES = """\
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_ZN5flash3hop26flash_bwd_dkv_kernel_wgmmaILi128EEEv14CUtensorMap_stS2_S2_S2_S2_S2_PKfS4_iiifii'
ptxas info    : (C7508) Potential Performance Loss: 'setmaxnreg' ignored; unable to determine register count at entry.
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to the presence of Extern calls in the function '_ZN5other6kernelEv'
ptxas info    : 0 bytes gmem
"""


@pytest.mark.parametrize("log, want", [
    (PTXAS_LOG, []),
    (PTXAS_NOTES, [
        "wgmma.mma_async instructions are serialized due to insufficient "
        "register resources for the function "
        "'_ZN5flash3hop26flash_bwd_dkv_kernel_wgmmaILi128EEEv14CUtensorMap_"
        "stS2_S2_S2_S2_S2_PKfS4_iiifii'",
        "'setmaxnreg' ignored; unable to determine register count at entry.",
    ]),
])
def test_ptxas_wgmma_losses_flags_serialised_wgmma_and_ignored_setmaxnreg(
        log, want):
    assert cs.ptxas_wgmma_losses(log) == want


def test_trunk_check_passes_its_controls_and_rejects_planted_faults():
    """trunk_readings at a tiny width on the CPU (the kernels' plain versions
    stand in for the kernels): every run is read, the controls sit near the
    reference attention and a gross fault of each kernel far above it."""
    import dataclasses
    from gpu_docker_api_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.bfloat16,
                              max_seq_len=cs.TRUNK_S)
    models = cs.trunk_fault_models(torch, att)
    assert len(models) == 15
    f32, bf16 = cs.trunk_readings(torch, att, cfg, faults=range(len(models)),
                                  device="cpu")
    assert all(e <= cs.F32_TOL for e in f32.values())
    excess = cs.trunk_excess(bf16)
    assert len(excess) == 1 + len(models)
    for run, x in excess.items():
        if run == "kernels" or run.endswith(": none"):
            assert x <= cs.TRUNK_MARGIN, run
        if run.endswith("causal mask col < row"):
            assert x > cs.TRUNK_MARGIN, run


@pytest.mark.parametrize("name, fam", [
    ("void flash::hop::flash_fwd_kernel_wgmma<128>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float*, int, int, int, "
     "float, int, int)", "flash_fwd_kernel"),
    ("void flash::hop::flash_bwd_dkv_kernel_delta<128>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, float*, long long, int, int)",
     "flash_bwd_dkv_kernel"),
    ("void flash::hop::flash_bwd_dkv_kernel_wgmma<128>(CUtensorMap_st)",
     "flash_bwd_dkv_kernel"),
    ("void flash::hop::flash_bwd_dq_kernel_wgmma<128>(CUtensorMap_st)",
     "flash_bwd_dq_kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4>(...)", "other"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>(...)",
     "sort"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
     "long, unsigned int, 2, 2, -2, true>(...)", "index"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>(...)",
     "index"),
])
def test_step_profile_puts_each_kernel_in_its_family(name, fam):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_step_profile
    assert torch_step_profile.family(name) == fam


# ---- phase 4: serving ---------------------------------------------------------

def _logits(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_teacher_forced_check_passes_equal_logits_and_their_argmax():
    ref = _logits(0, 2, 5, 32)
    out = cs.teacher_forced_check(torch, ref.clone(), ref, ref.argmax(-1),
                                  cs.F32_TOL, "same")
    assert out == {"err": 0.0, "max_abs_err": 0.0, "ties": 0}


def test_teacher_forced_check_rejects_a_logit_past_the_tolerance():
    ref = _logits(1, 2, 5, 32)
    got = ref.clone()
    got[1, 3, 7] += 3 * cs.F32_TOL * (1 + ref[1, 3, 7].abs())
    with pytest.raises(cs.SmokeFailure, match="logits off the full forward"):
        cs.teacher_forced_check(torch, got, ref, ref.argmax(-1), cs.F32_TOL,
                                "off")


def test_teacher_forced_check_takes_a_near_tie_only():
    ref = _logits(2, 1, 3, 16)
    tokens = ref.argmax(-1).clone()
    second = ref[0, 1].topk(2).indices[1]
    # a token within twice the tolerance of the largest logit: a near tie
    ref[0, 1, second] = ref[0, 1].max() - cs.F32_TOL
    tokens[0, 1] = second
    out = cs.teacher_forced_check(torch, ref.clone(), ref, tokens, cs.F32_TOL,
                                  "tie")
    assert out["ties"] == 1
    # a token far below the largest logit is a wrong token
    ref[0, 1, second] = ref[0, 1].max() - 1.0
    with pytest.raises(cs.SmokeFailure, match="beyond a near tie"):
        cs.teacher_forced_check(torch, ref.clone(), ref, tokens, cs.F32_TOL,
                                "wrong")


def test_serve_bounds_count_weights_cache_and_operations():
    from gpu_docker_api_tpu_torch.models import llama
    cfg = llama.LlamaConfig.llama_1b()
    per_layer = 2048 * 128 * 2 * (16 + 8) + 3 * 2048 * 5632
    n = 20 * per_layer + 2048 * 32000
    assert cs.cache_bytes_per_token(cfg, False) == 2 * 20 * 8 * 128 * 2
    assert cs.cache_bytes_per_token(cfg, True) == 2 * 20 * 8 * (128 + 4)
    # decode at B=1, context 544: bytes (weights + the cache up to the
    # frontier) bound it
    ms, by = cs.serve_bounds(cfg, 2 * n, 1, 1, 544, False)
    assert by == "bytes"
    assert ms == pytest.approx((2 * n + 545 * 81920) / cs.PEAK_BYTES * 1e3)
    # prefill of 8 x 512 tokens: operations bound it
    ms, by = cs.serve_bounds(cfg, 2 * n, 8, 512, 0, False)
    pairs = 8 * 512 * 513 // 2
    flops = 2 * n * 8 * 512 + 4 * 128 * 16 * 20 * pairs
    assert by == "operations"
    assert ms == pytest.approx(flops / cs.PEAK_BF16_FLOPS * 1e3)


def test_weight_bytes_count_int8_weights_with_their_scales():
    from gpu_docker_api_tpu_torch.models import llama
    from gpu_docker_api_tpu_torch.ops.quant import quantize_params
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    mats = [params["layers"][k] for k in ("wq", "wk", "wv", "wo", "w1", "w2",
                                          "w3")] + [params["lm_head"]]
    assert cs.weight_bytes(params) == 4 * sum(m.numel() for m in mats)
    w8 = quantize_params(params, "w8")
    assert cs.weight_bytes(w8) == sum(m.numel() + 4 * m.numel() // m.shape[-2]
                                      for m in mats)


@pytest.mark.parametrize("kv8", [False, True])
def test_serve_oracle_runs_the_cached_path_against_the_full_forward(kv8):
    """Phase 4's oracle on the CPU at the tiny width (the plain attention
    stands in for the forward kernel, so nothing is launched)."""
    from gpu_docker_api_tpu_torch.models import llama
    out = cs.serve_oracle(torch, att, llama.LlamaConfig.tiny(), 2, 16, 6, kv8,
                          cs.KV8_TOL if kv8 else cs.F32_TOL, device="cpu")
    assert out["err"] <= (cs.KV8_TOL if kv8 else 1e-5)
    assert out["flash_fwd_launches"] == 0


def test_serve_http_drives_the_entry_point_in_a_subprocess(tmp_path):
    """Phase 4's HTTP check against `python -m ...workloads.serve --device
    cpu --config tiny`: healthz, greedy equal to in-process generate(),
    top_k=1 greedy, a sampled request, the error envelopes."""
    from gpu_docker_api_tpu_torch.models import llama
    from gpu_docker_api_tpu_torch.train import Trainer
    from gpu_docker_api_tpu_torch.workloads.serve import _load_params
    cfg = llama.LlamaConfig.tiny()
    params = _load_params(Trainer.create(cfg, device="cpu"), "")
    out = cs.serve_http(torch, "tiny", cfg, params, str(tmp_path),
                        extra_args=("--device", "cpu"))
    assert out["greedy_tokens_equal"] is True


# ---- phase 5: the continuous batcher --------------------------------------------

def test_near_tie_check_takes_equal_streams_and_near_ties_only():
    solo, gaps = [4, 8, 15, 16], [0.5, 2e-5, 0.3, 0.1]
    assert cs.near_tie_check(list(solo), solo, gaps, "same") is False
    # leaves at token 1, where the solo top two were 2e-5 apart: a near tie
    assert cs.near_tie_check([4, 9, 1, 1], solo, gaps, "tie") is True
    with pytest.raises(cs.SmokeFailure, match="token 2 is 7"):
        cs.near_tie_check([4, 8, 7, 16], solo, gaps, "wrong")
    with pytest.raises(cs.SmokeFailure, match="3 tokens"):
        cs.near_tie_check([4, 8, 15], solo, gaps, "short")


def test_check_batching_headers_wants_all_five_as_numbers():
    hdrs = {"X-TDAPI-Slots": "8", "X-TDAPI-Active": "3",
            "X-TDAPI-Queued": "0", "X-TDAPI-Queue-Wait-EWMA-Ms": "1.25",
            "X-TDAPI-Queue-Wait-Ms": "0.4"}
    cs.check_batching_headers(hdrs, "ok")
    del hdrs["X-TDAPI-Queue-Wait-Ms"]
    with pytest.raises(cs.SmokeFailure, match="Queue-Wait-Ms"):
        cs.check_batching_headers(hdrs, "missing")


def test_http_traffic_is_seeded_and_inside_its_ranges():
    reqs = cs.http_traffic(32000)
    assert reqs == cs.http_traffic(32000)
    assert len(reqs) == cs.BATCH_TRAFFIC["requests"]
    lo, hi = cs.BATCH_TRAFFIC["prompt"]
    assert all(lo <= len(t) <= hi and all(0 <= x < 32000 for x in t)
               for t, _ in reqs)
    lo, hi = cs.BATCH_TRAFFIC["new"]
    assert all(lo <= m <= hi for _, m in reqs)
    assert cs.percentile([3, 1, 2, 4], 0.5) == 3
    assert cs.percentile([3, 1, 2, 4], 0.9) == 4


def test_batcher_exactness_at_tiny_width_on_the_cpu():
    """5a's three runs on the CPU (tiny target, a tiny draft): every stream
    equals its solo stream, a prefix hit is counted, nothing launched."""
    from gpu_docker_api_tpu_torch.models import llama
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    draft = (cfg, llama.init_params(cfg, torch.Generator().manual_seed(1)))
    sizes = dict(slots=2, max_len=64, lens=(5, 9, 13), new=6, prefix=16,
                 suffixes=(2, 5, 7), prefill_chunk=8, prefix_cache=2,
                 decode_chunk=3, gamma=3)
    out = cs.batcher_exactness(torch, att, cfg, params, draft, sizes,
                               device="cpu")
    runs = [k for k in out if isinstance(out[k], dict) and "requests" in out[k]]
    assert len(runs) == 3
    assert all(out[k]["near_ties"] == 0 for k in runs)
    assert out["chunked prefill, prefix cache, decode chunk"]["prefix_hits"] >= 1
    assert out["speculative"]["speculative"]["rounds"] >= 1
    assert not any(out["launches"].values())


@pytest.mark.parametrize("decode_chunk", [1, 8])
def test_batcher_busy_traces_the_ticks_on_its_own_thread(monkeypatch,
                                                         decode_chunk):
    """5b's decode window on the CPU (tiny; busy_share and the sync check,
    which need the card, stood in for): the scheduler thread is stopped
    with its slots kept, the traced window runs BUSY_STEPS decode steps of
    _tick on the calling thread, and the sync check gets the full slots."""
    from gpu_docker_api_tpu_torch.models import llama
    traced, checked = [], []

    def fake_busy(torch, windows):
        for name, (fn, reps) in windows.items():
            traced.append((threading.current_thread(), reps))
            for _ in range(reps):
                fn()
        return {name: 0.5 for name in windows}

    def fake_sync_check(torch, b):
        checked.append((b.thread.is_alive(),
                        all(s is not None for s in b.slots)))

    monkeypatch.setattr(cs, "busy_share", fake_busy)
    monkeypatch.setattr(cs, "check_decode_sync_free", fake_sync_check)
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    out = cs.batcher_busy(torch, cfg, params, decode_chunk, slots=2,
                          max_len=512, prompt_len=16)
    assert traced == [(threading.main_thread(),
                       cs.BUSY_STEPS // decode_chunk)]
    assert checked == [(False, True)]
    assert out["busy"] == 0.5 and out["step_ms"] > 0
    assert out["bound_by"] == "bytes"


TINY_TRAFFIC = dict(requests=6, clients=3, prompt=(8, 24), new=(4, 8))


def test_batching_http_drives_the_batcher_in_a_subprocess(tmp_path):
    """5b's HTTP check against `serve --device cpu --config tiny` with the
    batcher: every response, the headers, healthz's count, the two-row
    refusal."""
    from gpu_docker_api_tpu_torch.models import llama
    out = cs.batching_http(torch, "tiny", llama.LlamaConfig.tiny(),
                           str(tmp_path), 2, traffic=TINY_TRAFFIC,
                           extra_args=("--device", "cpu"))
    assert out["requests"] == 6 and out["tokens_s"] > 0


def test_batching_shed_sees_the_429_envelope(tmp_path):
    """--admit-queue 2 with one slot and 12 requests from 12 clients: the
    queue builds, and the shed responses carry the 429 envelope."""
    from gpu_docker_api_tpu_torch.models import llama
    out = cs.batching_shed(
        torch, "tiny", llama.LlamaConfig.tiny(), str(tmp_path),
        traffic=dict(requests=12, clients=12, prompt=(8, 24), new=(40, 60)),
        serve_args=("--batch-slots", "1"), extra_args=("--device", "cpu"))
    assert out["shed"] >= 1 and out["shed"] + out["served"] == 12


def test_batcher_busy_window_is_counted_in_steps(monkeypatch):
    """The window ends after window_steps decode steps of the scheduler
    thread, however fast the host: a window the requests' budget could not
    hold is refused up front, and the paged batcher's step runs the same
    window."""
    from gpu_docker_api_tpu_torch.models import llama

    def fake_busy(torch, windows):
        for fn, reps in windows.values():
            for _ in range(reps):
                fn()
        return {name: 0.5 for name in windows}

    monkeypatch.setattr(cs, "busy_share", fake_busy)
    synced = []
    monkeypatch.setattr(cs, "check_decode_sync_free",
                        lambda torch, b: synced.append(b._paged))
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(cs.SmokeFailure, match="does not fit"):
        cs.batcher_busy(torch, cfg, params, 1, slots=2, max_len=64,
                        prompt_len=16)
    out = cs.batcher_busy(torch, cfg, params, 1, slots=2, max_len=512,
                          prompt_len=16, window_steps=32, kv_block=8)
    assert out["steps"] == 32 and out["step_ms"] > 0
    assert synced == [True]


def test_check_sketch_headers_wants_hex_and_a_count():
    good = {"X-TDAPI-KV-Sketch": "0f" * 32, "X-TDAPI-KV-Occ": "12"}
    cs.check_sketch_headers(good, "ok")
    for bad in ({"X-TDAPI-KV-Occ": "12"},
                dict(good, **{"X-TDAPI-KV-Sketch": "0f" * 31}),
                dict(good, **{"X-TDAPI-KV-Occ": "-1"})):
        with pytest.raises(cs.SmokeFailure):
            cs.check_sketch_headers(bad, "bad")


def test_handoff_requests_end_in_partial_blocks():
    reqs = cs.handoff_requests(32000)
    assert reqs == cs.handoff_requests(32000)
    assert len(reqs) == cs.HANDOFF["requests"]
    lo, hi = cs.HANDOFF["prompt"]
    assert all(lo <= len(r) <= hi and len(r) % 16 for r in reqs)


def test_paged_exactness_at_tiny_width_on_the_cpu(monkeypatch):
    """6a's runs on the CPU (tiny, 4-token blocks, requests at once): every
    stream equals its solo stream, the small pool runs short, the shared
    prefix is hit, the handoff imports, no pool leaks, nothing launched."""
    from gpu_docker_api_tpu_torch.models import llama
    monkeypatch.setattr(cs, "STAGGER_S", 0.0)
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    draft = (cfg, llama.init_params(cfg, torch.Generator().manual_seed(1)))
    # ceil((5|9|13 + 20) / 4) = 7, 8, 9 blocks; 60% of 24 leaves 15
    # usable: any two requests fill them, the third runs short
    sizes = dict(slots=3, max_len=64, lens=(5, 9, 13), new=20, prefix=16,
                 suffixes=(2, 5, 7), prefill_chunk=8, prefix_cache=2,
                 decode_chunk=3, gamma=3)
    out = cs.batcher_exactness(torch, att, cfg, params, draft, sizes,
                               device="cpu", label="6a",
                               paged=dict(kv_block=4, pool_share=0.6))
    staggered = out["staggered"]
    assert staggered["pool_blocks"] == 16 and staggered["shortages"] >= 1
    assert out["chunked prefill, prefix cache, decode chunk"][
        "prefix_hits"] >= 1
    assert out["speculative"]["speculative"]["rounds"] >= 1
    assert out["handoff"] == {"requests": 2, "near_ties": 0,
                              "handoffs_in": 2}
    assert all(out[k]["near_ties"] == 0 for k in out
               if isinstance(out[k], dict) and "near_ties" in out[k])
    assert not any(out["launches"].values())


def test_paged_batching_http_checks_the_sketch_and_the_pool(tmp_path):
    """6b's HTTP check against `serve --device cpu --config tiny` with the
    paged batcher and the trie: the sketch headers on every response,
    healthz's pool drained to the trie's blocks."""
    from gpu_docker_api_tpu_torch.models import llama
    out = cs.batching_http(
        torch, "tiny", llama.LlamaConfig.tiny(), str(tmp_path), 1,
        traffic=TINY_TRAFFIC, paged=True,
        extra_args=("--device", "cpu", "--kv-block", "4",
                    "--prefix-cache", "2"))
    assert out["requests"] == 6 and out["prefix_cache"]["blocks"] > 0
    assert out["paged"]["freeBlocks"] == (out["paged"]["poolBlocks"] - 1
                                          - out["prefix_cache"]["blocks"])


def test_handoff_http_between_two_serve_processes(tmp_path):
    """6c against two `serve --device cpu --config tiny` processes: every
    handoff equals the full request, healthz counts the imports, the taken
    keys are 404s, and the orphan export is freed after its TTL."""
    from gpu_docker_api_tpu_torch.models import llama
    spec = dict(cs.HANDOFF, requests=2, prompt=(20, 40), new=5, ttl_s=0.5)
    out = cs.handoff_http(torch, "tiny", llama.LlamaConfig.tiny(),
                          str(tmp_path), spec=spec,
                          extra_args=("--device", "cpu"))
    assert out["handoffs_in"] == 2 and out["requests"] == 2
    assert out["orphan_blocks"] == -(-out["prompt_lens"][0] // 16)
    assert out["recompute_first_mismatch"] == [None, None]


# ---- phase 7: the MoE family ----------------------------------------------------

def _routes(idx, keep, top):
    """One RoutingRecorder entry from nested lists."""
    return (torch.tensor(idx), torch.tensor(keep), torch.tensor(top))


# three tokens, top-2 of 4: the reference's ranks 0..2 probabilities
TOP = [[0.5, 0.3, 0.1], [0.40004, 0.4, 0.1], [0.6, 0.2, 0.19995]]
IDX = [[0, 1], [2, 3], [1, 0]]
KEEP = [[True, True]] * 3


def test_routing_flips_takes_equal_routing_and_one_near_tie():
    ref = [_routes(IDX, KEEP, TOP), _routes(IDX, KEEP, TOP)]
    assert cs.routing_flips(ref, ref, "same") == ([], 3)
    # layer 1, token 1 swaps its two picks, 4e-5 apart: a near tie; the
    # positions before token 1 compare
    got = [ref[0], _routes([[0, 1], [3, 2], [1, 0]], KEEP, TOP)]
    flips, upto = cs.routing_flips(ref, got, "tie")
    assert [(f[0], f[1]) for f in flips] == [(1, 1)] and upto == 1
    assert flips[0][2] == pytest.approx(4e-5, rel=1e-3)
    # token 2 picks expert 2 where 1 was second-and-third apart by 5e-5
    got = [_routes([[0, 1], [2, 3], [1, 2]], KEEP, TOP), ref[1]]
    flips, upto = cs.routing_flips(ref, got, "tie")
    assert [(f[0], f[1]) for f in flips] == [(0, 2)] and upto == 2


def test_routing_flips_rejects_a_wide_gap_and_a_second_flip():
    ref = [_routes(IDX, KEEP, TOP)]
    wide = [_routes([[1, 0], [2, 3], [1, 0]], KEEP, TOP)]   # gap 0.2
    with pytest.raises(cs.SmokeFailure, match="gap"):
        cs.routing_flips(ref, wide, "wide")
    two = [_routes([[0, 1], [3, 2], [1, 2]], KEEP, TOP)]
    with pytest.raises(cs.SmokeFailure, match="at most 1"):
        cs.routing_flips(ref, two, "two")


def test_routing_flips_counts_a_changed_drop_as_the_first_moved_token():
    """A flip at token 2 that frees a capacity slot token 0 then keeps: the
    positions from token 0 on are no longer comparable."""
    ref = [_routes(IDX, [[True, False], [True, True], [True, True]], TOP)]
    got = [_routes([[0, 1], [2, 3], [1, 2]], KEEP, TOP)]
    flips, upto = cs.routing_flips(ref, got, "drop")
    assert len(flips) == 1 and upto == 0


def test_routing_flips_rejects_changed_drops_without_a_flip():
    """Drops that move while every decision is alike (a wrong capacity or
    slot order) fail, in whichever layer they first show."""
    ref = [_routes(IDX, KEEP, TOP),
           _routes(IDX, [[True, True], [True, False], [True, True]], TOP)]
    got = [ref[0], _routes(IDX, KEEP, TOP)]
    with pytest.raises(cs.SmokeFailure, match="decision alike"):
        cs.routing_flips(ref, got, "drops")
    assert cs.route_drops(ref) == [0, 1]


def test_moe_serve_bounds_count_every_expert_slot():
    from gpu_docker_api_tpu_torch.models import moe
    cfg = moe.MoEConfig.moe_1b()
    d, f, e, l_ = 1024, 2560, 8, 16
    attn = 2 * d * 128 * (8 + 4)
    w = l_ * (attn + 3 * e * d * f + d * e) * 2 + d * 32000 * 2
    # decode at B=8, context 144: capacity(8) = max(int(2.5), 2) = 2 slots
    # an expert, 16 slots in all, each through the whole SwiGLU
    ms, by = cs.serve_bounds(cfg, w, 8, 1, 144, False)
    keys = 145
    flops = (2 * (l_ * (attn + d * e) + d * 32000) * 8
             + 2 * l_ * 3 * d * f * e * 2 + 4 * 128 * 8 * l_ * 8 * keys)
    nbytes = w + 8 * 145 * cs.cache_bytes_per_token(cfg, False)
    assert cfg.capacity(8) == 2
    assert ms == pytest.approx(max(flops / cs.PEAK_BF16_FLOPS,
                                   nbytes / cs.PEAK_BYTES) * 1e3)
    assert by == ("operations" if flops / cs.PEAK_BF16_FLOPS
                  > nbytes / cs.PEAK_BYTES else "bytes")
    # prefill of 8 x 128 tokens: 320 slots an expert
    ms, by = cs.serve_bounds(cfg, w, 8, 128, 0, False)
    flops = (2 * (l_ * (attn + d * e) + d * 32000) * 8 * 128
             + 2 * l_ * 3 * d * f * e * 320
             + 4 * 128 * 8 * l_ * 8 * (128 * 129 // 2))
    assert cfg.capacity(1024) == 320 and by == "operations"
    assert ms == pytest.approx(flops / cs.PEAK_BF16_FLOPS * 1e3)


def test_moe_train_flops_are_the_jax_benchs_active_count():
    import bench
    from gpu_docker_api_tpu.models.moe import MoEConfig as JMoEConfig
    from gpu_docker_api_tpu_torch.models import moe
    got = cs.moe_train_flops(moe.MoEConfig.moe_1b(), 8, 2048)
    want = bench._train_step_flops(JMoEConfig.moe_1b(), 8, 2048)
    assert got == pytest.approx(want, rel=1e-12)
    assert 35e12 < got < 37e12


def test_moe_first_loss_is_the_init_loss():
    """The 7a formula against a real forward at init (moe_mini, f32, a
    batch of random tokens): within 0.1, 7a's limit."""
    import dataclasses
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.train import loss_fn
    cfg = dataclasses.replace(moe.MoEConfig.moe_mini(), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = moe.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    with torch.no_grad():
        loss = float(loss_fn(params, tokens, cfg, remat=False))
    assert loss == pytest.approx(cs.moe_first_loss(cfg), abs=0.1)


def test_host_load_limit_is_the_int8_tree_plus_the_largest_leaf():
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.train import Trainer
    from gpu_docker_api_tpu_torch.workloads.serve import _host_load
    cfg = moe.MoEConfig.tiny()
    served = _host_load(Trainer.create(cfg, device="cpu"), "", "w8")
    tree, largest = cs.host_load_limit(cfg, served)
    lay = served["layers"]
    want = (sum(v.numel() * 4 for k, v in served.items() if k != "layers"
                and k != "lm_head")
            + served["lm_head"].q.numel() + served["lm_head"].s.numel() * 4)
    for k, v in lay.items():
        want += (v.q.numel() + 4 * v.s.numel() if hasattr(v, "q")
                 else v.numel() * 4)
    assert tree == want
    # the largest dense leaf of tiny: the f32 embedding, 256 x 64
    assert largest == max(256 * 64 * 4, 2 * 4 * 64 * 96 * 4)


def test_moe_trunk_check_at_tiny_width_on_the_cpu():
    """7a's trunk on the CPU: the kernels' plain versions against the
    reference attention; no routing flip at this size, logits, router
    loss and grads within F32_TOL."""
    from gpu_docker_api_tpu_torch.models import moe
    out = cs.moe_trunk_check(torch, moe.MoEConfig.tiny(), s=48, device="cpu")
    assert out["flips"] == [] and out["compared_positions"] == 48
    assert out["grads_worst_leaf"] <= cs.F32_TOL


def test_moe_batchers_at_tiny_width_on_the_cpu():
    """7b's dense and paged batchers under one schedule on the CPU: every
    paged stream equals its dense one, nothing launched."""
    from gpu_docker_api_tpu_torch.models import moe
    cfg = moe.MoEConfig.tiny()
    params = moe.init_params(cfg, torch.Generator().manual_seed(0))
    sizes = dict(
        cs.MOE_BATCH, max_len=64, lens=(5, 9, 13, 7, 20, 11), new=6,
        kv_block=4)
    out = cs.moe_batchers(torch, att, cfg, params, sizes, device="cpu")
    assert out["requests"] == 6 and out["near_ties"] == 0
    assert not any(out["launches"].values())


def test_scheduled_streams_log_the_steps_and_their_routing():
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.workloads.serve import _Batcher
    cfg = moe.MoEConfig.tiny()
    params = moe.init_params(cfg, torch.Generator().manual_seed(1))
    prompts = [torch.tensor([3, 1, 4, 1, 5]), torch.tensor([9, 2, 6])]
    b = _Batcher(cfg, params, slots=2, max_len=32)
    log = {"events": []}

    def tick():
        with torch.no_grad():
            b._tick()
    try:
        with cs.RoutingRecorder(moe, log["events"]):
            streams = cs.scheduled_streams(b, tick, prompts, (0, 2), 4, log)
    finally:
        b.close()
    keys = [tuple(p.tolist()) for p in prompts]
    assert [len(s) for s in streams] == [4, 4]
    assert [len(log["gaps"][k]) for k in keys] == [4, 4]
    marks = [e for e in log["events"] if isinstance(e[0], str)]
    # request 0 prefills, decodes alone twice, request 1 joins
    assert marks[:4] == [("prefill", keys[0]), ("decode", [keys[0], None]),
                         ("decode", [keys[0], None]), ("prefill", keys[1])]
    # every step routes each layer once
    assert len(log["events"]) == len(marks) * (1 + cfg.n_layers)
    assert "_fn" not in vars(b) and "_arm_or_finish" not in vars(b)
    assert cs.schedule_moves(log["events"], log["events"], "same") == ({}, [])


def _route_event(idx, keep, top):
    return (torch.tensor(idx), torch.tensor(keep), torch.tensor(top))


A, B = (1, 2), (3, 4)
STEP = [("prefill", A), _route_event([[0, 1], [1, 0]], [[True, True]] * 2,
                                     [[0.5, 0.3, 0.1], [0.6, 0.2, 0.1]]),
        ("decode", [A, None]), _route_event(
            [[0, 1], [2, 3]], [[True, True], [True, False]],
            [[0.40004, 0.4, 0.1], [0.5, 0.3, 0.1]]),
        ("prefill", B), _route_event([[2, 3], [3, 2]], [[True, True]] * 2,
                                     [[0.5, 0.3, 0.1], [0.6, 0.2, 0.1]]),
        ("decode", [A, B]), _route_event(
            [[0, 1], [2, 3]], [[True, True], [True, True]],
            [[0.5, 0.3, 0.1], [0.5, 0.3, 0.1]])]


def _with(events, n, idx=None, keep=None):
    out = list(events)
    i0, k0, t0 = out[n]
    out[n] = (torch.tensor(idx) if idx is not None else i0,
              torch.tensor(keep) if keep is not None else k0, t0)
    return out


def test_schedule_moves_allows_an_inactive_rows_competition():
    """Step 1: the inactive row picks other experts and request A loses a
    capacity slot: A moves from its token 1 (token 0 came off the
    prefill)."""
    got = _with(STEP, 3, idx=[[0, 1], [0, 1]],
                keep=[[True, False], [True, True]])
    assert cs.schedule_moves(STEP, got, "junk") == ({A: 1}, [])


def test_schedule_moves_takes_one_near_tie_and_rejects_a_wide_gap():
    # A swaps its picks at step 1, 4e-5 apart
    moved, flips = cs.schedule_moves(STEP, _with(STEP, 3, idx=[[1, 0],
                                                               [2, 3]]), "t")
    assert moved == {A: 1} and len(flips) == 1
    # B flips at the last step where its gap is 0.2
    with pytest.raises(cs.SmokeFailure, match="gap"):
        cs.schedule_moves(STEP, _with(STEP, 7, idx=[[0, 1], [3, 2]]), "w")
    # A's prefill flips a token's picks at a wide gap
    with pytest.raises(cs.SmokeFailure, match="gap"):
        cs.schedule_moves(STEP, _with(STEP, 1, idx=[[1, 0], [1, 0]]), "p")
    with pytest.raises(cs.SmokeFailure, match="schedules differ"):
        cs.schedule_moves(STEP, STEP[:2] + [("decode", [A, A])] + STEP[3:],
                          "s")


# ---- phase 8: long context and sequence parallelism -----------------------------

@pytest.mark.parametrize("window", [0, 5, 16, 32, 40, 128])
def test_blockwise_launches_count_the_ports_plan(monkeypatch, window):
    """One launch of each kernel per flash_attention_lse call: count the
    calls blockwise_attention makes (CPU tensors, the plain versions) and
    hold them to the expected count phase 8a checks on the card."""
    calls = []
    real = att.flash_attention_lse

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(att, "flash_attention_lse", counted)
    q = torch.zeros(1, 128, 2, 16)
    att.blockwise_attention(q, q, q, window=window, chunk=16)
    assert len(calls) == cs.blockwise_launches(128, 16, window)


def test_blockwise_launches_at_phase_8s_shapes():
    assert cs.blockwise_launches(cs.LONG_S, cs.LONG_CHUNK) == 4
    assert cs.blockwise_launches(cs.LONG_S, cs.LONG_CHUNK,
                                 cs.LONG_WINDOW) == 15
    assert cs.blockwise_launches(65536, 2048) == 1 + 15 + 1   # 496 pairs
    assert [cs.sp_launches("ring", r) for r in range(4)] == [1, 2, 3, 4]
    assert {cs.sp_launches(c, r) for c in ("ulysses", "ring-window")
            for r in range(4)} == {1}
    assert cs.sp_launches("ring-einsum", 3) == 0


def _grads(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(1, 128, 2, 16, generator=g).to(dtype)
            for _ in cs.GRAD_NAMES]


def test_long_check_holds_bf16_to_the_whole_s_kernel():
    ref = _grads(0)
    kernel = [r.to(torch.bfloat16) for r in ref]
    got = cs.long_check(torch, kernel, ref, kernel, "same")
    assert all(r["excess"] == 1.0 for r in got.values())
    # one more bf16 rounding of each value: passes
    once = [(r + 1e-3 * torch.randn_like(r)).to(torch.bfloat16) for r in ref]
    cs.long_check(torch, once, ref, kernel, "one more rounding")
    # a 0.4% error on one tensor: within phase 1's check, but over 1.5 x
    # the kernel's Frobenius error
    bad = [k.clone() for k in kernel]
    bad[2] = (ref[2] * 1.004).to(torch.bfloat16)
    with pytest.raises(cs.SmokeFailure, match="dk: Frobenius"):
        cs.long_check(torch, bad, ref, kernel, "scaled dk")
    # a wrong band of rows: past phase 1's element-by-element check
    bad = [k.clone() for k in kernel]
    bad[0][:, :8] = 0
    with pytest.raises(cs.SmokeFailure, match="out: bf16"):
        cs.long_check(torch, bad, ref, kernel, "zeroed rows")
    nan = [k.clone() for k in kernel]
    nan[1][0, 0, 0, 0] = float("nan")
    with pytest.raises(cs.SmokeFailure, match="not finite"):
        cs.long_check(torch, nan, ref, kernel, "nan")


def test_sp_train_check_holds_moe_to_its_own_limits():
    """Phase 11 passes EP_LOSS_TOL / EP_NORM_TOL: a reading past the sp
    limits but within MoE's passes them, one past MoE's fails."""
    one = {"losses": [10.0, 9.0], "grad_norms": [1.0, 2.0]}
    tols = (cs.EP_LOSS_TOL, cs.EP_NORM_TOL)
    assert cs.EP_LOSS_TOL > cs.SP_LOSS_TOL and cs.EP_NORM_TOL > cs.SP_NORM_TOL
    mid = {"losses": [10.0 * (1 + cs.EP_LOSS_TOL / 2), 9.0],
           "grad_norms": [1.0, 2.0 * (1 + cs.EP_NORM_TOL / 2)]}
    cs.sp_train_check(one, [mid] * 4, "mid", tols)
    with pytest.raises(cs.SmokeFailure, match="against sp=1"):
        cs.sp_train_check(one, [mid] * 4, "mid")
    far = dict(mid, grad_norms=[1.0, 2.0 * (1 + 2 * cs.EP_NORM_TOL)])
    with pytest.raises(cs.SmokeFailure, match="against sp=1"):
        cs.sp_train_check(one, [far] * 4, "far", tols)


def test_long_check_holds_f32_to_f32_tol():
    ref = _grads(1)
    near = [r + cs.F32_TOL * 0.5 for r in ref]
    got = cs.long_check(torch, near, ref, None, "f32")
    assert max(got.values()) == pytest.approx(cs.F32_TOL * 0.5, rel=1e-3)
    far = [r.clone() for r in ref]
    far[3] = far[3] + 3 * cs.F32_TOL * (1 + far[3].abs())
    with pytest.raises(cs.SmokeFailure, match="dv: max"):
        cs.long_check(torch, far, ref, None, "f32")


def test_sp_train_check_wants_equal_ranks_within_the_limits():
    one = {"losses": [10.0, 9.0, 8.0], "grad_norms": [1.0, 2.0, 3.0]}
    same = dict(one)
    rel = cs.sp_train_check(one, [same] * 4, "same")
    assert rel == {"loss": [0.0] * 3, "grad_norm": [0.0] * 3}
    close = {"losses": [10.0 * (1 + cs.SP_LOSS_TOL / 2), 9.0, 8.0],
             "grad_norms": [1.0, 2.0 * (1 - cs.SP_NORM_TOL / 2), 3.0]}
    cs.sp_train_check(one, [close] * 4, "close")
    with pytest.raises(cs.SmokeFailure, match="ranks report"):
        cs.sp_train_check(one, [close, same], "differ")
    far = dict(close, losses=[10.0 * (1 + 2 * cs.SP_LOSS_TOL), 9.0, 8.0])
    with pytest.raises(cs.SmokeFailure, match="against sp=1"):
        cs.sp_train_check(one, [far] * 4, "far")


def test_long_launches_read_phase_8s_paths():
    runs = {f"bf16_window{w}": {"launches": {"flash_fwd": n}}
            for w, n in ((0, 4), (cs.LONG_WINDOW, 15))}
    cases = {f"{c} torch.bfloat16": {"launches": [
        {"flash_fwd": n} for n in counts]}
        for c, counts in (("ring", (1, 2, 3, 4)), ("ulysses", (1,) * 4))}
    got = cs.long_launches({"blockwise": runs, "cases": cases}, "flash_fwd")
    assert got == {"blockwise_window0": 4,
                   f"blockwise_window{cs.LONG_WINDOW}": 15,
                   "ring_4_ranks": 10, "ulysses_4_ranks": 4}


# ---- phase 9 ----------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [1, 2, 4])
def test_fsdp_state_bytes_are_what_a_sharded_trainer_holds(fsdp):
    """fsdp_state_bytes counts from the shapes and kinds alone what the
    Trainer's init leaves on one rank: params, mu and nu over fsdp, the
    norms whole."""
    from gpu_docker_api_tpu_torch.parallel.comm import AxisGroup
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan
    from gpu_docker_api_tpu_torch.train import Trainer, tree_leaves

    cfg = cs_config("tiny")
    plan = MeshPlan(fsdp=fsdp)
    groups = (MeshGroups(plan, 1, fsdp=AxisGroup(None, 1, fsdp),
                         world=AxisGroup(None, 1, fsdp)) if fsdp > 1
              else None)
    state = Trainer.create(cfg, plan, device="cpu", groups=groups).init()
    held = sum(cs.leaf_bytes(t) for tree in (
        state["params"], state["opt_state"]["mu"], state["opt_state"]["nu"])
        for t in tree_leaves(tree))
    assert held == cs.fsdp_state_bytes(cfg, fsdp)
    whole = cs.fsdp_state_bytes(cfg, 1)
    norms = 3 * 4 * cfg.d_model * (2 * cfg.n_layers + 1)
    assert held == (whole - norms) // fsdp + norms


def cs_config(name):
    from gpu_docker_api_tpu_torch.models import named_config
    return named_config("llama", name)


def test_fsdp_launches_are_one_ranks_or_the_rings():
    assert cs.fsdp_launches({"fsdp": 4}, 0, 20) == {
        "flash_fwd": 40, "flash_bwd_dq": 20, "flash_bwd_dkv": 20}
    assert cs.fsdp_launches({"dp": 2, "fsdp": 2}, 0, 20) == \
        cs.fsdp_launches({"fsdp": 4}, 0, 20)
    assert [cs.fsdp_launches({"fsdp": 2, "sp": 2}, r, 20)["flash_fwd"]
            for r in (0, 1)] == [40, 80]
    fsdp = {"layouts": {"9a": {"launches_a_step": [
        {"flash_fwd": 40, "flash_bwd_dq": 20}] * 2}}}
    assert cs.fsdp_kernel_launches(fsdp, "flash_bwd_dq") == {"9a": [20, 20]}


def test_resharded_checkpoint_check_finds_a_changed_shard(tmp_path):
    """A whole state saved, the ranks' digests cut from it: every shard
    matches; a digest of another shard is caught."""
    ranks = _saved_and_digested(tmp_path, {"fsdp": 2}, "9a")
    cfg = cs_config("tiny")
    n = cs.check_resharded_checkpoint(str(tmp_path), cfg, ranks,
                                      {"fsdp": 2}, 1)
    assert n == 3 * 12 * 2
    with pytest.raises(cs.SmokeFailure, match="checkpoint at step 1"):
        cs.check_resharded_checkpoint(str(tmp_path), cfg, ranks,
                                      {"fsdp": 2}, 2)
    ranks[1]["9a"]["digests"]["mu"]["layers.w2"] = \
        ranks[0]["9a"]["digests"]["mu"]["layers.w2"]
    with pytest.raises(cs.SmokeFailure, match="mu layers.w2: rank 1"):
        cs.check_resharded_checkpoint(str(tmp_path), cfg, ranks,
                                      {"fsdp": 2}, 1)


def _saved_and_digested(tmp_path, plan, layout):
    """A one-rank state of tiny after a step, saved as a checkpoint under
    tmp_path, and each rank's digests of its shards under `plan`, as
    layout_rank reports them for `layout`."""
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshPlan, shard
    from gpu_docker_api_tpu_torch.train import (
        Trainer, param_specs, save_checkpoint,
    )

    cfg = cs_config("tiny")
    tr = Trainer.create(cfg, device="cpu")
    state = tr.init(seed=2)
    state, _ = tr.step(state, tr.shard_batch(np.zeros((2, 16), np.int64)))
    save_checkpoint(str(tmp_path), state, 1)
    specs = dict(cs.flat_leaves(param_specs(cfg)))
    plan = MeshPlan(**plan)

    def rank_digests(r):
        opt = state["opt_state"]
        return {layout: {"digests": {part: {
            path: cs.leaf_digest(shard(t, specs[path], plan, r))
            for path, t in cs.flat_leaves(tree)}
            for part, tree in (("params", state["params"]),
                               ("mu", opt["mu"]), ("nu", opt["nu"]))}}}
    return [rank_digests(r) for r in range(plan.size)]


def test_phase_fsdp_at_tiny_width_on_the_cpu():
    """Phase 9 end to end on the CPU at `tiny` (f32): four gloo ranks
    through 9a, 9b and 9c against one rank, the state bytes, no launch
    (the plain versions), the checkpoint check."""
    out = cs.phase_fsdp(torch, att, device="cpu", config="tiny",
                        train=dict(b=4, s=32, steps=3))
    assert set(out["layouts"]) == set(cs.FSDP_LAYOUTS)
    for name, (plan, steps) in cs.FSDP_LAYOUTS.items():
        got = out["layouts"][name]
        assert len(got["losses"]) == steps
        assert max(got["rel_to_one_rank"]["loss"]) <= 1e-5
        assert got["state_bytes_a_rank"] == [cs.fsdp_state_bytes(
            cs_config("tiny"), plan.get("fsdp", 1))] * cs.FSDP_RANKS


# ---- phase 10 ---------------------------------------------------------------

def test_resharded_checkpoint_check_reassembles_fsdp_and_tp(tmp_path):
    """Under fsdp=2 x tp=2 each rank's digests are of its slices over both
    axes (embed's vocab chunks tp major): every shard matches; two ranks'
    embed shards swapped are caught."""
    ranks = _saved_and_digested(tmp_path, {"fsdp": 2, "tp": 2}, "10b")
    cfg = cs_config("tiny")
    n = cs.check_resharded_checkpoint(str(tmp_path), cfg, ranks,
                                      {"fsdp": 2, "tp": 2}, 1, "10b")
    assert n == 3 * 12 * 4
    embed = [r["10b"]["digests"]["params"]["embed"] for r in ranks]
    assert len(set(embed)) == 4                   # four distinct chunks
    ranks[1]["10b"]["digests"]["params"]["embed"] = embed[2]
    with pytest.raises(cs.SmokeFailure, match="params embed: rank 1"):
        cs.check_resharded_checkpoint(str(tmp_path), cfg, ranks,
                                      {"fsdp": 2, "tp": 2}, 1, "10b")


@pytest.mark.parametrize("plan", [{"tp": 2}, {"tp": 4}, {"fsdp": 2, "tp": 2},
                                  {"tp": 2, "sp": 2}])
def test_shard_bytes_are_what_a_tp_trainer_holds(plan):
    """shard_bytes counts from the shapes and kinds alone each leaf a
    rank's init leaves under a tp plan: every matrix 1/(fsdp * tp), the
    norms whole; fsdp_state_bytes is three times their sum."""
    from gpu_docker_api_tpu_torch.parallel.comm import AxisGroup
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan
    from gpu_docker_api_tpu_torch.train import Trainer

    cfg = cs_config("tiny")
    mplan = MeshPlan(**plan)
    rank = mplan.size - 1
    groups = MeshGroups(mplan, rank, world=AxisGroup(None, rank, mplan.size))
    state = Trainer.create(cfg, mplan, device="cpu", groups=groups).init()
    want = cs.shard_bytes(cfg, plan)
    for tree in (state["params"], state["opt_state"]["mu"],
                 state["opt_state"]["nu"]):
        assert {p: cs.leaf_bytes(t) for p, t in cs.flat_leaves(tree)} == want
    cut = plan.get("fsdp", 1) * plan["tp"]
    assert want["embed"] == 256 * 64 * 4 // cut
    assert want["layers.attn_norm"] == 2 * 64 * 4
    assert cs.fsdp_state_bytes(cfg, plan.get("fsdp", 1), plan["tp"]) == \
        3 * sum(want.values())


def test_tp_heads_and_sums_follow_the_plan():
    """The q heads a rank's attention runs over: H/tp where both head
    counts divide, all H in the head-gather fallback; the tp sums a step,
    none without tp."""
    assert cs.tp_heads(cs_config("1b"), {"tp": 4}) == 4
    assert cs.tp_heads(cs_config("1b"), {"fsdp": 2, "tp": 2}) == 8
    assert cs.tp_heads(cs_config("mini"), {"tp": 4}) == 4
    assert cs.tp_heads(cs_config("mini"), {"tp": 2}) == 2
    assert cs.tp_heads(cs_config("tiny"), {"tp": 1}) == 4
    assert cs.tp_sums_a_step(20, {"tp": 4}) == 104
    assert cs.tp_sums_a_step(20, {"fsdp": 4}) == 0


def test_phase_tp_at_tiny_width_on_the_cpu():
    """Phase 10 end to end on the CPU at `tiny` (f32): four gloo ranks
    through 10a-10d against one rank, each leaf's bytes, no launch (the
    plain versions), the heads and the tp sums a step, the checkpoint
    check over fsdp and tp."""
    out = cs.phase_tp(torch, att, device="cpu",
                      configs={"main": "tiny", "fallback": "tiny"},
                      train=dict(b=4, s=32, steps=2), layout_steps=2)
    assert set(out["layouts"]) == set(cs.TP_LAYOUTS)
    assert out["checkpoint_shards"] == 3 * 12 * 4
    for name, (_, plan, _) in cs.TP_LAYOUTS.items():
        got = out["layouts"][name]
        assert len(got["losses"]) == 2
        assert max(got["rel_to_one_rank"]["loss"]) <= 1e-5
        assert got["tp_sums_a_step"]["calls"] == cs.tp_sums_a_step(2, plan)
        assert got["state_bytes_a_rank"] == [cs.fsdp_state_bytes(
            cs_config("tiny"), plan.get("fsdp", 1), plan["tp"])] * cs.TP_RANKS


# ---- A1: the cut phases 8-10 ------------------------------------------------

def test_cut_phases_feed_the_launch_formulas():
    """Phases 8c, 9 and 10 run 2 steps in 8c, in every layout of phase 9
    and in phase 10's checkpointing layout (2 keep every check there: the
    step time is the median of the steps after the first), LAYOUT_STEPS
    in phase 10's others;
    phases 9 and 10, 8c and 13a llama 1b at 4 of its 20 layers, full
    width; the launches a rank and step follow from the cut depth by the
    same formula."""
    assert cs.SP_TRAIN["steps"] == 2 and cs.FSDP_TRAIN["steps"] == 2
    assert {name: steps for name, (_, steps) in cs.FSDP_LAYOUTS.items()} \
        == {"9a": 2, "9b": 2, "9c": 2}
    assert cs.TP_TRAIN["steps"] == 2
    cut, full = cs.smoke_config(cs.FSDP_CONFIG), cs_config("1b")
    assert cut.n_layers == 4 and full.n_layers == 20
    assert dataclasses.replace(cut, n_layers=20) == full
    assert cs.TP_CONFIGS["main"] == cs.FSDP_CONFIG
    assert cs.fsdp_launches({"fsdp": 4}, 0, cut.n_layers) == {
        "flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
    assert [cs.fsdp_launches({"tp": 2, "sp": 2}, r, cut.n_layers)
            ["flash_bwd_dkv"] for r in (0, 1)] == [4, 8]
    assert cs.tp_sums_a_step(cut.n_layers, {"tp": 4}) == 24
    assert cs.MW_SCALE["config"] == cs.FSDP_CONFIG
    assert cs.fsdp_launches(cs.MW_PLAN, 0, cut.n_layers) == {
        "flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
    assert cs.smoke_config(cs.SP_CONFIG) == cut
    assert cs.smoke_config("mini") == cs_config("mini")
    assert cs.smoke_config(("moe", "1b", None)).n_layers == 16


def test_the_cuts_that_make_room_for_phase_16():
    """12d runs moe_1b at phase 11's depth (4 of 16 layers, full width);
    13b's f32 ranks and 13c's batchers run llama 1b and moe_1b at 4 of
    their layers (13b's HTTP half serves llama 1b whole, by name); 13b's
    burst is 4 requests of 8-16 new tokens and its timed decodes 17
    tokens."""
    assert cs.PP_CONFIGS["moe"] == cs.EP_CONFIG == ("moe", "1b", 4)
    full = cs.smoke_config(("moe", "1b", None))
    assert dataclasses.replace(cs.smoke_config(cs.PP_CONFIGS["moe"]),
                               n_layers=16) == full
    assert (cs.MW_SCALE["llama"], cs.MW_SCALE["moe"],
            cs.MW_SCALE["depth"]) == ("1b", "1b", 4)
    assert cs.MH_TRAFFIC == dict(requests=4, clients=4, prompt=(128, 256),
                                 new=(8, 16))
    assert cs.MH_TIME == dict(prompt=128, new=17)


def test_the_cuts_that_make_room_for_phase_17():
    """5a's f32 batchers run llama 1b and 7b's f32 oracle and batchers
    moe_1b at 4 of their layers (13b's f32 depth; 6a and every serve
    process stay whole), 7c's burst asks 32 new tokens a request, the
    traced decode windows are 8 steps in 5b and 6b and 2 in the serving
    times, the layouts of phases 10-12 beside each phase's checkpointing
    one take one step on the card (phase 9's dp and sp layouts keep two:
    each axis keeps a two-step layout), as does 13a (its plan, 10b's,
    keeps two), and
    phase 17's relay asks 8 new tokens a prompt: depth and steps, never
    width."""
    import inspect
    assert cs.EXACT_DEPTH == cs.MW_SCALE["depth"] == 4
    assert cs.BUSY_STEPS == 8 and cs.MOE_TIME == dict(context=128, steps=32)
    assert cs.MOE_TRAFFIC == dict(requests=16, clients=8, prompt=(128, 512),
                                  new=(32, 32))
    assert cs.TIME_STEPS == 64 and cs.BATCH_TRAFFIC["new"] == (64, 128)
    # phases 10-12: each phase's checkpointing layout takes 2 steps, the
    # others one; phase 9's take 2
    assert cs.LAYOUT_STEPS == 1
    assert {steps for _, steps in cs.FSDP_LAYOUTS.values()} == {2}
    assert cs.MW_SCALE["train"] == cs.MW_TRAIN == dict(cs.FSDP_TRAIN,
                                                         steps=1)
    assert cs.TIME_BUSY_STEPS == 2 and cs.GW_PROMPTS["new"] == 8
    layouts = cs.pp_layouts(cs.PP_CONFIGS, cs.PP_TRAIN)
    assert {n: e[3] for n, e in layouts.items()} == {
        "12a": 1, "12b": 2, "12c": 1, "12d": 1}
    for fn, cut in ((cs.phase_batching, True), (cs.phase_moe, True),
                    (cs.phase_paged, False)):
        assert ("n_layers=EXACT_DEPTH" in inspect.getsource(fn)) is cut


# ---- phase 11 ---------------------------------------------------------------

def moe_config(name):
    from gpu_docker_api_tpu_torch.models import named_config
    return named_config("moe", name)


@pytest.mark.parametrize("layout", sorted(cs.EP_LAYOUTS))
def test_shard_bytes_are_what_an_ep_trainer_holds(layout):
    """shard_bytes cuts each leaf by the axes its spec names: under each
    phase 11 plan the bytes of every leaf an MoE trainer's init leaves on
    a rank, banks over ep, fsdp and tp, the f32 router and the norms
    whole."""
    from gpu_docker_api_tpu_torch.parallel.comm import AxisGroup
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan
    from gpu_docker_api_tpu_torch.train import Trainer

    cfg = moe_config("tiny")
    plan = cs.EP_LAYOUTS[layout][0]
    mplan = MeshPlan(**plan)
    rank = mplan.size - 1
    groups = MeshGroups(mplan, rank, world=AxisGroup(None, rank, mplan.size))
    state = Trainer.create(cfg, mplan, device="cpu", groups=groups).init()
    want = cs.shard_bytes(cfg, plan)
    for tree in (state["params"], state["opt_state"]["mu"],
                 state["opt_state"]["nu"]):
        assert {p: cs.leaf_bytes(t) for p, t in cs.flat_leaves(tree)} == want
    bank = 2 * 4 * 64 * 96 * 4
    cut = plan.get("ep", 1) * plan.get("fsdp", 1) * plan.get("tp", 1)
    assert want["layers.we1"] == bank // cut
    assert want["layers.router"] == 2 * 64 * 4 * 4


def test_state_bytes_of_phase_11_and_the_earlier_phases():
    """The per-rank state of each phase 11 layout at moe_1b's width and 4
    of its 16 layers (EP_CONFIG), moe_1b's whole at full depth (the
    prediction in PERF.md), and phases 9 and 10's at llama 1b's full
    depth as shard_bytes gave them before it read the specs."""
    one = cs.smoke_config(cs.EP_CONFIG)
    assert {name: cs.state_bytes(one, plan) for name, (plan, _)
            in cs.EP_LAYOUTS.items()} == {
        "11a": 846704640, "11b": 612347904, "11c": 495169536,
        "11d": 1224192000}
    assert cs.state_bytes(one, {}) == 1979166720
    assert cs.state_bytes(moe_config("1b"), {}) == 6736982016
    assert cs.fsdp_state_bytes(cs_config("1b"), 4) == 1613193216
    assert cs.fsdp_state_bytes(cs_config("1b"), 2, 2) == 1613193216
    assert cs.state_bytes(cs_config("1b"), {"tp": 2, "sp": 2}) == \
        3225378816
    assert cs.fsdp_state_bytes(cs_config("mini"), 1, 4) == 66902016


def test_phase_11_launches_and_tp_sums():
    """8/4/4 a rank and step at phase 11's 4 layers of moe_1b, the ring's
    rank + 1 times as many in 11d; MoE's tp sums, 6 a layer + 4 (100 at
    moe_1b's full 16 layers)."""
    n = cs.smoke_config(cs.EP_CONFIG).n_layers
    for plan, _ in cs.EP_LAYOUTS.values():
        if plan.get("sp", 1) == 1:
            assert cs.fsdp_launches(plan, 0, n) == {
                "flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
    assert [cs.fsdp_launches(cs.EP_LAYOUTS["11d"][0], r, n)
            for r in (0, 1)] == [
        {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4},
        {"flash_fwd": 16, "flash_bwd_dq": 8, "flash_bwd_dkv": 8}]
    assert cs.tp_sums_a_step(n, {"tp": 4}, moe=True) == 28
    assert cs.tp_sums_a_step(moe_config("1b").n_layers, {"tp": 4},
                             moe=True) == 100
    assert cs.tp_sums_a_step(n, {"ep": 4}, moe=True) == 0


def _rank_routes(b, s, plan, seed=3):
    """A global routing (gate_idx, keep, top probs) of one layer over b*s
    tokens and each rank's part of it, as layout_rank reports it."""
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshPlan, coords
    gen = torch.Generator().manual_seed(seed)
    probs = torch.rand(b * s, 4, generator=gen).softmax(-1)
    top, idx = probs.sort(dim=-1, descending=True)
    call = (idx[:, :2].clone(), torch.rand(b * s, 2, generator=gen) > 0.2,
            top[:, :3].clone())
    mplan = MeshPlan(**plan)
    n_rows = mplan.dp * mplan.fsdp * mplan.ep
    runs = []
    for r in range(mplan.size):
        c = coords(mplan, r)
        row = (c["dp"] * mplan.fsdp + c["fsdp"]) * mplan.ep + c["ep"]
        rb, sl = b // n_rows, s // mplan.sp
        part = tuple(x.reshape(b, s, -1)[row * rb:(row + 1) * rb,
                                          c["sp"] * sl:(c["sp"] + 1) * sl]
                     .reshape(rb * sl, -1) for x in call)
        runs.append({"coords": c, "routes": [part]})
    return [call], runs


@pytest.mark.parametrize("layout", sorted(cs.EP_LAYOUTS))
def test_routing_ranks_assembles_the_global_order(layout):
    """Each rank's routing put back at its rows and sequence shard is the
    one-rank routing; a decision moved on one rank, far from a tie, is
    caught, and so are tp ranks that route apart."""
    plan = cs.EP_LAYOUTS[layout][0]
    ref, runs = _rank_routes(4, 8, plan)
    assert cs.routing_ranks(ref, runs, plan, layout, 4, 8) == []
    last = runs[-1]["routes"][0]
    runs[-1]["routes"] = [(last[0].flip(-1), *last[1:])]
    want = "apart" if plan.get("tp", 1) > 1 else "gap of"
    with pytest.raises(cs.SmokeFailure, match=want):
        cs.routing_ranks(ref, runs, plan, layout, 4, 8)


def test_phase_ep_at_tiny_width_on_the_cpu():
    """Phase 11 end to end on the CPU at MoE `tiny` (f32): four gloo ranks
    through 11a-11d against one rank, each leaf's bytes, no launch (the
    plain versions), the heads and the tp sums a step, the routing of
    every layer, the checkpoint check over fsdp and ep."""
    out = cs.phase_ep(torch, att, device="cpu", config=("moe", "tiny", None),
                      train=dict(b=8, s=32, steps=2), layout_steps=2)
    assert set(out["layouts"]) == set(cs.EP_LAYOUTS)
    assert out["checkpoint_shards"] == 3 * 13 * 4
    for name, (plan, _) in cs.EP_LAYOUTS.items():
        got = out["layouts"][name]
        assert len(got["losses"]) == 2
        assert max(got["rel_to_one_rank"]["loss"]) <= 1e-5
        assert got["routing_flips"] == []
        assert got["tp_sums_a_step"]["calls"] == cs.tp_sums_a_step(
            2, plan, moe=True)
        assert got["state_bytes_a_rank"] == [cs.state_bytes(
            moe_config("tiny"), plan)] * cs.EP_RANKS


# ---- phase 12 ---------------------------------------------------------------

def test_phase_12_state_bytes_and_launches():
    """The per-rank state of each phase 12 layout at its size (llama 1b's
    width at 4 of its 20 layers, moe_1b's at 4 of its 16; the prediction
    in PERF.md:
    under pp every layer leaf 1/pp too, embed and lm_head whole on each
    stage) and its launches a rank and step: a stage's layers once a
    microbatch, the ring's rank + 1 times in 12c; 2 steps in 12b, which
    checkpoints, and one in the others."""
    layouts = cs.pp_layouts(cs.PP_CONFIGS, cs.PP_TRAIN)
    got = {}
    for name, entry in layouts.items():
        config, plan, _, steps, opts = cs.layout_fields(entry)
        cfg = cs.smoke_config(config)
        got[name] = (cs.state_bytes(cfg, plan), [
            cs.fsdp_launches(plan, r, cfg.n_layers,
                             opts["tc"]["n_microbatches"])["flash_fwd"]
            for r in range(plan.get("sp", 1))], opts["b"], steps)
    assert got == {"12a": (1069621248, [8], 4, 1),
                   "12b": (676454400, [8], 4, 2),
                   "12c": (1352785920, [8, 16], 4, 1),
                   "12d": (808710144, [8], 8, 1)}
    assert cs.fsdp_launches({"pp": 4}, 0, 20, 4) == {
        "flash_fwd": 40, "flash_bwd_dq": 20, "flash_bwd_dkv": 20}
    # without pp the microbatches change nothing (phases 9-11)
    assert cs.fsdp_launches({"fsdp": 4}, 0, 20, 4) == cs.fsdp_launches(
        {"fsdp": 4}, 0, 20)


def test_phase_pp_at_tiny_width_on_the_cpu():
    """Phase 12 end to end on the CPU at `tiny` with 4 layers (f32): four
    gloo ranks through 12a-12d against one rank (the plain microbatched
    version for MoE), each leaf's bytes, no launch (the plain versions),
    the grouped checkpoint shard for shard and served ungrouped."""
    configs = {"llama": ("llama", "tiny", 4), "moe": ("moe", "tiny", 4)}
    out = cs.phase_pp(torch, att, device="cpu", configs=configs,
                      train=dict(b=4, s=32, steps=2), layout_steps=2)
    assert set(out["layouts"]) == set(cs.PP_LAYOUTS)
    assert out["checkpoint_shards"] == 3 * 12 * 4
    assert "serve_restore_s" in out["wall"]
    for name, (fam, plan, *_) in cs.PP_LAYOUTS.items():
        got = out["layouts"][name]
        assert len(got["losses"]) == 2
        assert max(got["rel_to_one_rank"]["loss"]) <= 1e-5
        assert max(got["rel_to_one_rank"]["grad_norm"]) <= 1e-5
        assert got["state_bytes_a_rank"] == [cs.state_bytes(
            cs.smoke_config(configs[fam]), plan)] * cs.PP_RANKS


def test_served_ungrouped_check_finds_a_changed_leaf(tmp_path):
    """check_served_ungrouped passes a grouped checkpoint served as it is
    and fails one whose stored layer differs from what serve loads."""
    from gpu_docker_api_tpu_torch.parallel.pipeline import group_layers
    from gpu_docker_api_tpu_torch.train import Trainer, save_checkpoint
    from gpu_docker_api_tpu_torch.workloads import serve

    cfg = dataclasses.replace(cs_config("tiny"), n_layers=4)
    params = Trainer.create(cfg, device="cpu").init(seed=1)["params"]
    params["layers"] = group_layers(params["layers"], 2, 2)
    save_checkpoint(str(tmp_path), {"params": params, "step": 0}, 1)
    assert cs.check_served_ungrouped(str(tmp_path), cfg, "12b") == 12
    load = serve._restore_params

    def shifted(*args):
        got, step = load(*args)
        got["layers"]["wq"] = got["layers"]["wq"].roll(1, 0)
        return got, step
    serve._restore_params = shifted
    try:
        with pytest.raises(cs.SmokeFailure, match="served layers.wq"):
            cs.check_served_ungrouped(str(tmp_path), cfg, "12b")
    finally:
        serve._restore_params = load


# ---- phase 13 ---------------------------------------------------------------

MW_TINY = dict(
    config=("llama", "tiny", None), train=dict(b=4, s=32, steps=1),
    llama="tiny", moe="tiny", depth=1,   # the card cuts 13b and 13c to 4
    sizes=dict(slots=4, max_len=96, lens=(7, 12, 20, 9, 15, 11), new=8,
               prefix=20, suffixes=(3, 5, 8, 11), prefix_cache=4),
    moe_sizes=dict(slots=3, max_len=48, lens=(5, 9, 6, 12), at=(0, 1, 3, 6),
                   new=7),
    oracle=dict(b=2, prompt=11, steps=7), kv_block=16,
    serve=("--batch-slots", "8", "--batch-max-len", "96"),
    traffic=dict(requests=4, clients=2, prompt=(8, 16), new=(4, 8)),
    time=dict(prompt=8, new=9),
    cotenancy=dict(be_weight=3, lat_weight=1, slots=4, max_len=128,
                   be_lens=(10, 14, 18, 22), be_new=100, lat_lens=(9, 12),
                   lat_new=8, decode_chunk=8))


def test_phase_multiworker_at_tiny_width_on_the_cpu():
    """Phase 13 end to end on the CPU at `tiny` (f32): 13a train_llama's
    loop on 2 workers x 2 gloo ranks against one rank (the records'
    "process" field, the checkpoint shard for shard), 13b the f32
    lock-step checks against one rank's references and the serve ranks
    over HTTP (both workers stopping with 0), 13c two co-tenant batchers
    (a preemption, single steps while contended) and a co-tenant serve
    process."""
    cfg = cs.smoke_config(MW_TINY["config"])
    # the card's 13a trains one step against phase 9's two-step run
    one = cs.sp_train(torch, "cpu", cfg, dict(MW_TINY["train"], steps=2),
                      "ring")
    out = cs.phase_multiworker(torch, att, one, {}, device="cpu",
                               scale=MW_TINY)
    train = out["train"]
    assert max(train["rel_to_one_rank"]["loss"]) <= 1e-5
    assert train["state_bytes_a_rank"] == [cs.state_bytes(
        cfg, cs.MW_PLAN)] * (cs.MW_WORKERS * cs.MW_LOCAL)
    assert all(r["process"] == "0/2" for r in train["records"])
    assert [r["step"] for r in train["records"]] == [1]
    serve = out["serve"]
    assert serve["shard_kv"]["kv_bytes_a_rank"] == [
        serve["whole_kv_bytes"] // cs.MH_TP] * cs.MW_WORKERS
    assert serve["http"]["exit_codes"] == [0, 0]
    assert out["cotenancy"]["preempt_total"] > 0


# ---- phase 14: the GPU seam's node layer ------------------------------------

SEAM_TINY = dict(b=2, s=16)
SEAM_OVER = dict(grant=1 << 30, alloc=2 << 30, deadline_s=60)


@pytest.fixture
def keep_sigusr1():
    """train_llama.main installs the quiesce handler; give the old one back."""
    import signal
    old = signal.getsignal(signal.SIGUSR1)
    yield
    signal.signal(signal.SIGUSR1, old)


def test_phase_seam_at_tiny_width_on_the_cpu(tmp_path, keep_sigusr1):
    """Phase 14 end to end on the CPU at `tiny`, over a one-card mock
    topology: the grant, its env and nodes, the refused second grant, the
    rebuild from the drained store, the child launched through the process
    backend with the grant (no kernel launch on CPU tensors), its losses
    against an in-process run of the same argv, the watchdog's load
    reading, and the release at its own revision."""
    from gpu_docker_api_tpu_torch.topology import make_topology
    from gpu_docker_api_tpu_torch.workloads import train_llama
    argv = cs.seam_argv("cpu", "tiny", SEAM_TINY)
    assert train_llama.main(argv + ["--workdir", str(tmp_path)]) == 0
    steps, _ = cs.read_metrics(str(tmp_path / "metrics.jsonl"))
    out = cs.phase_seam(torch, [r["loss"] for r in steps], device="cpu",
                        topo=make_topology("h100-1"), config="tiny",
                        shape=SEAM_TINY, over=SEAM_OVER,
                        watched=dict(containers=4, seconds=0.5),
                        want_launches=dict.fromkeys(att.LAUNCHES, 0))
    assert out["loss_diffs"] == [0.0, 0.0, 0.0]
    assert out["child"]["rc"] == 0 and out["child"]["count"] == 0
    assert out["child"]["vm"]["VmData"] < cs.SEAM_MEMORY_BYTES
    assert out["grant_revision"] < out["release_revision"]
    assert out["over_grant"]["exit"] not in (None, 0)
    assert out["watchdog"]["containers"] == 4 and out["watchdog"]["polls"] > 0
    assert out["topology"]["acceleratorType"] == "h100-1"


def test_seam_fails_on_a_child_that_breaks_its_grant(tmp_path, monkeypatch,
                                                     keep_sigusr1):
    """A child whose losses are not phase 2's fails the phase."""
    from gpu_docker_api_tpu_torch.topology import make_topology
    with pytest.raises(cs.SmokeFailure, match="against phase 2"):
        cs.phase_seam(torch, [0.0, 0.0, 0.0], device="cpu",
                      topo=make_topology("h100-1"), config="tiny",
                      shape=SEAM_TINY, over=SEAM_OVER,
                      want_launches=dict.fromkeys(att.LAUNCHES, 0))


def test_uuid_reference_prefers_nvidia_smi():
    from gpu_docker_api_tpu_torch.topology import Chip, GpuTopology
    uuid = "46fc04bf-19d5-a7c9-023d-1411cd925509"
    topo = GpuTopology("h100-1", "h100", (1, 1, 1), chips=[
        Chip(0, (0, 0, 0), "/dev/nvidia5", f"GPU-{uuid.upper()}")],
        chips_per_host=1)
    assert cs.uuid_reference(topo, 0) == uuid
    redacted = GpuTopology("h100-1", "h100", (1, 1, 1), chips=[
        Chip(0, (0, 0, 0), "/dev/nvidia5", "")], chips_per_host=1)
    with pytest.raises(cs.SmokeFailure, match="no UUID"):
        cs.uuid_reference(redacted, 0)


# ---- phase 15 -----------------------------------------------------------------

SVC_TINY_STEPS = 40    # tiny takes tens of ms a step: v1 is still running


def test_phase_services_at_tiny_width_on_the_cpu(tmp_path, keep_sigusr1):
    """Phase 15 end to end on the CPU at `tiny`, over a one-card mock
    topology: the volume and the replicaSet through the services on the
    guarded process backend with a warm torch worker, the span trees, the
    quiesced memory patch on the same card (held in the store throughout),
    the gapless steps with an uninterrupted run's losses, both versions
    warm-started, history, stop, delete, and the card free again; the card
    guard's worker, whose preimport finds no driver on this build, runs
    its job warm."""
    from gpu_docker_api_tpu_torch.topology import make_topology
    from gpu_docker_api_tpu_torch.workloads import train_llama
    argv = cs.seam_argv("cpu", "tiny", SEAM_TINY, SVC_TINY_STEPS)
    assert train_llama.main(argv + ["--workdir", str(tmp_path),
                                    "--checkpoint-every", "1000"]) == 0
    steps, _ = cs.read_metrics(str(tmp_path / "metrics.jsonl"))
    out = cs.phase_services(torch, [r["loss"] for r in steps], device="cpu",
                            topo=make_topology("h100-1"), config="tiny",
                            shape=SEAM_TINY, steps=SVC_TINY_STEPS,
                            want_per_step=dict.fromkeys(att.LAUNCHES, 0))
    assert out["loss_diffs"] == [0.0] * SVC_TINY_STEPS
    assert out["steps"] == list(range(1, SVC_TINY_STEPS + 1))
    assert out["replace"]["quiesced"] and out["replace"]["quiesceStep"] >= 1
    assert all(c["warm"] for c in out["children"].values())
    assert [c["rc"] for c in out["children"].values()] == [143, 0]
    assert out["card0_history"][-1][1] is None
    revs = out["revisions"]
    assert revs["boot"] < revs["run"] < revs["patch"] < revs["stop"] \
        < revs["delete"]
    assert out["checkpoint_bytes"] > 0 and out["quiesce_ack_ms"] > 0
    guard = out["driver_guard"]
    assert (guard["driver_initialised"], guard["cold"], guard["count"]) \
        == (False, False, 0)


def test_phase_services_fails_on_losses_that_are_not_the_reference(
        tmp_path, keep_sigusr1):
    """Losses that are not the uninterrupted run's fail the phase, after
    the replace (the services clean up behind the failure)."""
    from gpu_docker_api_tpu_torch.topology import make_topology
    with pytest.raises(cs.SmokeFailure, match="against the reference"):
        cs.phase_services(torch, [0.0] * SVC_TINY_STEPS, device="cpu",
                          topo=make_topology("h100-1"), config="tiny",
                          shape=SEAM_TINY, steps=SVC_TINY_STEPS,
                          want_per_step=dict.fromkeys(att.LAUNCHES, 0))


# ---- phase 17: the serving control plane ------------------------------------

GW_TINY = dict(
    traffic=dict(requests=24, clients=16, prompt=(16, 48), new=(48, 64)),
    prompts=dict(n=4, prompt=(16, 48), new=8, seed=11),
    serve_args=("--batch-slots", "8", "--batch-max-len", "128",
                "--batch-prefill-chunk", "32"))


def _answer(status, code, n, hdrs=None):
    env = {"code": code, "msg": "ok",
           "data": {"tokens": [list(range(n))]} if code == 200 else None}
    return status, env, hdrs or {}, 0.1


def test_relay_check_holds_the_gateway_to_the_replicas_envelope():
    env = {"code": 200, "msg": "ok", "data": {"tokens": [[1, 2, 3]]}}
    cs.relay_check([(200, env)] * 2, [(200, dict(env))] * 2, "t")
    altered = {"code": 200, "msg": "ok", "data": {"tokens": [[1, 2, 4]]}}
    with pytest.raises(cs.SmokeFailure, match="through the gateway"):
        cs.relay_check([(200, env)], [(200, altered)], "t")
    with pytest.raises(cs.SmokeFailure, match="through the gateway"):
        cs.relay_check([(200, env)], [(429, env)], "t")
    with pytest.raises(cs.SmokeFailure, match="directly"):
        cs.relay_check([(200, {"code": 500})], [(200, env)], "t")
    with pytest.raises(cs.SmokeFailure, match="relayed answers"):
        cs.relay_check([(200, env)], [], "t")


def test_shares_check_reads_card_0s_ledger():
    gpus = {"chips": [{"index": 0, "shares": {"g1br0": 2, "g1br1": 2}},
                      {"index": 1, "shares": {}}]}
    cs.shares_check(gpus, {"g1br0": 2, "g1br1": 2}, "t")
    with pytest.raises(cs.SmokeFailure, match="card 0's shares"):
        cs.shares_check(gpus, {"g1br0": 2}, "t")
    gpus["chips"][1]["shares"] = {"g1br1": 2}
    gpus["chips"][0]["shares"] = {"g1br0": 2}
    with pytest.raises(cs.SmokeFailure, match="other cards"):
        cs.shares_check(gpus, {"g1br0": 2}, "t")


def test_drained_check_wants_the_shm_counters_at_0():
    cs.drained_check({"inflight": 0, "queued": 0, "requestsTotal": 9}, "t")
    for left in ({"inflight": 1, "queued": 0}, {"inflight": 0, "queued": 2}):
        with pytest.raises(cs.SmokeFailure, match="after the drain"):
            cs.drained_check(left, "t")


def test_burst_and_active_checks_judge_each_answer():
    reqs = [([1], 4), ([2], 5), ([3], 6), ([4], 7)]
    results = [_answer(200, 200, 4), _answer(429, 429, 0,
                                             {"Retry-After": "1"}),
               None, _answer(504, 504, 0, {"Retry-After": "1"})]
    assert cs.burst_check(results, reqs, 10, "t") == (1, 2, 1)
    with pytest.raises(cs.SmokeFailure, match="request 0"):
        cs.burst_check([_answer(200, 200, 3)], reqs[:1], 10, "t")
    with pytest.raises(cs.SmokeFailure, match="shed"):
        cs.burst_check([_answer(429, 429, 0)], reqs[:1], 10, "t")
    cs.active_check({"g1br0": 8, "g1br1": 3}, 8, "t")
    with pytest.raises(cs.SmokeFailure, match="above 8 active"):
        cs.active_check({"g1br0": 9}, 8, "t")


def test_replica_launches_check_wants_every_replicas_zero():
    zero = dict.fromkeys(att.LAUNCHES, 0)
    both = {"g1br0": zero, "g1br1": dict(zero)}
    assert cs.replica_launches_check(both, ("g1br0", "g1br1"), att.LAUNCHES,
                                     "t") == zero
    with pytest.raises(cs.SmokeFailure, match="flash launches"):
        cs.replica_launches_check(dict(both, g1br1=dict(zero, flash_fwd=2)),
                                  ("g1br0", "g1br1"), att.LAUNCHES, "t")
    with pytest.raises(cs.SmokeFailure, match="want"):
        cs.replica_launches_check({"g1br0": zero}, ("g1br0", "g1br1"),
                                  att.LAUNCHES, "t")
    with pytest.raises(cs.SmokeFailure, match="want"):
        cs.replica_launches_check({"g1br0": {}, "g1br1": zero},
                                  ("g1br0", "g1br1"), att.LAUNCHES, "t")


def test_latency_count_check_and_the_exposition_readers():
    cs.latency_count_check(40, 40, 0, 0, "t")
    cs.latency_count_check(42, 40, 2, 0, "t")
    with pytest.raises(cs.SmokeFailure, match="latency family"):
        cs.latency_count_check(39, 40, 0, 3, "t")
    with pytest.raises(cs.SmokeFailure, match="latency family"):
        cs.latency_count_check(44, 40, 1, 2, "t")
    text = "\n".join([
        '# TYPE h histogram',
        'h_bucket{gateway="g",le="1.0"} 1',
        'h_bucket{gateway="g",le="10.0"} 6',
        'h_bucket{gateway="g",le="+Inf"} 10',
        'h_count{gateway="g"} 10',
        'h_bucket{gateway="x",le="+Inf"} 0'])
    fams, samples = cs.prometheus_families(text)
    assert fams == {"h": "histogram"}
    assert ("h_count", {"gateway": "g"}, 10.0) in samples
    assert cs.histogram_quantiles(samples, "h", {"gateway": "g"}) == [
        10.0, float("inf")]
    for other in ({"gateway": "x"}, {"gateway": "y"}):
        assert cs.histogram_quantiles(samples, "h", other) == [None, None]
    with pytest.raises(cs.SmokeFailure, match="sample value"):
        cs.prometheus_families('h_count{gateway="g"} ten')


def test_phase_gateway_at_tiny_width_on_the_cpu():
    """Phase 17 end to end on the CPU at `tiny`, over a one-card mock line:
    the daemon with two SO_REUSEPORT workers, gateway g1b of serve.py
    replicas at 0.5 of card 0, the relay, the burst scaling up by a clone,
    the worker tier's burst with a worker SIGKILLed and respawned, the
    counters drained, the latency family over both tiers, scale to 1, the
    stitched trace and the delete."""
    out = cs.phase_gateway(torch, att, device="cpu", mock_topology="h100-1",
                           config="tiny", **GW_TINY)
    assert out["scale_up"]["cloned"] and out["scale_up"]["replica"] == "g1br1"
    assert out["in_process"]["answered"] == GW_TINY["traffic"]["requests"]
    tier = out["worker_tier"]
    assert tier["respawns"] >= 1 and tier["counters"]["inflight"] == 0
    assert tier["answered"] + tier["dropped"] + tier["shed"] == \
        GW_TINY["traffic"]["requests"]
    assert out["trace"]["spans"] == sorted(
        ["POST /api/v1/gateways/:name/generate", "gateway.admit",
         "gateway.forward"])
    assert out["launches"] == dict.fromkeys(att.LAUNCHES, 0)
    assert sorted(out["launches_by_replica"]) == ["g1br0", "g1br1"]


# ---- the room: serve starts forked from the rank server, the wall line ------

def test_a_serve_start_forks_from_the_rank_server(tmp_path):
    """start_rank_server starts multiprocessing's fork server with torch
    and serve.py to import; await_rank_server returns once it forks.
    spawn_serve forks the serve process from it (its parent is the
    server), with its output in the start's log, and it answers as the
    port's serve.py does; a second start forks from the same server."""
    from multiprocessing import forkserver
    cs.start_rank_server()
    cs.await_rank_server()
    server = forkserver._forkserver._forkserver_pid
    for log_name in ("a.log", "b.log"):
        proc, port, log_path = cs.spawn_serve(
            "tiny", str(tmp_path), ("--device", "cpu"), log_name=log_name)
        try:
            proc, port, ready_s, health = cs.wait_serve(proc, port, log_path)
            with open(f"/proc/{proc.pid}/status") as f:
                ppid = next(int(line.split()[1]) for line in f
                            if line.startswith("PPid:"))
            assert ppid == server != os.getpid()
            assert health["code"] == 200
            assert health["data"]["model"] == "llama/tiny"
            assert "serving llama/tiny" in open(log_path).read()
        finally:
            proc.kill()
            proc.join(60)
        assert proc.exitcode is not None


def test_a_sigterm_unwinds_the_script_through_its_finally_blocks(tmp_path):
    """After unwind_on_sigterm (main's first step), a SIGTERM raises
    SystemExit(143): the finally blocks that end a phase's daemons run."""
    import subprocess
    src = ("import os, signal, sys, time\n"
           f"sys.path.insert(0, {os.path.dirname(cs.__file__)!r})\n"
           "import chip_smoke as cs\n"
           "cs.unwind_on_sigterm()\n"
           "try:\n"
           "    os.kill(os.getpid(), signal.SIGTERM)\n"
           "    time.sleep(60)\n"
           "finally:\n"
           "    print('unwound', flush=True)\n")
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 143, out.stderr
    assert out.stdout == "unwound\n"


def test_the_wall_line_gives_every_phase_on_its_own():
    line = cs.wall_line(1234.5, [float(i) for i in range(19)])
    assert line.startswith("wall time: the whole script 1234.5 s; ")
    for i in range(19):
        assert f"phase {i} {float(i):.1f} s" in line


# ---- phase 18: the fleet and the native engines --------------------------------

def _parity_readings(**change):
    good = {"first_answer_diff": None, "observable_checks": 3,
            "observable_equal": True, "wal_equal": True,
            "wal_bytes": {"python": 9, "native": 9},
            "cross_reads_equal": {"native_reads_python": True,
                                  "python_reads_native": True}}
    return {**good, **change}


def test_engine_parity_check_rejects_every_doctored_reading():
    cs.engine_parity_check(_parity_readings(), "x")
    for bad in ({"first_answer_diff": 17}, {"observable_equal": False},
                {"observable_checks": 0}, {"wal_equal": False},
                {"cross_reads_equal": {"native_reads_python": False,
                                       "python_reads_native": True}},
                {"cross_reads_equal": {}}):
        with pytest.raises(cs.SmokeFailure):
            cs.engine_parity_check(_parity_readings(**bad), "x")


def test_the_lockstep_and_the_finder_pairs_hold_on_the_cpu(tmp_path):
    """18a's own readings, small: the engines' lockstep (each engine's
    answers, reads, revisions and WAL bytes, and each reading the other's
    WAL) and the native finder's boxes against the Python search's."""
    from gpu_docker_api_tpu_torch.topology import make_topology
    r = cs.engine_lockstep(str(tmp_path), dict(ops=300, seed=7,
                                               check_every=29))
    cs.engine_parity_check(r, "cpu")
    assert r["wal_bytes"]["python"] == r["wal_bytes"]["native"] > 0
    pairs = cs.finder_pairs(lambda: make_topology("h100-8"),
                            dict(trials=30, seed=3, sizes=(1, 2, 4, 8)))
    cs.finder_check(pairs, "cpu")
    assert any(nat for nat, _ in pairs)
    times = cs.engine_times(str(tmp_path), n=50)
    assert set(times) == {"python", "native"}
    assert cs.grant_ms(lambda: make_topology("h100-8"), True, n=10) > 0


def test_finder_check_rejects_boxes_apart():
    cs.finder_check([([0, 1], [0, 1]), ([], None)], "x")
    for bad in ([([0, 1], [1, 2])], [([], [3])], [([2], None)], []):
        with pytest.raises(cs.SmokeFailure):
            cs.finder_check(bad, "x")


def test_takeover_check_wants_the_next_epoch_and_one_takeover():
    before = {"holder": "a", "epoch": 1}
    cs.takeover_check(before, {"holder": "b", "epoch": 2}, 1, 1, "x")
    for args in ((before, {"holder": "b", "epoch": 1}, 1, 1),
                 (before, {"holder": "b", "epoch": 3}, 1, 1),
                 (before, {"holder": "a", "epoch": 2}, 1, 1),
                 (before, None, 1, 1),
                 ({"holder": "b", "epoch": 1}, {"holder": "b", "epoch": 2},
                  1, 1),
                 (before, {"holder": "b", "epoch": 2}, 2, 1),
                 (before, {"holder": "b", "epoch": 2}, 1, 0)):
        with pytest.raises(cs.SmokeFailure):
            cs.takeover_check(*args, "x")


def test_horizon_check_loses_no_acknowledged_revision():
    cs.horizon_check(40, 38, 12, "rec", "rec", "x")
    for args in ((37, 38, 12, "rec", "rec"), (40, 38, 41, "rec", "rec"),
                 (40, 38, 12, None, "rec"), (40, 38, 12, "old", "rec")):
        with pytest.raises(cs.SmokeFailure):
            cs.horizon_check(*args, "x")


def test_gapless_resume_check_and_the_split_of_the_runs():
    recs = [{"step": s} for s in (3, 4, 5, 3, 4)]
    a, b = cs.split_runs(recs, 2)
    assert [r["step"] for r in a] == [3, 4, 5]
    assert [r["step"] for r in b] == [3, 4]
    cs.gapless_resume_check([3, 4, 5], [3, 4], 2, 2, "x")
    for args in (([3, 4, 5], [4, 5], 2, 2), ([3, 5], [3, 4], 2, 2),
                 ([], [3, 4], 2, 2), ([3], [3], 2, 2),
                 ([3], [3, 5], 2, 2), ([4], [3, 4], 2, 2)):
        with pytest.raises(cs.SmokeFailure):
            cs.gapless_resume_check(*args, "x")


def test_resumed_launches_check_takes_the_recorded_steps_and_one_more():
    per = {"flash_fwd": 40, "flash_bwd_dq": 20, "flash_bwd_dkv": 20}
    cs.resumed_launches_check({"flash_fwd": 80, "flash_bwd_dq": 40,
                               "flash_bwd_dkv": 40}, per, 2, "x")
    cs.resumed_launches_check({"flash_fwd": 100, "flash_bwd_dq": 50,
                               "flash_bwd_dkv": 40}, per, 2, "x")
    for bad in ({"flash_fwd": 79, "flash_bwd_dq": 40, "flash_bwd_dkv": 40},
                {"flash_fwd": 121, "flash_bwd_dq": 40, "flash_bwd_dkv": 40},
                {"flash_fwd": 80, "flash_bwd_dq": 40}):
        with pytest.raises(cs.SmokeFailure):
            cs.resumed_launches_check(bad, per, 2, "x")


def test_the_one_card_defrag_answer_is_the_jax_daemons():
    """FLEET_DEFRAG_ONE_CARD, which 18b holds the port's daemon to, is what
    the JAX App answers for one card on a held one-card line."""
    import json
    import tempfile

    from gpu_docker_api_tpu import topology as jtopo
    from gpu_docker_api_tpu.dtos import ContainerRun
    from gpu_docker_api_tpu.server.app import App
    from gpu_docker_api_tpu.server.http import Request
    a = App(state_dir=tempfile.mkdtemp(), backend="mock",
            addr="127.0.0.1:0", topology=jtopo.TpuTopology(
                "h100-1", "h100", (1, 1, 1), chips_per_host=1),
            api_key="", cpu_cores=4, placement_policy=cs.FLEET_POLICY)
    try:
        a.replicasets.run_container(ContainerRun(
            imageName="i", replicaSetName="t", tpuCount=1))
        resp = a.h_defrag(Request(
            "POST", "/api/v1/placement/defrag", {},
            json.dumps({"tpuCount": 1}).encode(), {}, {}))
        assert resp.data["defrag"] == cs.FLEET_DEFRAG_ONE_CARD
    finally:
        a.stop()


def test_phase_fleet_at_tiny_width_on_the_cpu(tmp_path, keep_sigusr1):
    """Phase 18 end to end on the CPU at `tiny`, over a one-card mock line:
    the native cores, the lockstep and the finders; the standby B and the
    primary A on the native store, A's trainer resumed from a step-2
    checkpoint, A SIGKILLed with its children, B's steal behind the next
    epoch, the promote at the horizon, the trainer recreated and resumed
    gapless with an uninterrupted run's losses, GET /placement, the
    one-card defrag, stop and delete."""
    from gpu_docker_api_tpu_torch.workloads import train_llama
    shape = dict(b=2, s=16)
    ref = tmp_path / "ref"
    assert train_llama.main(cs.seam_argv("cpu", "tiny", shape, 12) + [
        "--workdir", str(ref), "--checkpoint-every", "1000"]) == 0
    losses = [r["loss"] for r in cs.read_metrics(
        str(ref / "metrics.jsonl"))[0]]
    hand = tmp_path / "handoff"
    assert train_llama.main(cs.seam_argv("cpu", "tiny", shape, 2) + [
        "--workdir", str(hand), "--checkpoint-every", "2"]) == 0
    out = cs.phase_fleet(torch, losses, {"dir": str(hand), "step": 2},
                         device="cpu", mock_topology="h100-1",
                         config="tiny", shape=shape,
                         want_per_step=dict.fromkeys(att.LAUNCHES, 0))
    assert out["store_engines"] == {"a": "native", "b": "native"}
    assert sorted(out["boot_to_ping_s"]) == ["a", "b"]
    assert out["grant_before"]["holder"] == "a"
    assert out["grant_after"] == {**out["grant_before"], "holder": "b",
                                  "epoch": out["grant_before"]["epoch"] + 1,
                                  "modRevision": out["grant_after"][
                                      "modRevision"]}
    assert out["horizon"] >= out["acked_revision"] >= out["record_revision"]
    assert out["a_steps"][0] == out["b_steps"][0] == 3
    assert out["loss_diffs"] and max(out["loss_diffs"]) == 0.0
    assert out["placement_pool"]["freeChips"] == 0
    assert out["defrag"] == cs.FLEET_DEFRAG_ONE_CARD
    assert not hand.exists()


def test_phase_fleet_times_18a_before_it_starts_a_daemon(tmp_path,
                                                        monkeypatch):
    """Phase 18 takes 18a's put / get and grant timings before it spawns
    a daemon, so no daemon's boot runs beside a timed window; a failed
    phase leaves its scratch directories removed."""
    calls = []

    def record(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(cs, name, wrapped)

    record("engine_times", cs.engine_times)
    record("grant_ms", cs.grant_ms)
    record("engine_lockstep", cs.engine_lockstep)

    def no_daemon(*a, **kw):
        calls.append("spawn_daemon")
        raise cs.SmokeFailure("stop before the daemons")

    monkeypatch.setattr(cs, "spawn_daemon", no_daemon)
    hand = tmp_path / "handoff"
    hand.mkdir()
    with pytest.raises(cs.SmokeFailure, match="stop before the daemons"):
        cs.phase_fleet(torch, [], {"dir": str(hand), "step": 2},
                       device="cpu", mock_topology="h100-1", config="tiny")
    assert calls == ["engine_times", "grant_ms", "grant_ms", "spawn_daemon"]
    assert not hand.exists()



# ---- phase 16's lifecycle: the rollback and the train-to-serve handoff ------

def _history(mem3=48 << 30, chips3=(0,), plan3=None):
    plan = {"dp": 1, "fsdp": 1, "pp": 1, "ep": 1, "tp": 1, "sp": 1}

    def item(v, mem, chips, mesh):
        return {"version": v, "status": {"spec": {
            "memory_bytes": mem, "tpu_chips": list(chips),
            "mesh_plan": mesh}}}
    return [item(3, mem3, chips3, plan3 or plan),
            item(2, 40 << 30, (0,), plan), item(1, 48 << 30, (0,), plan)]


def test_rollback_check_wants_version_3_with_v1s_spec():
    answer = {"code": 200, "data": {"version": 3, "tpuChips": [0]}}
    got = cs.rollback_check(200, answer, _history(), "t")
    assert got["version"] == 3 and got["memory_bytes"] == 48 << 30
    bad_answers = (
        (500, answer),
        (200, {"code": 1018, "data": None}),
        (200, {"code": 200, "data": {"version": 2, "tpuChips": [0]}}),
        (200, {"code": 200, "data": {"version": 3, "tpuChips": [1]}}))
    for status, bad in bad_answers:
        with pytest.raises(cs.SmokeFailure, match="rollback answered"):
            cs.rollback_check(status, bad, _history(), "t")
    # v3 keeping v2's memory, another card or another plan is no rollback
    for hist in (_history(mem3=40 << 30), _history(chips3=(1,)),
                 _history(plan3={"dp": 2})):
        with pytest.raises(cs.SmokeFailure, match="v3's spec"):
            cs.rollback_check(200, answer, hist, "t")
    with pytest.raises(cs.SmokeFailure, match="history"):
        cs.rollback_check(200, answer, _history()[:2], "t")


def test_lifecycle_steps_check_catches_a_gap_and_a_missing_park():
    assert cs.lifecycle_steps_check(list(range(1, 13)), [2, 4], 12, "t") == 4
    gap = [1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12]          # step 4 lost
    repeat = [1, 2, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]  # a replayed step
    for steps in (gap, repeat, list(range(1, 12))):
        with pytest.raises(cs.SmokeFailure, match="steps lost"):
            cs.lifecycle_steps_check(steps, [2, 4], 12, "t")
    # v2 ended before the rollback's quiesce: one park only
    for marks in ([2], [4, 2], [2, 12], [2, 4, 6]):
        with pytest.raises(cs.SmokeFailure, match="parked"):
            cs.lifecycle_steps_check(list(range(1, 13)), marks, 12, "t")


def test_served_tokens_check_catches_a_token_that_differs():
    cs.served_tokens_check([[1, 2, 3], [4, 5, 6]], [[1, 2, 3], [4, 5, 6]],
                           "t")
    for served in ([[1, 2, 3], [4, 9, 6]], [[1, 2, 3]], [[1, 2], [4, 5]]):
        with pytest.raises(cs.SmokeFailure, match="served|generated"):
            cs.served_tokens_check(served, [[1, 2, 3], [4, 5, 6]], "t")


def test_serve_from_a_trainers_checkpoint_at_tiny_width_on_the_cpu(tmp_path):
    """16d's readings at `tiny` on the CPU: a trainer's checkpoints, the
    port's serve.py started on them with --checkpoint, and this process's
    own load of the newest (checkpoint_greedy): the served greedy tokens
    equal the in-process ones, and a served token planted to differ is
    caught."""
    from gpu_docker_api_tpu_torch.models import named_config
    from gpu_docker_api_tpu_torch.workloads import train_llama
    assert train_llama.main(cs.seam_argv("cpu", "tiny", dict(b=2, s=16), 3)
                            + ["--workdir", str(tmp_path / "run"),
                               "--checkpoint-every", "2"]) == 0
    ckpt = str(tmp_path / "run" / "checkpoints")
    cfg = named_config("llama", "tiny")
    proc, port, _, health = cs.start_serve(
        "tiny", str(tmp_path), ("--device", "cpu", "--checkpoint", ckpt))
    try:
        assert health["data"]["model"] == "llama/tiny"
        gen = torch.Generator().manual_seed(19)
        prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
        served, _ = cs.http_call(port, "POST", "/generate",
                                 {"tokens": prompt.tolist(), "max_new": 6})
    finally:
        proc.kill()
        proc.join(60)
    direct, step = cs.checkpoint_greedy(torch, ckpt, cfg, prompt, 6, "cpu")
    assert step == 3
    assert "restored checkpoint step 3" in open(
        tmp_path / "serve_subprocess.log").read()
    cs.served_tokens_check(served["data"]["tokens"], direct, "t")
    planted = [list(row) for row in served["data"]["tokens"]]
    planted[1][4] = (planted[1][4] + 1) % cfg.vocab_size
    with pytest.raises(cs.SmokeFailure, match="row 1"):
        cs.served_tokens_check(planted, direct, "t")


def _optim_leaves(dtype, n=4097, decay=False):
    gen = torch.Generator().manual_seed(7)

    def leaf(scale):
        return (scale * torch.randn(n, generator=gen)).to(dtype)
    if decay:
        return [leaf(0.02)] + [torch.zeros(n, dtype=dtype) for _ in range(3)]
    return [leaf(0.02), leaf(1.0), leaf(1e-2), leaf(1e-2).abs_()]


@pytest.mark.parametrize("dtype,decay", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, True)])
def test_optim_case_passes_the_kernel_and_rejects_every_planted_fault(
        dtype, decay):
    """phase 1b's check at a small size: on the CPU the wrapper runs the
    plain version, which must pass; no weight decay and (f32) bf16 math
    must each be rejected, as on the card."""
    kw = dict(cs.OPTIM_HYPER, bc1=0.19, bc2=0.0975)
    norm = torch.tensor(50.0)
    if decay:
        kw.update(lr=0.1, weight_decay=0.5, bc1=0.1, bc2=0.05)
        norm = torch.tensor(0.5)
    out = cs.optim_case(torch, *_optim_leaves(dtype, decay=decay), norm, kw)
    want = {"kernel", "no_weight_decay"} | (
        {"bf16_math"} if dtype == torch.float32 else set())
    assert set(out) == want
    cs.check_optim_case("cpu", out)
    assert out["kernel"] == {"p": 0, "mu": 0, "nu": 0}


def test_optim_case_lets_a_bf16_no_decay_fault_through_at_the_usual_step():
    """Why phase 1b adds the decay step: at lr 3e-4 and weight decay 0.1
    the term is under a bf16 ulp of p, so the bf16 check alone cannot
    see it dropped."""
    kw = dict(cs.OPTIM_HYPER, bc1=0.19, bc2=0.0975)
    out = cs.optim_case(torch, *_optim_leaves(torch.bfloat16),
                        torch.tensor(50.0), kw)
    with pytest.raises(cs.SmokeFailure, match="no_weight_decay passed"):
        cs.check_optim_case("cpu", out)
