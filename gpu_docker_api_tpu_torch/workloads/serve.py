"""Schedulable inference server, PyTorch port of the single-host path of
gpu_docker_api_tpu/workloads/serve.py.

The control plane schedules this exactly like the training workload
(`POST /replicaSet {"cmd": [... serve, ...]}`, the granted port passed via
--port or $PORT): it loads a model (a fresh seeded init, or the newest
checkpoint of a torch `train_llama` workdir) and answers token-level
generation requests over HTTP, byte-compatible with the JAX server:

  GET  /healthz               -> {"code":200, "data":{"model","params",
                                  "vocab","maxSeqLen"[, "batching"]}}
  POST /generate              body {"tokens": [[...]], "max_new": N,
                                    "temperature": 0.0, "top_k": 0,
                                    "top_p": 1.0}
                              -> {"code":200, "data":{"tokens": [[...]]}}
  GET  /kv?key=K              -> a paged batcher's prompt-KV export (the
                                  handoff; once, then 404)
  GET  /launches              -> {"code":200, "data":{kernel: launches}}:
                                  the flash kernels this process launched
                                  (ops.attention.LAUNCHES; the port's own
                                  route, for a caller that checks which
                                  kernels a replica ran)

Every response is HTTP 200 with the control plane's {code, msg, data}
envelope (an --admit-queue shed is code 429 with Retry-After and
X-TDAPI-Shed). Without --batch-slots serving is single-flight: one request
at a time runs infer.generate (or infer.speculative_generate for one row
when a draft is loaded). With --batch-slots N the continuous batcher
(_Batcher over batching.py) serves single-row requests: they join a
running slot batch between decode steps, and every response carries the
batcher's X-TDAPI-Slots / -Active / -Queued / -Queue-Wait-EWMA-Ms headers,
and the request's own X-TDAPI-Queue-Wait-Ms (enqueue to slot admission),
-First-Token-Ms (enqueue to its first token) and -Token-Gap-Ms (first
token to last over the tokens after the first; left out for one-token
answers). The scheduler thread's hot-path spans (obs/trace.hot: serve.tick
and its serve.admit, serve.prefill_piece, serve.first_token,
serve.decode_step and serve.emit, and serve.sleep between idle ticks) open
profiler ranges while armed and a profiler runs.
With --kv-block B the batcher's cache is paged (paging.py): one block pool
(--kv-pool), zero-copy prefix sharing, and prefill/decode disaggregation
(the X-TDAPI-Phase: prefill / X-TDAPI-KV-Key / X-TDAPI-KV-Source request
headers, GET /kv); with --prefix-cache too, every response carries the
X-TDAPI-KV-Sketch / -Occ prefix sketch. --device cpu serves from the CPU
instead of the card (tests). --tp is read by multi-host serving only.
--family moe serves the MoE family, dense or int8 (its expert banks always
w8). --host-load --quantize w8|w8a8 builds the weights on the host and
streams them to the card as int8, leaf by leaf: the card never holds the
dense tree.

A co-tenancy env (TDAPI_TPU_SHARES / TDAPI_PRIORITY) with --batch-slots
registers the batcher as a tenant of its chip's regulator (regulator.py).

A multi-worker grant (TPU_WORKER_HOSTNAMES over more than one host) is
served in lock-step over ranks (_serve_multihost): each worker runs its
ranks of JAX's serving plan (tp, fsdp the rest) in one group formed at the
contract's coordinator; global rank 0 serves HTTP and broadcasts each
request (single-flight) or each tick's admissions (_LockstepBatcher, with
--batch-slots: dense, paged, prefix cache, speculative, int8 KV, and
--shard-kv to cut the cache over tp), and every rank runs the same steps
on its shards. The multi-host refusals are the JAX server's.

Run: python -m gpu_docker_api_tpu_torch.workloads.serve --config tiny \
        --device cpu --port 8000 [--batch-slots 4 [--kv-block 16]]
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..obs import trace


def _maybe_ungroup(params: dict, config) -> dict:
    """Checkpoints from interleaved-pipelined trainers store layers as
    [v, pp, Lc, ...] (pipeline.group_layers). The sequential KV-cache
    forward needs the canonical [L, ...] stack; detect the two extra
    leading dims against the family's canonical shapes and ungroup."""
    from ..models import param_shapes
    from ..parallel.pipeline import ungroup_layers

    got = next(iter(params["layers"].values())).dim()
    want = len(next(iter(param_shapes(config)["layers"].values()))[0])
    if got == want:
        return params
    if got == want + 2:
        lead = next(iter(params["layers"].values())).shape
        v, pp = int(lead[0]), int(lead[1])
        params = dict(params)
        params["layers"] = ungroup_layers(params["layers"], pp, v)
        print(f"ungrouped interleaved checkpoint (v={v}, pp={pp})",
              flush=True)
        return params
    raise ValueError(
        f"layer leaves have {got} dims, expected {want} (canonical) or "
        f"{want + 2} (group_layers layout)")


def _restore_params(trainer, ckpt_dir: str, device) -> tuple[dict, int]:
    """The params of the newest checkpoint under `ckpt_dir` on `device`,
    ungrouped if an interleaved trainer saved them (_maybe_ungroup), then
    held to the one-rank template."""
    from ..train import check_template, restore_checkpoint

    # scheduled workloads pass volume-bind paths relative to
    # $CONTAINER_ROOT (the process substrate's cwd)
    state, step = restore_checkpoint(os.path.abspath(ckpt_dir),
                                     device=device)
    params = _maybe_ungroup(state["params"], trainer.config)
    check_template(params, trainer.abstract_state()["params"])
    return params, step


def _load_params(trainer, ckpt_dir: str | None, init_seed: int = 0) -> dict:
    """Served weights: a fresh Trainer.init(init_seed), or the newest
    checkpoint under `ckpt_dir` (a train_llama workdir's checkpoints/,
    _restore_params), detached from autograd once (the trainer's leaves
    require grad)."""
    from ..train import tree_map
    if not ckpt_dir:
        params = trainer.init(init_seed)["params"]
    else:
        params, step = _restore_params(trainer, ckpt_dir, trainer.device)
        print(f"restored checkpoint step {step}", flush=True)
    return tree_map(lambda t: t.detach(), params)


def _host_load(trainer, ckpt_dir: str | None, mode: str,
               init_seed: int = 0) -> dict:
    """--host-load: the served weights as int8 on the trainer's device,
    without the dense tree ever on it. A checkpoint is restored onto the
    host; a fresh init draws each leaf where Trainer.init(init_seed) draws
    it (the trainer's device generator, in its order, so the numbers are
    the same) and moves it to the host at once. Then quantize_params_
    streaming quantizes leaf by leaf on the host and moves each int8 leaf
    to the device on its own."""
    import torch

    from ..models import family_for
    from ..ops.quant import quantize_params_streaming
    from ..train import tree_map
    if ckpt_dir:
        params, step = _restore_params(trainer, ckpt_dir, "cpu")
        print(f"restored checkpoint step {step} (host)", flush=True)
        host = tree_map(lambda t: t.detach(), params)
        del params
    else:
        gen = torch.Generator(device=trainer.device).manual_seed(init_seed)
        host = family_for(trainer.config).init_params(
            trainer.config, gen, place=lambda t: t.cpu())
    return quantize_params_streaming(host, mode, device=trainer.device)


def _n_params(params: dict) -> int:
    """Parameter count as the JAX server reports it: every array leaf, the
    int8 weights and their scales alike."""
    from ..ops.quant import QTensor
    from ..train import tree_leaves
    return sum(x.q.numel() + x.s.numel() if isinstance(x, QTensor)
               else x.numel() for x in tree_leaves(params))


class _Batcher:
    """Continuous batching (batching.py): one background thread owns the
    cache; requests enqueue, claim a free slot, prefill, and then every
    decode step advances ALL active slots together, so a new request joins
    between steps instead of waiting for the batch to drain. The cache is
    dense (slots x max_len) or, with kv_block > 0, paged (paging.py): one
    shared block pool, admission that waits on free blocks, zero-copy
    prefix sharing and the KV handoff exports of prefill/decode
    disaggregation.

    The cache lives where the weights are. Only the scheduler thread
    touches the cache, the block allocator and the prefix trie; it runs
    under torch.no_grad() (grad mode is per thread). Sampling rows draw
    from one torch.Generator per batcher, seeded from `seed`.

    `regulator` (a regulator.Tenant: a co-tenant of a shared chip) wraps
    every device dispatch in its slice, and a waiting latency co-tenant
    drops this batcher back to single-step chunks (_tick)."""

    # kv heads of the target cache are cut over this many tp ranks
    # (_LockstepBatcher under --shard-kv); 1 = every head
    _kv_tp = 1

    def __init__(self, config, params, slots: int, max_len: int,
                 prefill_chunk: int = 0, prefix_cache: int = 0,
                 restarts: int = 3, kv_quant: bool = False,
                 kv_block: int = 0, kv_pool_blocks: int = 0,
                 decode_chunk: int = 1, seed: int | None = None,
                 draft: tuple | None = None, gamma: int = 4,
                 regulator=None):
        import collections
        import queue

        import torch

        from ..train import profiler_range
        trace.register_hot_mirror(profiler_range)

        self.config = config
        self.params = params
        self.max_len = max_len
        self.device = params["embed"].device
        self._regulator = regulator          # co-tenancy (regulator.py)
        # speculative decoding INSIDE the batch: a draft model (own slot
        # cache) proposes gamma tokens per active row each round; the
        # target verifies every row's gamma+1 positions in ONE multi-token
        # forward; acceptance and rollback are per row. The slot caches get
        # gamma+1 positions of headroom: the verify step may overshoot a
        # row's budget before its rollback.
        self._draft = draft                  # (draft_config, draft_params)
        self.gamma = int(gamma)
        if draft is not None and draft[0].vocab_size != config.vocab_size:
            raise ValueError("draft and target must share a vocab")
        self._cache_len = max_len + (self.gamma + 1 if draft else 0)
        # paged x speculative: the verify step writes gamma+1 tokens from a
        # row's frontier before its rollback, and that frontier tops out at
        # prompt+max_new-2, so admission reserves prompt+max_new+gamma
        # positions of blocks up front: no active row's verify write falls
        # through the page table to the shared scratch block, and rollback
        # stays length arithmetic over the row's own blocks
        self._spec_pad = self.gamma if draft else 0
        self.spec_rounds = 0                 # spec telemetry (healthz)
        self.spec_proposed = 0               # draft tokens proposed
        self.spec_accepted = 0               # draft tokens accepted
        self.spec_emitted = 0                # tokens emitted by spec rounds
        # > 1: when nothing is waiting to join, decode up to this many
        # steps per host sync; waiting work drops the loop back to single
        # steps so admission latency stays one step
        self.decode_chunk = max(int(decode_chunk), 1)
        seed = (seed if seed is not None
                else int.from_bytes(os.urandom(4), "big"))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.kv_quant = kv_quant
        # kv_block > 0: the PAGED cache; slots share a pool of
        # kv_pool_blocks blocks of kv_block tokens (default: full capacity,
        # which operators shrink to cap KV memory)
        self._paged = kv_block > 0
        self.kv_block = kv_block
        if self._paged:
            self._max_pages = -(-(max_len + self._spec_pad) // kv_block)
            self.kv_pool_blocks = (kv_pool_blocks
                                   or 1 + slots * self._max_pages)
        else:
            self.kv_pool_blocks = 0
        # scheduler crash budget: a transient device error fails the
        # in-flight requests, the loop rebuilds its cache and keeps
        # serving; after `restarts` crashes the batcher stays dead
        self._restarts_left = restarts
        self._prefill_cursor = 0
        # > 0: feed prompts to the model in pieces of this many tokens, one
        # piece per loop tick, interleaved with decode steps for the others
        self.prefill_chunk = prefill_chunk
        # > 0: keep the KV of the last N distinct prompts; a request whose
        # prompt extends a stored one restores that prefix's KV and
        # prefills only the suffix. LRU by prompt.
        self.prefix_cache = prefix_cache
        self._prefixes: "collections.OrderedDict" = collections.OrderedDict()
        self.prefix_hits = 0
        self.queue: "queue.Queue" = queue.Queue()
        self._rids = itertools.count()       # request ids, for the spans
        # queue-wait telemetry (submit -> slot admission): the per-request
        # value rides stats_out into the response header; the aggregates
        # feed /healthz batching.queueWait. EWMA alpha 0.2.
        self.queue_wait_count = 0
        self.queue_wait_ms_total = 0.0
        self.last_queue_wait_ms: "float | None" = None
        self.queue_wait_ewma_ms: "float | None" = None
        # KV handoff (prefill/decode disaggregation): prompt-KV exports
        # parked for a decode replica's GET /kv, purged by the scheduler
        # once taken or after the TTL, so a vanished decode peer never
        # leaks pool blocks
        self._kv_export_ttl = float(
            os.environ.get("TDAPI_KV_EXPORT_TTL_S", "30"))
        self.kv_handoffs_in = 0              # imports spliced (decode side)
        self.prefix_evictions = 0            # trie leaves dropped (pressure)
        self.slots: list = [None] * slots
        self._waiting = None      # paged: head-of-line item short on blocks
        self._sample_vec = None   # per-slot sampling vectors (cached)
        self._make_cache()
        self._stop = False
        self._dead: Exception | None = None   # loop crash / close reason
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _make_cache(self) -> None:
        """(Re)build the caches and the host state that describes them:
        init and the crash-restart path. Paged, the allocator, the prefix
        trie, the exports and the sketch are rebuilt with the pool, so they
        never disagree about which blocks are live."""
        from .. import kvaffinity
        from ..batching import PrefixTrie, init_slot_cache
        self._kv_exports: dict = {}
        self._trie = None
        if self._paged:
            from ..paging import BlockAllocator, init_paged_cache
            self.cache = init_paged_cache(
                self.config, self.kv_pool_blocks, self.kv_block,
                len(self.slots), self._max_pages, quantized=self.kv_quant,
                device=self.device, kv_tp=self._kv_tp)
            self._alloc = BlockAllocator(self.kv_pool_blocks)
            self._slot_blocks: list = [None] * len(self.slots)
            # the paged prefix store is a trie over block-sized token
            # chunks: prompts sharing a prefix share nodes and blocks
            if self.prefix_cache:
                self._trie = PrefixTrie(self.kv_block)
            # (sketch hex, occupied blocks, indexed prefixes): rebuilt by
            # the scheduler thread when the trie changes; the HTTP thread
            # reads the tuple, which is replaced whole
            self._sketch_pub = (
                kvaffinity.encode_sketch_hex([0] * kvaffinity.SKETCH_WORDS),
                0, 0)
            self._sketch_dirty = False
        else:
            self.cache = init_slot_cache(
                self.config, len(self.slots), self._cache_len,
                quantized=self.kv_quant, device=self.device,
                kv_tp=self._kv_tp)
        if self._draft is not None:
            self.d_cache = init_slot_cache(
                self._draft[0], len(self.slots), self._cache_len,
                quantized=self.kv_quant, device=self.device)

    # the cache entry points of batching.py, or their paged twins (the
    # draft always keeps a dense cache: it is the small model, and one
    # allocator per batcher keeps admission one source of truth)
    _PAGED_FNS = {"slot_prefill": "paged_prefill",
                  "slot_decode": "paged_decode",
                  "slot_decode_pick": "paged_decode_pick",
                  "slot_decode_multi": "paged_decode_multi",
                  "slot_verify": "paged_verify"}

    def _fn(self, name: str):
        """batching.<name> for the target's cache, or its paged twin."""
        from .. import batching, paging
        if self._paged:
            return getattr(paging, self._PAGED_FNS[name])
        return getattr(batching, name)

    def _release_slot(self, i: int) -> None:
        """Free a slot and (paged) return its blocks to the pool."""
        self.slots[i] = None
        self._sample_vec = None
        if self._paged and self._slot_blocks[i]:
            self._alloc.free(self._slot_blocks[i])
            self._slot_blocks[i] = None

    def _finish(self, i: int, item) -> None:
        """The stream is complete: free the slot, then wake the waiter (so
        its response's X-TDAPI-Active already counts the slot free)."""
        item["out"] = item["stream"]
        item["done_at"] = time.monotonic()
        self._release_slot(i)
        item["done"].set()

    def _extend(self, i: int, item, tokens: list) -> None:
        """Append decoded tokens to slot i's stream; finish it at max_new."""
        item["stream"].extend(tokens)
        item["last"] = item["stream"][-1]
        if len(item["stream"]) >= item["max_new"]:
            self._finish(i, item)

    def submit(self, prompt_row, max_new: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               stats_out: dict | None = None, kv_key: str = "",
               kv_import: dict | None = None) -> list[int]:
        """Blocking: returns the stream for one sequence (prompt_row [T]
        token ids), greedy at temperature 0, else per-request sampling.
        Raises if the scheduler thread has died or the batcher is closed.
        `stats_out` (a dict) receives queueWaitMs, the submit -> slot
        admission wait, firstTokenMs, submit -> the first token, and,
        past one token, tokenGapMs, the first token -> the last over the
        tokens after the first, for the response headers. Paged only:
        `kv_key` exports the prompt's KV under that key once it is
        prefilled (the prefill phase of a handoff); `kv_import`
        ({"tokens", "bufs"}, a fetched export) is spliced in instead of
        prefilling those tokens."""
        import math

        import numpy as np
        import torch

        if self._stop or self._dead is not None:
            raise RuntimeError(
                f"batcher unavailable: {self._dead or 'closed'}")
        prompt_row = torch.as_tensor(prompt_row).to(self.device, torch.long)
        if prompt_row.shape[0] == 0:
            raise ValueError("empty prompt")
        # validate the F32-ROUNDED values: the sampling vectors are float32,
        # so a subnormal f64 that rounds to 0.0f would empty the nucleus
        temperature = float(np.float32(temperature))
        top_p = float(np.float32(top_p))
        if not (math.isfinite(temperature) and temperature >= 0):
            raise ValueError("temperature must be finite and >= 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if top_k < 0:
            raise ValueError("top_k must be >= 0")
        # top_k >= vocab means "no filter": clamp to the vocab
        top_k = min(int(top_k), self.config.vocab_size)
        if prompt_row.shape[0] + max_new > self.max_len:
            raise ValueError(
                f"prompt {prompt_row.shape[0]} + max_new {max_new} exceeds "
                f"the batcher's max_len {self.max_len}")
        if self._paged:
            needed = -(-(prompt_row.shape[0] + max_new + self._spec_pad)
                       // self.kv_block)
            if needed > self.kv_pool_blocks - 1:    # block 0 is scratch
                raise ValueError(
                    f"request needs {needed} KV blocks but the pool only "
                    f"has {self.kv_pool_blocks - 1} — it could never be "
                    f"admitted")
        item = {"prompt": prompt_row, "max_new": int(max_new),
                "temperature": float(temperature), "top_k": int(top_k),
                "top_p": float(top_p), "enq_at": time.monotonic(),
                "rid": next(self._rids),
                "done": threading.Event(), "out": None, "error": None}
        if kv_key and self._paged:
            item["_kv_key"] = kv_key
        if kv_import is not None and self._paged:
            item["_kv_import"] = kv_import
        self.queue.put(item)
        # re-check AFTER the put: _fail_all may have drained the queue
        # between the check above and the put
        if ((self._stop or self._dead is not None)
                and not item["done"].is_set()):
            item["error"] = self._dead or RuntimeError("batcher closed")
            item["done"].set()
        item["done"].wait()
        if item["error"] is not None:
            raise RuntimeError(f"batcher failed: {item['error']}")
        if stats_out is not None:
            if "wait_ms" in item:
                stats_out["queueWaitMs"] = round(item["wait_ms"], 3)
            if "first_at" in item:
                stats_out["firstTokenMs"] = round(
                    (item["first_at"] - item["enq_at"]) * 1e3, 3)
                n = len(item["out"])
                if n > 1:
                    stats_out["tokenGapMs"] = round(
                        (item["done_at"] - item["first_at"]) * 1e3 / (n - 1),
                        3)
        return item["out"]

    @property
    def alive(self) -> bool:
        """Scheduler thread is running and accepting work (/healthz)."""
        return self._dead is None and not self._stop

    @property
    def queued(self) -> int:
        """Requests waiting for a slot (/healthz), the parked head of the
        line included."""
        return self.queue.qsize() + (self._waiting is not None)

    def close(self):
        self._stop = True
        self.thread.join(timeout=5)
        self._fail_all(RuntimeError("batcher closed"))

    def _fail_all(self, exc: Exception) -> None:
        """Release every waiter, in-flight slots, the parked head-of-line
        item and queued items: the scheduler is gone, and blocking forever
        is the only alternative."""
        import queue
        self._dead = self._dead or exc
        for i, s in enumerate(self.slots):
            if s is not None:
                s["error"] = exc
                self._release_slot(i)
                s["done"].set()
        if self._waiting is not None:
            self._waiting["error"] = exc
            self._waiting["done"].set()
            self._waiting = None
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                break
            item["error"] = exc
            item["done"].set()

    def _run(self):
        import torch
        while True:
            try:
                with torch.no_grad():
                    self._loop()
                return
            except Exception as e:  # noqa: BLE001 — device errors land
                # here; every waiter must be released, not left hanging
                import traceback
                traceback.print_exc()
                self._fail_all(e)
                if self._stop or self._restarts_left <= 0:
                    return
                # the crash failed every in-flight waiter, so the cache
                # holds only dead rows: rebuild it and resume
                self._restarts_left -= 1
                self._make_cache()
                self._prefixes.clear()
                if self._stop:
                    # close() ran while we rebuilt: stay closed
                    return
                self._dead = None
                print(f"batcher scheduler restarted after: {e!r} "
                      f"({self._restarts_left} restarts left)", flush=True)

    # ---- the scheduler loop (single thread owns the cache) ----

    def _next_item(self):
        """FIFO head: the parked head-of-line item (paged admission short
        on blocks) before anything newly queued. None = nothing waiting."""
        import queue
        if self._waiting is not None:
            item, self._waiting = self._waiting, None
            return item
        try:
            return self.queue.get_nowait()
        except queue.Empty:
            return None

    def _admit(self):
        """Claim free slots for queued items. Without chunking the whole
        prompt prefills here; with chunking the item parks in the slot with
        its pieces and _prefill_tick feeds them. Paged, the request's blocks
        are reserved from the shared pool first; short on blocks, the item
        waits at the head of the line (later small requests must not starve
        it)."""
        for i, s in enumerate(self.slots):
            if s is not None:
                continue
            item = self._next_item()
            if item is None:
                return
            shared_tok, donor = 0, None
            if self._paged:
                shared_tok, donor = self._paged_reserve(i, item)
                if shared_tok is None:
                    self._waiting = item     # retried when blocks free up
                    return
            # admission is the queue-wait boundary: stamped once (a parked
            # item is offered again; its wait runs on until it sticks)
            if "wait_ms" not in item:
                item["wait_ms"] = (time.monotonic() - item["enq_at"]) * 1e3
                self.queue_wait_count += 1
                self.queue_wait_ms_total += item["wait_ms"]
                self.last_queue_wait_ms = item["wait_ms"]
                prev = self.queue_wait_ewma_ms
                self.queue_wait_ewma_ms = (
                    item["wait_ms"] if prev is None
                    else 0.2 * item["wait_ms"] + 0.8 * prev)
            try:
                rem = (item["prompt"][shared_tok:] if self._paged
                       else self._restore_prefix(i, item))
                # an in-flight donor still mid-prefill has not written the
                # shared positions yet: park the suffix (even unchunked)
                # until its write frontier passes shared_tok. _written stays
                # 0 until then, so a third request sharing from THIS item
                # waits too
                awaiting = donor is not None
                if awaiting:
                    item["_await"] = (donor, shared_tok)
                else:
                    item["_written"] = shared_tok
                if self.prefill_chunk > 0 or awaiting:
                    c = self.prefill_chunk or rem.shape[0]
                    item["chunks"] = [rem[j:j + c]
                                      for j in range(0, rem.shape[0], c)]
                    if self._draft is not None:
                        # the draft sees the FULL prompt (it has no prefix
                        # store), chunked the same way
                        item["dchunks"] = [
                            item["prompt"][j:j + c]
                            for j in range(0, item["prompt"].shape[0], c)]
                    item["stream"] = None        # not decodable yet
                    self.slots[i] = item
                    self._sample_vec = None
                else:
                    self._prefill_piece(i, item, rem,
                                        first=not item.get("_restored"))
                    if self._draft is not None:
                        self._draft_prefill(i, item["prompt"], first=True)
                    self._arm_or_finish(i, item)
            except Exception as e:
                # the item is in neither the queue nor a slot: fail it
                # here, then let the crash propagate (_run releases the rest)
                item["error"] = e
                item["done"].set()
                raise

    def _paged_reserve(self, i, item):
        """Paged admission of `item` into slot i: (shared tokens, donor
        item or None), or (None, None) when the pool cannot hold it yet.
        A shared prefix's blocks enter the page table zero-copy (our
        reference is taken first, so no eviction below can free them);
        under pool pressure stored prefixes are evicted LRU, since they are
        a cache, not a reservation. Then the page table is written and a
        fetched KV export spliced in."""
        from .. import batching, paging
        shared, shared_tok, donor = self._paged_prefix_lookup(item)
        if shared:
            self._alloc.share(shared)
        total = -(-(item["prompt"].shape[0] + item["max_new"]
                    + self._spec_pad) // self.kv_block)
        blocks = self._alloc.alloc(total - len(shared))
        while blocks is None and self._evict_prefix():
            blocks = self._alloc.alloc(total - len(shared))
        if blocks is None:
            if shared:
                self._alloc.free(shared)        # release our claim
            return None, None
        if shared:
            self.prefix_hits += 1
            item["_restored"] = True
        row_blocks = shared + blocks
        self._slot_blocks[i] = row_blocks
        paging.set_pages(self.cache, i, row_blocks)
        # the decode side of a handoff: splice the prefill replica's prompt
        # KV into this slot's private blocks. A local hit is already
        # zero-copy, and wins
        imp = item.pop("_kv_import", None)
        if imp is not None and not shared_tok:
            shared_tok = self._kv_inject(i, row_blocks, imp, item)
            if shared_tok:
                item["_restored"] = True
                self.kv_handoffs_in += 1
        if shared_tok:
            batching._set_length(self.cache, i, shared_tok)
        return shared_tok, donor

    # ---- prefix cache (system-prompt KV reuse) ----

    @staticmethod
    def _prompt_key(item) -> tuple:
        """Host prompt tuple, cached on the item (one device-to-host copy
        per request)."""
        key = item.get("_key") or tuple(item["prompt"].tolist())
        item["_key"] = key
        return key

    @staticmethod
    def _usable_lcp(a: tuple, b: tuple) -> int:
        """Longest common prefix usable for KV reuse when serving prompt
        `b`, capped at len(b)-1 so the last position's logits always come
        from a real forward."""
        lcp = 0
        for x, y in zip(a, b):
            if x != y:
                break
            lcp += 1
        return min(lcp, len(b) - 1)

    def _lcp_lookup(self, item):
        """(best stored key, usable token count) for the item's prompt."""
        key = self._prompt_key(item)
        best_key, best_use = None, 0
        for pk in self._prefixes:
            usable = self._usable_lcp(pk, key)
            if usable > best_use:
                best_key, best_use = pk, usable
        return best_key, best_use

    def _restore_prefix(self, i, item):
        """Longest stored prompt prefix -> COPY its KV into the slot row;
        returns only the tokens still needing prefill."""
        prompt = item["prompt"]
        if not self.prefix_cache:
            return prompt
        from .. import batching
        best_key, best_use = self._lcp_lookup(item)
        if best_key is None or best_use < 8:     # not worth a restore
            return prompt
        entry = self._prefixes[best_key]
        self._prefixes.move_to_end(best_key)
        self.cache = batching.slot_restore_kv(self.cache, i, entry["bufs"],
                                              best_use)
        self.prefix_hits += 1
        item["_restored"] = True
        return prompt[best_use:]

    def _paged_prefix_lookup(self, item):
        """Paged: (shared block list, shared token count, donor item or
        None), the longest of two sources:

        - the prefix trie (completed prompts kept by --prefix-cache): the
          stored prefix's full blocks, capped at (len - 1) // block so the
          last position's logits come from a real forward;
        - in-flight slots: a running or mid-prefill request whose prompt
          shares a block-aligned prefix donates those blocks the same way.
          A donor still mid-prefill has not written them yet: the follower
          comes back with the donor item and waits for the donor's write
          frontier (_written). Acyclic: a follower only awaits an earlier
          admission.

        A shared block is never written again: the donor's decode writes
        start at its prompt length, past the shared full blocks, and the
        follower's prefill starts at the shared token count."""
        key = self._prompt_key(item)
        best_blocks, best_tok, best_donor = [], 0, None
        if self._trie is not None:
            blocks, _ = self._trie.lookup(key)
            n_blk = min(len(blocks), (len(key) - 1) // self.kv_block)
            if n_blk >= 1:
                best_blocks = blocks[:n_blk]
                best_tok = n_blk * self.kv_block
        for j, sj in enumerate(self.slots):
            if sj is None or self._slot_blocks[j] is None:
                continue
            usable = self._usable_lcp(self._prompt_key(sj), key)
            n_blk = min(usable // self.kv_block, len(self._slot_blocks[j]))
            if n_blk * self.kv_block > best_tok:
                best_blocks = self._slot_blocks[j][:n_blk]
                best_tok = n_blk * self.kv_block
                # no wait once the donor's writes cover the prefix
                best_donor = (sj if sj.get("_written", 0) < best_tok
                              else None)
        return best_blocks, best_tok, best_donor

    def _store_prefix(self, i, item) -> None:
        """After a full prefill, keep the prompt's KV for future requests
        sharing the prefix. Dense: a copy of the rows (LRU-bounded to
        prefix_cache entries; bucketed to 64 tokens as the JAX version
        buckets its compiled extracts). Paged: the prompt's full blocks
        join the trie zero-copy, one more reference for each level the
        trie did not hold; no count bound, evicted only under pool
        pressure."""
        if not self.prefix_cache:
            return
        from .. import batching
        key = self._prompt_key(item)
        if self._paged:
            n_store = len(key) // self.kv_block
            if n_store < 1:
                return
            new = self._trie.insert(key, self._slot_blocks[i][:n_store])
            if new:
                self._alloc.share(new)          # outlives the slot
                self._sketch_dirty = True
            return
        if key in self._prefixes:
            self._prefixes.move_to_end(key)
            return
        if len(key) < 8:
            # below the restore threshold: never restorable
            return
        # ceil-to-64 never exceeds max_len: submit() enforces
        # len + max_new <= max_len with max_new >= 1
        bucket = min(self.max_len, -(-len(key) // 64) * 64)
        self._prefixes[key] = {
            "bufs": batching.slot_extract_kv(self.cache, i, bucket)}
        while len(self._prefixes) > self.prefix_cache:
            self._prefixes.popitem(last=False)

    def _evict_prefix(self) -> bool:
        """Paged, under pool pressure: drop the trie's LRU leaf (an
        interior block backs every prefix through it, so leaves go first).
        True when something was freed."""
        freed = self._trie.evict_lru() if self._trie is not None else []
        if not freed:
            return False
        self._alloc.free(freed)
        self.prefix_evictions += 1
        self._sketch_dirty = True
        return True

    # ---- KV handoff (prefill/decode disaggregation) ----

    def _kv_export(self, i, item) -> None:
        """Prefill phase done: copy the prompt's KV to the host for a
        decode replica's GET /kv. The device gather runs here, on the
        scheduler thread, the cache's only owner; the HTTP thread serves
        the host copy. The prompt blocks also take one more reference each
        for the export: the purge (on take or after the TTL), not the
        fetching peer, frees them, so no crash between the phases leaks
        pool blocks."""
        from ..paging import paged_extract_blocks
        key = self._prompt_key(item)
        blocks = self._slot_blocks[i][:-(-len(key) // self.kv_block)]
        self._alloc.share(blocks)
        self._kv_exports[item["_kv_key"]] = {
            "tokens": key, "len": len(key), "blocks": blocks,
            "bufs": paged_extract_blocks(self.cache, blocks),
            "at": time.monotonic()}

    def _kv_inject(self, i, row_blocks, imp, item) -> int:
        """Splice a fetched export into slot i's private blocks; returns
        the tokens now resident (0: no match, prefill them instead). The
        export must be a strict prefix of the prompt, so the first logits
        come from a real forward; it may end in a partial block, whose
        rest the suffix prefill fills."""
        from ..paging import paged_inject_blocks
        key = self._prompt_key(item)
        toks = tuple(imp.get("tokens") or ())
        if not toks or len(toks) >= len(key) or key[:len(toks)] != toks:
            return 0
        n_blk = -(-len(toks) // self.kv_block)
        if n_blk > len(row_blocks):
            return 0
        try:
            self.cache = paged_inject_blocks(self.cache, row_blocks[:n_blk],
                                             imp["bufs"])
        except (KeyError, ValueError, TypeError):
            return 0                 # a malformed fetch: full prefill
        return len(toks)

    def kv_take(self, key: str):
        """HTTP thread: claim an export's host KV, once. Its blocks are
        freed on the scheduler thread (_purge_kv_exports): the allocator
        has one owner."""
        if not key:
            return None
        e = self._kv_exports.get(key)
        if e is None or e.get("taken"):
            return None
        e["taken"] = True
        return e

    def _purge_kv_exports(self) -> None:
        """Scheduler tick: free the blocks of taken and expired exports."""
        if not self._kv_exports:
            return
        now = time.monotonic()
        for k, e in list(self._kv_exports.items()):
            if e.get("taken") or now - e["at"] > self._kv_export_ttl:
                self._kv_exports.pop(k, None)
                self._alloc.free(e["blocks"])

    def _refresh_sketch(self) -> None:
        """Rebuild the advertised prefix sketch from the trie (scheduler
        thread; the HTTP thread reads the published tuple). Hashing a
        leaf's path covers its ancestor levels, so leaves suffice."""
        from .. import kvaffinity
        hashes: list = []
        for prefix in self._trie.iter_leaf_prefixes():
            hashes.extend(kvaffinity.chunk_hashes(prefix))
        self._sketch_pub = (
            kvaffinity.encode_sketch_hex(kvaffinity.build_sketch(hashes)),
            len(self._trie), self._trie.leaf_count)
        self._sketch_dirty = False

    def _prefill_piece(self, i, item, piece, first: bool):
        with trace.hot("serve.prefill_piece", rid=item["rid"],
                       tokens=int(piece.shape[0])):
            logits, self.cache = self._fn("slot_prefill")(
                self.params, piece[None], self.cache, i, self.config,
                append=not first)
        item["_last_logits"] = logits
        # the write frontier: how many of the prompt's tokens are in the
        # cache (a paged follower waits on its donor's)
        item["_written"] = item.get("_written", 0) + int(piece.shape[0])

    def _draft_prefill(self, i, piece, first: bool):
        """Feed a prompt piece into the DRAFT's slot cache (both caches hold
        y_1..y_{m-1} between rounds); its logits are unused."""
        from .. import batching
        dcfg, dparams = self._draft
        _, self.d_cache = batching.slot_prefill(
            dparams, piece[None], self.d_cache, i, dcfg, append=not first)

    def _sample_vectors(self):
        """Per-slot (temperatures, top_ks, top_ps) on the device for the
        shared decode step (idle/greedy rows: temperature 0 = argmax).
        Cached: they change only on admit/release."""
        if self._sample_vec is None:
            import torch

            from ..batching import to_device
            temps, tks, tps = [], [], []
            for s in self.slots:
                temps.append(s["temperature"] if s else 0.0)
                tks.append(s["top_k"] if s else 0)
                tps.append(s["top_p"] if s else 1.0)
            self._sample_vec = (to_device(temps, torch.float32, self.device),
                                to_device(tks, torch.long, self.device),
                                to_device(tps, torch.float32, self.device))
        return self._sample_vec

    def _sampling(self) -> bool:
        """A sampling row is DECODING (a sampler still mid-prefill must not
        tax the greedy rows with the rowwise filter)."""
        return any(s is not None and s.get("stream") is not None
                   and s["temperature"] > 0 for s in self.slots)

    def _arm_or_finish(self, i, item):
        """Prefill complete: the first token comes off the last piece's
        logits; one-token requests answer at once."""
        with trace.hot("serve.first_token", rid=item["rid"]):
            self._first_token(i, item)

    def _first_token(self, i, item):
        self._store_prefix(i, item)   # the row holds the full prompt's KV
        if item.get("_kv_key"):
            self._kv_export(i, item)  # the handoff's prefill phase
        logits = item.pop("_last_logits")
        if item["temperature"] == 0.0:
            tok = int(logits[0].argmax())
        else:
            import torch

            from ..batching import rowwise_pick, to_device
            tok = int(rowwise_pick(
                logits, to_device([item["temperature"]], torch.float32,
                                   self.device),
                to_device([item["top_k"]], torch.long, self.device),
                to_device([item["top_p"]], torch.float32, self.device),
                self._gen)[0])
        item["stream"] = [tok]
        item["last"] = tok
        item["first_at"] = time.monotonic()
        if item["max_new"] <= 1:
            self._finish(i, item)
        else:
            self.slots[i] = item
            self._sample_vec = None

    def _prefill_tick(self) -> bool:
        """Feed ONE pending prompt piece (chunked mode). True if fed. Scans
        round-robin from a rotating cursor so a chunked prefill in a high
        slot is not starved by new admissions in lower slots."""
        n = len(self.slots)
        for off in range(n):
            i = (self._prefill_cursor + off) % n
            s = self.slots[i]
            if s is None or not (s.get("chunks") or s.get("dchunks")):
                continue
            if "_await" in s:
                # a paged follower whose donor has not written the shared
                # positions yet: skip it this tick. The donor's own prefill
                # moves every tick, and a released donor (its prefill done)
                # passes, since the item outlives its slot
                d_item, need = s["_await"]
                if d_item.get("_written", 0) < need:
                    continue
                del s["_await"]
                s["_written"] = need
            self._prefill_cursor = (i + 1) % n
            if s.get("chunks"):
                piece = s["chunks"].pop(0)
                # a prefix-restored item APPENDS from its first piece
                self._prefill_piece(i, s, piece,
                                    first=("_last_logits" not in s
                                           and not s.get("_restored")))
            if s.get("dchunks"):
                dpiece = s["dchunks"].pop(0)
                self._draft_prefill(i, dpiece,
                                    first=not s.get("_d_started"))
                s["_d_started"] = True
            if not s.get("chunks") and not s.get("dchunks"):
                s.pop("chunks", None)
                s.pop("dchunks", None)
                s.pop("_d_started", None)
                self._arm_or_finish(i, s)
            return True
        return False

    def _spec_round(self, active: list, toks) -> None:
        """One speculative round over the whole slot batch: the draft
        proposes gamma per active row, the target verifies all rows in one
        multi-token forward, per-row accept and cache rollback, 1..gamma+1
        tokens emitted per row. One host sync per round."""
        import torch

        from .. import batching
        dcfg, dparams = self._draft
        g = self.gamma
        sample = ((*self._sample_vectors(), self._gen) if self._sampling()
                  else None)
        drafts, dlogp, self.d_cache = batching.slot_spec_draft(
            dparams, toks, self.d_cache, active, dcfg, g, sample)
        blocks = torch.cat([toks[:, None], drafts], dim=1)
        tlogits, self.cache = self._fn("slot_verify")(
            self.params, blocks, self.cache, active, self.config)
        if sample is not None:
            a, emit = batching.rowwise_spec_accept(tlogits, drafts, dlogp,
                                                   *sample)
        else:
            a, emit = batching.spec_accept_greedy(tlogits, drafts)
        got = torch.cat([a[:, None], emit], dim=1).tolist()  # ONE host sync
        a_host = [row[0] for row in got]
        # all-gamma-accepted rows miss the draft's entry for the last
        # proposal (the draft never forwarded it): one draft step for
        # exactly those rows fills it before the rollback
        fill = [bool(active[i]) and a_host[i] == g
                for i in range(len(self.slots))]
        if any(fill):
            _, self.d_cache = batching.slot_decode(
                dparams, drafts[:, -1], self.d_cache, fill, dcfg)
        # roll both caches back to exactly the accepted entries: the target
        # wrote gamma+1 (keeps 1+a), the draft gamma (+1 for filled rows)
        for cache, back in (
                (self.cache, [g - x for x in a_host]),
                (self.d_cache, [0 if x == g else g - 1 - x for x in a_host])):
            batching.set_lengths(cache, [
                n - b if act else n for n, b, act
                in zip(cache["host_lengths"], back, active)])
        self.spec_rounds += 1
        with trace.hot("serve.emit"):
            for i, s in enumerate(self.slots):
                if not active[i]:
                    continue
                take = min(1 + a_host[i], s["max_new"] - len(s["stream"]))
                self.spec_proposed += g
                self.spec_accepted += a_host[i]
                self.spec_emitted += take
                self._extend(i, s, got[i][1:1 + take])

    def _has_waiters(self) -> bool:
        """Work is waiting to join (defers chunked decode so admission
        latency stays one step). The lock-step subclass reads its
        broadcast pending list instead: queue timing would desync the
        ranks."""
        return self._waiting is not None or not self.queue.empty()

    def _sync(self) -> int:
        """Per-tick prologue: 0 = leave the loop. The lock-step subclass
        overrides it with the cross-rank admission broadcast (one hook:
        the tick loop itself is shared)."""
        return 0 if self._stop else 1

    def _loop(self):
        while True:
            if self._sync() == 0:
                return
            if not self._tick():
                with trace.hot("serve.sleep"):
                    time.sleep(0.002)

    def _chip_slice(self, tokens: int = 0):
        """Admission for one device chunk: the co-tenancy regulator's
        slice when this batcher shares its chip, else free."""
        if self._regulator is None:
            return contextlib.nullcontext()
        return self._regulator.slice(tokens=tokens)

    def _tick(self) -> bool:
        """One scheduler tick: admit, feed one prefill piece, one decode
        step (or spec round, or decode chunk) for the active rows. False
        when there was nothing to do (the loop sleeps).

        Every device dispatch runs inside a _chip_slice: on a shared chip
        the regulator admits chunks by share weight, and a waiting
        latency-class co-tenant both preempts at the chunk boundary and
        (should_yield) drops this batcher to single-step chunks, so the
        next boundary is one step away."""
        with trace.hot("serve.tick"):
            return self._tick_inner()

    def _tick_inner(self) -> bool:
        import torch

        from .. import batching
        if self._paged:
            self._purge_kv_exports()
        with self._chip_slice():
            with trace.hot("serve.admit"):
                self._admit()
            fed = self._prefill_tick()      # one prompt piece per tick
        if self._trie is not None and self._sketch_dirty:
            self._refresh_sketch()
        # decodable = prefill finished (mid-prefill slots sit out the step:
        # their lengths must not advance)
        active = [s is not None and s.get("stream") is not None
                  for s in self.slots]
        if not any(active):
            return fed
        n_active = sum(active)
        toks = batching.to_device(
            [s["last"] if active[i] else 0 for i, s in enumerate(self.slots)],
            torch.long, self.device)
        rids = [s["rid"] for s, a in zip(self.slots, active) if a]
        if self._draft is not None:
            with self._chip_slice(tokens=n_active * (self.gamma + 1)), \
                    trace.hot("serve.decode_step", rows=n_active, ids=rids):
                self._spec_round(active, toks)
            return True
        # chunked decode only when nothing is waiting to join and no prefill
        # is mid-flight; otherwise single steps keep admission latency at
        # one step. The chunk size stays fixed: stream tails run masked
        # steps (their rows stop advancing at their budget). A contended
        # shared chip also forces single steps: the latency co-tenant's
        # stall bound shrinks from one chunk to one step
        chunk = self.decode_chunk
        contended = (self._regulator is not None
                     and self._regulator.should_yield())
        idle = (chunk > 1 and not fed and not self._has_waiters()
                and not contended)
        # greedy fast path: no sampling row decoding -> pure argmax
        sample = ((*self._sample_vectors(), self._gen) if self._sampling()
                  else None)
        if idle:
            remaining = [s["max_new"] - len(s["stream"]) if active[i] else 0
                         for i, s in enumerate(self.slots)]
            with self._chip_slice(tokens=n_active * chunk), \
                    trace.hot("serve.decode_step", rows=n_active, ids=rids):
                steps, self.cache = self._fn("slot_decode_multi")(
                    self.params, toks, self.cache, active, remaining,
                    self.config, chunk, sample=sample)
                steps = steps.t().tolist()          # [slots, chunk]
            with trace.hot("serve.emit"):
                for i, s in enumerate(self.slots):
                    if active[i]:
                        self._extend(i, s, steps[i][:remaining[i]])
            return True
        with self._chip_slice(tokens=n_active), \
                trace.hot("serve.decode_step", rows=n_active, ids=rids):
            if sample is not None:
                picked, self.cache = self._fn("slot_decode_pick")(
                    self.params, toks, self.cache, active, *sample,
                    self.config)
            else:
                logits, self.cache = self._fn("slot_decode")(
                    self.params, toks, self.cache, active, self.config)
                picked = logits.argmax(dim=-1)
            nxt = picked.tolist()
        with trace.hot("serve.emit"):
            for i, s in enumerate(self.slots):
                if active[i]:
                    self._extend(i, s, nxt[i:i + 1])
        return True


class _LockstepBatcher(_Batcher):
    """Continuous batching over ranks (multi-host serving): every rank
    runs the same scheduler on its shards of the weights; rank 0 alone
    has HTTP arrivals, and each tick begins with one broadcast of the
    requests newly admitted to the pending list (prompt tokens, budget,
    sampling parameters), after which every rank's scheduler state moves
    deterministically, so all ranks run the same slot ops in the same
    order with the same collectives inside them.

    What a tick's decisions read: the pending list (broadcast), slot
    occupancy and stream lengths (from the pending list and the tokens,
    equal on every rank), the sampling generator (seeded from one
    broadcast seed and drawn in the same order) and the chunk sizes (the
    same flags). queue.empty(), the one timing-dependent input of the base
    loop, is replaced by the pending list (_has_waiters). The paged
    allocator, the prefix store and in-flight sharing are host bookkeeping
    driven by the same inputs, so they stay in step; the speculative
    draft runs on the same plan. The prompt-KV handoff is not carried on
    the wire, so submit() serves a request that asks to export or import
    one in full.

    The caches: by default every rank holds the whole cache (its new K/V
    gathered over tp, infer._kv_for_cache); with shard_kv the target's
    K/V and kv8 scales are cut over tp on the kv-head dim
    (batching.kv_shard_specs), the lengths and page tables whole; the
    draft's cache is whole.

    restarts=0: a crash on one rank cannot be restarted in lock-step (its
    peers wait in a collective nobody will complete): every waiter fails,
    and a crashed rank 0 broadcasts the stop op first."""

    # at most this many admissions are broadcast a tick (the rest stay in
    # rank 0's queue for later ticks)
    BCAST_K = 4

    def __init__(self, config, params, slots: int, max_len: int, world,
                 rank: int, shard_kv: bool = False, **kw):
        """params: infer.RankParams. world: the AxisGroup the wire goes
        over (every rank); rank: this rank's index in it. kw: the
        _Batcher composition knobs (prefill_chunk, decode_chunk, seed,
        kv_quant, kv_block, kv_pool_blocks, prefix_cache, draft, gamma)."""
        self._world = world
        self._rank = rank
        self._shard_kv = shard_kv
        self._pending: list = []
        tp = params.groups.tp
        if shard_kv and tp is not None:
            self._kv_tp = tp.size
        super().__init__(config, params, slots, max_len, restarts=0, **kw)

    def submit(self, prompt_row, max_new: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               stats_out: dict | None = None, kv_key: str = "",
               kv_import: dict | None = None) -> list[int]:
        """_Batcher.submit without the handoff (the wire does not carry
        it: an export or import on rank 0 alone would move its allocator
        apart from the other ranks')."""
        return super().submit(prompt_row, max_new, temperature, top_k,
                              top_p, stats_out)

    def _has_waiters(self) -> bool:
        return self._waiting is not None or bool(self._pending)

    @property
    def queued(self) -> int:
        return (self.queue.qsize() + len(self._pending)
                + (self._waiting is not None))

    def _next_item(self):
        """The parked head-of-line item first, as in the base (its parking
        was itself in lock-step), then the pending list."""
        if self._waiting is not None:
            item, self._waiting = self._waiting, None
            return item
        return self._pending.pop(0) if self._pending else None

    def _fail_all(self, exc: Exception) -> None:
        super()._fail_all(exc)
        for it in self._pending:        # rank 0: real waiters live here
            it["error"] = exc
            it["done"].set()
        self._pending.clear()

    def _sync(self) -> int:
        """The per-tick broadcast: rank 0 encodes the tick's newly pending
        requests (or the stop op) as ints[2+3K] (op, count, then length,
        max_new, top_k each), floats[2K] (temperature, top_p each) and
        prompts[K, max_len]; every rank decodes the same payload into its
        pending list. Fixed shapes, one collective.

        Three invariants:
        - drained requests enter _pending before the broadcast, so a
          failed broadcast reaching _fail_all still releases their
          waiters;
        - rank 0 adopts the f32 wire values of each request's sampling
          parameters, so every rank gates on the same rounded values (a
          temperature that rounds to f32 0.0 takes the greedy program on
          every rank, or the generators' draws fall out of step);
        - the drain is capped at free slots + 1, not a flat BCAST_K, so
          an overload backs up in rank 0's queue, not in every rank's
          pending list."""
        import queue as _queue

        import torch

        from ..parallel import comm
        k, t = self.BCAST_K, self.max_len
        ints = torch.zeros(2 + 3 * k, dtype=torch.int32)
        floats = torch.zeros(2 * k, dtype=torch.float32)
        prompts = torch.zeros((k, t), dtype=torch.int32)
        items: list = []
        if self._rank == 0:
            if not self._stop:
                ints[0] = 1
                free = sum(s is None for s in self.slots)
                budget = min(k, max(0, free + 1 - len(self._pending)))
                while len(items) < budget:
                    try:
                        items.append(self.queue.get_nowait())
                    except _queue.Empty:
                        break
                self._pending.extend(items)
                ints[1] = len(items)
                for j, it in enumerate(items):
                    p = it["prompt"].cpu()
                    ints[2 + 3 * j:5 + 3 * j] = torch.tensor(
                        [p.shape[0], it["max_new"], it["top_k"]])
                    floats[2 * j:2 * j + 2] = torch.tensor(
                        [it["temperature"], it["top_p"]])
                    prompts[j, :p.shape[0]] = p
        ints, floats, prompts = comm.broadcast_one_to_all(
            (ints, floats, prompts), self._world)
        ints, floats = ints.tolist(), floats.tolist()
        if ints[0] == 0:
            return 0
        if self._rank == 0:
            for j, it in enumerate(items):      # adopt the f32 wire values
                it["temperature"] = floats[2 * j]
                it["top_p"] = floats[2 * j + 1]
        else:
            for j in range(ints[1]):
                plen, mx, tk = ints[2 + 3 * j:5 + 3 * j]
                self._pending.append({
                    "prompt": prompts[j, :plen].to(self.device, torch.long),
                    "max_new": mx, "temperature": floats[2 * j],
                    "top_k": tk, "top_p": floats[2 * j + 1],
                    "enq_at": time.monotonic(), "rid": next(self._rids),
                    "done": threading.Event(), "out": None, "error": None})
        return 1

    def _run(self):
        """Crash liveness: a rank-0 crash still broadcasts the stop op, or
        every follower would wait in a broadcast nobody sources; a
        follower crash ends its process, which fails the peers' next
        collective and lands them here too. Either way every process
        leaves, and a supervisor sees it."""
        import torch
        try:
            with torch.no_grad():
                self._loop()
        except Exception as e:  # noqa: BLE001 — device or collective
            import traceback
            traceback.print_exc()
            self._fail_all(e)
            self._stop = True
            if self._rank == 0:
                try:
                    self._sync()          # the stop op, best effort
                except Exception:  # noqa: BLE001 — peers may be gone
                    pass


class _Server:
    def __init__(self, config, params, kv_quant: bool = False,
                 draft: tuple = None, gamma: int = 4):
        self.config = config
        self.params = params
        self.kv_quant = kv_quant
        self.draft = draft             # (draft_config, draft_params) | None
        self.gamma = gamma
        self.device = params["embed"].device   # serve where the weights are
        self.batcher: _Batcher | None = None
        self.lock = threading.Lock()   # single-flight: one card
        self.n_params = _n_params(params)

    def generate(self, tokens, max_new: int, temperature: float,
                 top_k: int = 0, top_p: float = 1.0,
                 stats_out: dict | None = None, kv_key: str = "",
                 kv_import: dict | None = None):
        import torch

        from ..infer import generate, speculative_generate
        try:
            prompt = torch.tensor(tokens, dtype=torch.long)
        except (OverflowError, RuntimeError) as e:   # ints past int64
            raise ValueError(f"token id out of range ({e})") from e
        if prompt.ndim != 2 or prompt.numel() == 0:
            raise ValueError("tokens must be [batch, prompt_len]")
        if int(prompt.max()) >= self.config.vocab_size or int(prompt.min()) < 0:
            raise ValueError("token id out of range")
        # continuous batching: single-sequence requests (greedy or
        # sampling) join the running slot batch without the single-flight
        # lock; the batcher thread owns the cache
        if self.batcher is not None:
            if prompt.shape[0] == 1:
                return [self.batcher.submit(
                    prompt[0], int(max_new), temperature=float(temperature),
                    top_k=int(top_k), top_p=float(top_p),
                    stats_out=stats_out, kv_key=kv_key,
                    kv_import=kv_import)]
            # a multi-row request would run generate() beside the batcher's
            # slot decode: two caches live at once on the card
            raise ValueError(
                "server runs in continuous-batching mode: send "
                "single-sequence requests (one row; greedy or sampling), "
                "or start without --batch-slots for multi-row batches")
        with self.lock:
            prompt = prompt.to(self.device)
            gen = torch.Generator(device=self.device).manual_seed(
                int.from_bytes(os.urandom(4), "big"))
            # speculative path: one sequence + a draft loaded. Greedy is
            # exactly the target-only greedy stream; sampling is exact via
            # rejection sampling
            if self.draft is not None and prompt.shape[0] == 1:
                dcfg, dparams = self.draft
                out, _ = speculative_generate(
                    self.params, dparams, prompt, self.config, dcfg,
                    int(max_new), gamma=self.gamma, kv_quant=self.kv_quant,
                    temperature=float(temperature), top_k=int(top_k),
                    top_p=float(top_p), generator=gen)
            else:
                out = generate(self.params, prompt, self.config, int(max_new),
                               temperature=float(temperature),
                               top_k=int(top_k), top_p=float(top_p),
                               kv_quant=self.kv_quant, generator=gen)
            return out.cpu().tolist()


def _ms(value):
    """A queue-wait reading as /healthz reports it (3 decimals, or None)."""
    return round(value, 3) if value is not None else None


def _batching_health(b: _Batcher) -> dict:
    """/healthz's `batching` block: the prefix trie's (paged with
    --prefix-cache), the speculative rounds' and the pool's blocks when
    they apply."""
    out = {
        "slots": len(b.slots),
        "active": sum(s is not None for s in b.slots),
        "queued": b.queued,
        "maxLen": b.max_len,
        "alive": b.alive,
        "prefixHits": b.prefix_hits,
        "queueWait": {
            "count": b.queue_wait_count,
            "totalMs": round(b.queue_wait_ms_total, 3),
            "lastMs": _ms(b.last_queue_wait_ms),
            "ewmaMs": _ms(b.queue_wait_ewma_ms),
        },
    }
    if b._trie is not None:
        sketch_hex, occ, entries = b._sketch_pub
        out["prefixCache"] = {
            "entries": entries,
            "blocks": occ,
            "evictions": b.prefix_evictions,
            "kvExports": len(b._kv_exports),
            "handoffsIn": b.kv_handoffs_in,
            "sketch": sketch_hex,
        }
    if b._draft is not None:
        out["speculative"] = {
            "gamma": b.gamma,
            "rounds": b.spec_rounds,
            "proposed": b.spec_proposed,
            "accepted": b.spec_accepted,
            "emitted": b.spec_emitted,
            # fraction of PROPOSED draft tokens accepted (a round proposes
            # gamma per ACTIVE row)
            "acceptRate": round(b.spec_accepted / max(b.spec_proposed, 1), 3),
        }
    if b._paged:
        out["paged"] = {
            "blockSize": b.kv_block,
            "poolBlocks": b.kv_pool_blocks,
            "freeBlocks": b._alloc.free_blocks,
        }
    return out


def _fetch_kv(source: str, key: str) -> "dict | None":
    """The decode side of the handoff: the prompt KV a prefill replica
    exported (GET /kv on `source` = "host:port"), as {"tokens", "bufs":
    {name: numpy array}}. ANY failure (peer gone, export expired or taken,
    a malformed payload) returns None, and the request prefills in full:
    the handoff is a fast path, never a correctness dependency."""
    import base64
    from http.client import HTTPConnection, HTTPException

    import numpy as np
    try:
        host, _, port = source.rpartition(":")
        conn = HTTPConnection(host or "127.0.0.1", int(port), timeout=5)
        try:
            conn.request("GET", "/kv?key=" + key)
            payload = json.loads(conn.getresponse().read() or b"{}")
        finally:
            conn.close()
        data = payload.get("data") or {}
        if payload.get("code") != 200 or not data.get("tokens"):
            return None
        bufs = {
            name: np.frombuffer(
                base64.b64decode(d["b64"]),
                dtype=np.dtype(d["dtype"])).reshape(d["shape"])
            for name, d in (data.get("bufs") or {}).items()}
        return {"tokens": data["tokens"], "bufs": bufs}
    except (OSError, HTTPException, ValueError, KeyError, TypeError,
            AttributeError):
        # the peer is gone or sent what is not an export
        return None


def _handler_for(srv: _Server, model_name: str, admit_queue: int = 0):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # keep-alive envelope responses flush headers and body as two
        # segments; a fronting gateway pays Nagle + delayed-ACK per
        # request without this
        disable_nagle_algorithm = True

        def log_message(self, *a):
            pass

        def _send(self, code: int, msg: str, data,
                  extra: "dict | None" = None):
            payload = json.dumps(
                {"code": code, "msg": msg, "data": data}).encode()
            self.send_response(200)     # control-plane envelope style
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            # W3C trace continuity: echo the caller's traceparent
            tp = self.headers.get("traceparent")
            if tp:
                self.send_header("traceparent", tp)
            # replica-side admission surface: a fronting gateway reads the
            # batcher's slot / queue state off EVERY response
            b = srv.batcher
            if b is not None:
                self.send_header("X-TDAPI-Slots", str(len(b.slots)))
                self.send_header("X-TDAPI-Active",
                                 str(sum(s is not None for s in b.slots)))
                self.send_header("X-TDAPI-Queued", str(b.queued))
                if b.queue_wait_ewma_ms is not None:
                    self.send_header("X-TDAPI-Queue-Wait-EWMA-Ms",
                                     str(round(b.queue_wait_ewma_ms, 3)))
                # KV affinity: the prefix sketch and occupancy on every
                # response, folded into a fronting router's state
                if b._trie is not None:
                    sketch_hex, occ, _ = b._sketch_pub
                    self.send_header("X-TDAPI-KV-Sketch", sketch_hex)
                    self.send_header("X-TDAPI-KV-Occ", str(occ))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/healthz":
                data = {
                    "model": model_name,
                    "params": srv.n_params,
                    "vocab": srv.config.vocab_size,
                    "maxSeqLen": srv.config.max_seq_len,
                }
                if srv.batcher is not None:
                    data["batching"] = _batching_health(srv.batcher)
                self._send(200, "Success", data)
            elif self.path.startswith("/kv?") or self.path == "/kv":
                self._send_kv()
            elif self.path == "/launches":
                from ..ops import attention
                self._send(200, "Success", dict(attention.LAUNCHES))
            else:
                self._send(404, "route not found", None)

        def _send_kv(self):
            """GET /kv?key=: a prompt-KV export of the paged batcher, once
            (the scheduler frees it on take or after its TTL)."""
            import base64
            from urllib.parse import parse_qs, urlparse
            b = srv.batcher
            key = (parse_qs(urlparse(self.path).query).get("key") or [""])[0]
            e = b.kv_take(key) if b is not None and b._paged else None
            if e is None:
                self._send(404, "kv export not found", None)
                return
            bufs = {name: {"dtype": arr.dtype.name, "shape": list(arr.shape),
                           "b64": base64.b64encode(arr.tobytes()).decode()}
                    for name, arr in e["bufs"].items()}
            self._send(200, "Success", {"tokens": list(e["tokens"]),
                                        "len": e["len"], "bufs": bufs})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, "route not found", None)
                return
            # --admit-queue: shed BEFORE submitting once the batcher's wait
            # line is at the bound; the 429 (+ X-TDAPI-Shed) tells a
            # fronting gateway to route elsewhere
            b = srv.batcher
            if (admit_queue > 0 and b is not None
                    and b.queued >= admit_queue):
                self._send(429, "replica queue full", None,
                           extra={"Retry-After": "1", "X-TDAPI-Shed": "1"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                tokens = body["tokens"]
                max_new = int(body.get("max_new", 16))
                temperature = float(body.get("temperature", 0.0))
                top_k = int(body.get("top_k", 0))
                top_p = float(body.get("top_p", 1.0))
                if max_new < 1:
                    raise ValueError("max_new must be >= 1")
                if not 0.0 < top_p <= 1.0:
                    raise ValueError("top_p must be in (0, 1]")
                if top_k < 0:
                    raise ValueError("top_k must be >= 0")
                if not 0.0 <= temperature <= 10.0:
                    raise ValueError("temperature must be in [0, 10]")
                # the JAX server's buckets for the sampling parameters
                # without a batcher (there they bound its compiled
                # programs): 201 temperatures x 20 top_p x 129 top_k. The
                # batcher takes them as data and serves what was asked.
                if srv.batcher is None:
                    temperature = round(temperature * 20) / 20
                    top_p = round(top_p * 20) / 20 or 0.05
                    top_k = min(top_k, 128)
                # the handoff (paged batcher only): X-TDAPI-Phase: prefill
                # with X-TDAPI-KV-Key runs the prefill alone (one token) and
                # exports the prompt KV under the key; X-TDAPI-KV-Source
                # with the key fetches that export and resumes without
                # prefilling it. A failed fetch is a plain full request
                hdr_key = self.headers.get("X-TDAPI-KV-Key") or ""
                kv_src = self.headers.get("X-TDAPI-KV-Source") or ""
                phase = self.headers.get("X-TDAPI-Phase") or ""
                handoff = {}
                if hdr_key and b is not None and b._paged:
                    if phase == "prefill":
                        handoff["kv_key"], max_new = hdr_key, 1
                    elif kv_src:
                        handoff["kv_import"] = _fetch_kv(kv_src, hdr_key)
                stats: dict = {}
                out = srv.generate(tokens, max_new, temperature,
                                   top_k=top_k, top_p=top_p,
                                   stats_out=stats, **handoff)
                extra = None
                if "queueWaitMs" in stats:
                    # per-request batcher queue wait, stitched into a
                    # fronting worker's trace
                    extra = {"X-TDAPI-Queue-Wait-Ms":
                             str(stats["queueWaitMs"])}
                for key, header in (("firstTokenMs", "First-Token-Ms"),
                                    ("tokenGapMs", "Token-Gap-Ms")):
                    if key in stats:
                        extra = extra or {}
                        extra["X-TDAPI-" + header] = str(stats[key])
                self._send(200, "Success", {"tokens": out}, extra=extra)
            except (KeyError, TypeError, ValueError) as e:
                self._send(400, f"bad request: {e}", None)

    return Handler


class _MultihostServer:
    """Rank 0's facade for the HTTP handler in single-flight multi-host
    mode: generate queues the request for the lock-step engine loop and
    waits for its result (single-flight follows from the one consumer)."""

    def __init__(self, config, n_params: int, work_q, kv_quant: bool,
                 b_max: int, t_max: int):
        self.config = config
        self.n_params = n_params
        self.kv_quant = kv_quant
        self.batcher = None
        self.draft = None
        self._q = work_q
        self.b_max = b_max
        self.t_max = t_max

    def generate(self, tokens, max_new: int, temperature: float,
                 top_k: int = 0, top_p: float = 1.0,
                 stats_out: dict | None = None):
        import torch
        try:
            prompt = torch.tensor(tokens, dtype=torch.long)
        except (OverflowError, RuntimeError) as e:   # ints past int64
            raise ValueError(f"token id out of range ({e})") from e
        if prompt.ndim != 2 or prompt.numel() == 0:
            raise ValueError("tokens must be [batch, prompt_len]")
        # the request limits reject here (a 400): an invalid item must
        # never reach the engine loop, where a rank-0 failure before the
        # broadcast would strand the other ranks
        if prompt.shape[0] > self.b_max or prompt.shape[1] >= self.t_max:
            raise ValueError(f"batch <= {self.b_max} and prompt < "
                             f"{self.t_max} in multihost mode")
        if prompt.shape[1] + int(max_new) > self.t_max:
            raise ValueError(
                f"prompt + max_new exceeds the model's max_seq_len "
                f"({self.t_max})")
        if int(prompt.max()) >= self.config.vocab_size or int(prompt.min()) < 0:
            raise ValueError("token id out of range")
        item = {"prompt": prompt, "max_new": int(max_new),
                "temperature": float(temperature), "top_k": int(top_k),
                "top_p": float(top_p),
                "done": threading.Event(), "out": None, "error": None}
        self._q.put(item)
        item["done"].wait()
        if item["error"] is not None:
            raise RuntimeError(f"multihost engine failed: {item['error']}")
        return item["out"]


# single-flight rank 0 broadcasts an idle no-op round after this long
# without a request, so a follower never waits in a broadcast near the
# group's timeout, and a rank 0 that dies without its stop op (killed, or
# its host lost) ends the followers within that timeout
SERVE_IDLE_S = 5.0


def _serve_multihost(args, config, spec) -> int:
    """Lock-step serving over the multi-worker contract `spec`
    (distributed.cluster_spec_from_env): each worker runs its ranks
    (distributed.cluster_layout: its cards, or on the CPU the devices
    over the workers: --tp, at least one a worker) of JAX's serving plan
    (infer.serving_plan: tp as asked or best_tp_for, fsdp the rest) over
    one group formed at the coordinator (NCCL on cuda, gloo on the CPU);
    _serve_rank on each. The checks that need only the flags and configs
    run before the group forms. A group that does not form raises: there
    is no single-host fallback."""
    from .. import distributed
    from ..infer import serving_plan
    n_dev = (None if args.device == "cuda"
             else max(args.tp or 1, spec["num_processes"]))
    cluster = distributed.cluster_layout(spec, args.device, n_dev)
    plan = serving_plan(cluster.world, args.tp)
    draft_cfg = _multihost_checks(args, config, plan.tp)
    distributed.run_cluster(
        _serve_rank, (args, config, draft_cfg, plan, cluster), cluster,
        distributed.backend_for(args.device))
    return 0


def _multihost_checks(args, config, tp: int):
    """The head-count checks of multi-host batching (JAX's messages):
    --shard-kv needs the kv heads to divide over tp, a draft its heads and
    the target's vocab. -> the draft's config or None."""
    if not args.batch_slots:
        return None
    if args.shard_kv:
        n_kv = getattr(config, "n_kv_heads", 0) or config.n_heads
        if n_kv % tp:
            raise SystemExit(f"--shard-kv needs n_kv_heads ({n_kv}) "
                             f"divisible by tp ({tp})")
    if not args.draft_config:
        return None
    from ..models import named_config
    dcfg = named_config(args.family, args.draft_config)
    if dcfg.vocab_size != config.vocab_size:
        raise SystemExit("draft and target must share a vocab")
    d_kv = getattr(dcfg, "n_kv_heads", 0) or dcfg.n_heads
    if dcfg.n_heads % tp or d_kv % tp:
        raise SystemExit(
            f"--draft-config {args.draft_config!r} needs n_heads "
            f"({dcfg.n_heads}) and n_kv_heads ({d_kv}) divisible "
            f"by the target's tp ({tp}); pick a draft config "
            f"with compatible head counts or lower --tp")
    return dcfg


def rank_params(config, plan, groups, device, ckpt_dir: str = "",
                init_seed: int = 0):
    """This rank's served weights (infer.RankParams) under `plan`: its
    shards of a fresh Trainer init (init_seed; every rank draws the whole
    init and keeps its shard) or of the newest checkpoint under ckpt_dir
    (restored whole on the host, ungrouped if need be, then cut)."""
    from ..infer import RankParams
    from ..train import Trainer
    trainer = Trainer.create(config, plan, device=device, groups=groups)
    if not ckpt_dir:
        return RankParams(trainer.init_params(init_seed), groups), None
    params, step = _restore_params(trainer, ckpt_dir, "cpu")
    return RankParams(trainer._shard_tree(params), groups), step


def _whole_params(config) -> int:
    """The whole model's parameter count (what /healthz reports)."""
    import math

    from ..models import param_shapes
    from ..train import tree_leaves
    return sum(math.prod(shape)
               for shape, _ in tree_leaves(param_shapes(config)))


def _serve_rank(rank: int, world: int, args, config, draft_cfg, plan,
                cluster) -> None:
    """One rank of multi-host serving: its groups and weights, the wire
    over every rank (the world group), then the lock-step batcher
    (--batch-slots) or the single-flight engine. Global rank 0 serves
    HTTP. Raises SystemExit(1) when the engine failed."""
    from ..parallel import comm
    from ..parallel.mesh import MeshGroups

    device = cluster.device(rank, args.device)
    groups = MeshGroups.build(plan)
    wire = comm.AxisGroup.of()
    params, step = rank_params(config, plan, groups, device,
                               args.checkpoint)
    if step is not None and rank == 0:
        print(f"restored checkpoint step {step} (sharded)", flush=True)
    if args.batch_slots > 0:
        draft = None
        if draft_cfg is not None:
            # seed 1, not 0: a fresh draft under the target's seed would BE
            # the target when both share a named config
            dparams, _ = rank_params(draft_cfg, plan, groups, device,
                                     args.draft_checkpoint, init_seed=1)
            draft = (draft_cfg, dparams)
        code = _serve_multihost_batched(args, config, params, rank, wire,
                                        draft)
    else:
        code = _serve_single_flight(args, config, params, rank, wire, device)
    if code:
        raise SystemExit(code)


def _serve_single_flight(args, config, params, rank, wire, device) -> int:
    """The single-flight engine: rank 0 broadcasts each request (tokens
    padded to [b_max, t_max], its sampling parameters and a fresh seed),
    every rank runs the same generate on its shards, and a stop op ends
    every rank's loop. Idle, rank 0 broadcasts a no-op round every
    SERVE_IDLE_S."""
    import queue as _queue

    import torch

    from ..infer import generate
    from ..parallel import comm
    b_max, t_max = 8, config.max_seq_len
    work_q: "_queue.Queue" = _queue.Queue()
    httpd = None
    name = f"{args.family}/{args.config}"
    if rank == 0:
        srv = _MultihostServer(config, _whole_params(config), work_q,
                               args.kv_quant, b_max, t_max)
        httpd = ThreadingHTTPServer((args.host, args.port),
                                    _handler_for(srv, name))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        print(f"multihost serving {name} ({srv.n_params:,} params) on "
              f"{args.host}:{httpd.server_address[1]} — rank 0 of "
              f"{wire.size}, mesh tp={params.groups.plan.tp} over "
              f"{wire.size} devices", flush=True)
    else:
        print(f"multihost engine rank {rank}/{wire.size} following",
              flush=True)

    def engine_round(item, op: int = 0):
        """One broadcast and, for a request, one lock-step generate. Rank
        0 passes its request, or None with op 0 (the stop op) or op 2
        (the idle no-op); the followers pass None."""
        pad = torch.zeros((b_max, t_max), dtype=torch.int32)
        ints = torch.tensor([op, 0, 0, 0, 0, 0], dtype=torch.int32)
        floats = torch.zeros(2, dtype=torch.float32)
        if item is not None:
            b, t = item["prompt"].shape
            pad[:b, :t] = item["prompt"]
            ints = torch.tensor(
                [1, b, t, item["max_new"], item["top_k"],
                 int.from_bytes(os.urandom(3), "big")], dtype=torch.int32)
            floats = torch.tensor([item["temperature"], item["top_p"]],
                                  dtype=torch.float32)
        ints, floats, pad = comm.broadcast_one_to_all((ints, floats, pad),
                                                      wire)
        op, b, t, max_new, top_k, seed = ints.tolist()
        temperature, top_p = floats.tolist()
        if op == 0:
            return "stop"
        if op == 2:
            return None
        gen = torch.Generator(device=device).manual_seed(seed)
        out = generate(params, pad[:b, :t].to(device, torch.long), config,
                       max_new, temperature=temperature, top_k=top_k,
                       top_p=top_p, kv_quant=args.kv_quant, generator=gen)
        if item is not None:
            item["out"] = out.cpu().tolist()
        return None

    try:
        while True:
            if rank != 0:
                if engine_round(None) == "stop":
                    break
                continue
            try:
                item = work_q.get(timeout=SERVE_IDLE_S)
            except _queue.Empty:
                engine_round(None, op=2)
                continue
            if item is None:              # the stop sentinel
                engine_round(None)
                break
            try:
                engine_round(item)
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                item["error"] = e
                # the followers may wait in (or past) this round's
                # collective: a best-effort stop op keeps a rank-0 failure
                # from stranding them
                try:
                    engine_round(None)
                except Exception:  # noqa: BLE001
                    pass
                raise
            finally:
                item["done"].set()
    except KeyboardInterrupt:
        if rank == 0:
            engine_round(None)
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
    return 0


def _serve_multihost_batched(args, config, params, rank, wire,
                             draft=None) -> int:
    """Lock-step continuous batching: every rank builds the same
    _LockstepBatcher (one seed for the whole pod, broadcast: a rank's own
    would draw different samples); rank 0 owns the HTTP endpoint and its
    queue. -> 0, or 1 when the scheduler died."""
    import torch

    from ..parallel import comm
    seed, = comm.broadcast_one_to_all(
        [torch.tensor([int.from_bytes(os.urandom(4), "big")],
                      dtype=torch.int64)], wire)
    try:
        batcher = _LockstepBatcher(
            config, params, slots=args.batch_slots,
            max_len=args.batch_max_len or config.max_seq_len,
            world=wire, rank=rank,
            prefill_chunk=args.batch_prefill_chunk,
            decode_chunk=args.decode_chunk, seed=int(seed[0]),
            kv_quant=args.kv_quant, kv_block=args.kv_block,
            kv_pool_blocks=args.kv_pool, prefix_cache=args.prefix_cache,
            draft=draft, gamma=args.gamma, shard_kv=args.shard_kv)
    except ValueError as e:
        raise SystemExit(str(e))
    if rank != 0:
        print(f"multihost batching engine rank {rank}/{wire.size} "
              "following", flush=True)
        try:
            batcher.thread.join()
        except KeyboardInterrupt:
            # rank 0's stop op ends the loop; wait for it a while
            batcher.thread.join(timeout=10)
        return 0 if batcher._dead is None else 1
    srv = _Server(config, params)
    srv.n_params = _whole_params(config)
    srv.batcher = batcher
    name = f"{args.family}/{args.config}"
    httpd = ThreadingHTTPServer((args.host, args.port),
                                _handler_for(srv, name,
                                             admit_queue=args.admit_queue))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    mode = (f"paged ({batcher.kv_pool_blocks} x {args.kv_block} "
            f"token blocks)" if args.kv_block else "dense")
    if args.shard_kv:
        mode += ", tp-sharded"
    spec = (f", speculative (draft {args.draft_config}, gamma "
            f"{args.gamma})" if draft else "")
    print(f"multihost continuous batching {name} "
          f"({srv.n_params:,} params) on {args.host}:"
          f"{httpd.server_address[1]} — {args.batch_slots} slots x "
          f"{batcher.max_len} tokens, {mode} KV{spec}, rank 0 of "
          f"{wire.size}", flush=True)
    # the main thread follows the scheduler, not the HTTP server: a dead
    # lock-step loop ends rank 0 (not a process answering "batcher
    # unavailable" while a supervisor sees it healthy)
    try:
        batcher.thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        crashed = batcher._dead is not None
        batcher.close()     # broadcasts the stop op: the followers exit
        httpd.shutdown()
        httpd.server_close()
    return 1 if crashed else 0


def _refuse_unported(args, multihost: bool = False) -> None:
    """SystemExit, with the JAX server's message, for what it refuses:
    in multi-host mode (`multihost`) --quantize, --host-load, and without
    --batch-slots a draft, --shard-kv or the paged and prefix flags; on
    one host --shard-kv, --host-load without --quantize, and without
    --batch-slots the paged and prefix flags. --tp is read on the
    multi-host path only; single-host serving ignores it, as the JAX
    server does."""
    if multihost:
        for flag, msg in ((args.quantize, "--quantize"),
                          (args.host_load, "--host-load")):
            if flag:
                raise SystemExit(
                    f"{msg} is single-host serving for now; the "
                    "multi-host engine runs plain sharded generate "
                    "(drop the flag, or serve per-host)")
        if args.draft_config and not args.batch_slots:
            raise SystemExit(
                "--draft-config in multihost mode runs inside the "
                "lock-step batcher (per-slot proposals, shared sharded "
                "verify) — add --batch-slots N")
        if args.shard_kv and not args.batch_slots:
            raise SystemExit(
                "--shard-kv shards the batching scheduler's cache; it "
                "needs --batch-slots N")
        if not args.batch_slots and (args.prefix_cache or args.kv_block
                                     or args.kv_pool):
            raise SystemExit(
                "--prefix-cache/--kv-block/--kv-pool configure the "
                "batching scheduler; they need --batch-slots N "
                "(multihost or not)")
        return
    if args.shard_kv:
        raise SystemExit(
            "--shard-kv is multihost serving (the single-host cache "
            "has no mesh to shard over)")
    if args.host_load and not args.quantize:
        raise SystemExit("--host-load exists to serve models whose "
                         "bf16 weights exceed HBM; it requires "
                         "--quantize w8|w8a8")
    if not args.batch_slots:
        if args.prefix_cache:
            raise SystemExit("--prefix-cache lives in the batching "
                             "scheduler; it needs --batch-slots N")
        if args.kv_block or args.kv_pool:
            raise SystemExit("--kv-block/--kv-pool configure the batching "
                             "scheduler's cache; they need --batch-slots N")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="llama", choices=["llama", "moe"])
    p.add_argument("--config", default="tiny",
                   help="named config for the family (models.NAMED_CONFIGS; "
                        "e.g. tiny, mini, 250m, 1b, llama3_8b)")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint dir (the training workload's "
                        "<workdir>/checkpoints); fresh init when empty")
    p.add_argument("--quantize", default="", choices=["", "w8", "w8a8"],
                   help="int8 post-load quantization of the matmul weights "
                        "(ops/quant.py): w8 = weight-only, w8a8 = +dynamic "
                        "activation int8")
    p.add_argument("--host-load", action="store_true",
                   help="build the weights on the host and stream them to "
                        "the card as int8, leaf by leaf, for models whose "
                        "dense weights do not fit it (requires --quantize)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache: half the cache bytes a decode step "
                        "reads (per-token-per-head scales, dequantized in "
                        "the attend)")
    p.add_argument("--draft-config", default="",
                   help="named config of a draft model for speculative "
                        "decoding. Alone: B=1 requests (greedy stream exact; "
                        "sampling exact via rejection sampling). With "
                        "--batch-slots: speculative rounds inside the "
                        "batcher (per-slot proposals, one shared verify "
                        "forward, the same exactness per row)")
    p.add_argument("--draft-checkpoint", default="",
                   help="checkpoint for the draft (fresh init when empty — "
                        "useful only for testing)")
    p.add_argument("--gamma", type=int, default=4,
                   help="speculative proposal length per round")
    p.add_argument("--batch-slots", type=int, default=0,
                   help="continuous batching: N cache slots; single-sequence "
                        "requests join the running batch between decode "
                        "steps (0 = off)")
    p.add_argument("--batch-max-len", type=int, default=0,
                   help="slot cache length (default: the model's "
                        "max_seq_len)")
    p.add_argument("--batch-prefill-chunk", type=int, default=0,
                   help="chunked prefill: feed prompts in pieces of N tokens "
                        "interleaved with decode steps (0 = whole prompt)")
    p.add_argument("--prefix-cache", type=int, default=0,
                   help="keep the KV of the last N distinct prompts; a "
                        "request extending a cached prompt prefills only the "
                        "suffix (0 = off). With paged KV (--kv-block) the "
                        "reuse is zero-copy: shared blocks enter the new "
                        "request's page table")
    p.add_argument("--kv-block", type=int, default=0,
                   help="paged slot cache: block size in tokens; slots share "
                        "a block pool instead of dense slots x max_len "
                        "reservations, admission waits on free blocks, and "
                        "block-aligned common prompt prefixes are shared "
                        "with in-flight requests zero-copy (0 = dense)")
    p.add_argument("--kv-pool", type=int, default=0,
                   help="paged pool size in blocks (default: full capacity, "
                        "slots x ceil(max_len/block) + scratch; shrink to "
                        "cap KV memory)")
    p.add_argument("--decode-chunk", type=int, default=1,
                   help="decode up to N steps per host sync when no request "
                        "is waiting to join (1 = sync every step)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel width for multi-host serving (0 = "
                        "auto); single-host serving ignores it")
    p.add_argument("--shard-kv", action="store_true",
                   help="shard the slot cache over tp (multi-host serving)")
    p.add_argument("--admit-queue", type=int, default=0,
                   help="replica-side admission bound: /generate sheds 429 "
                        "(+ X-TDAPI-Shed) once the batcher's queue is this "
                        "deep (0 = never shed)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0,
                   help="0 = the control plane's granted port ($PORT from "
                        "the process substrate), falling back to 8000")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to serve: the CUDA card (default; raises "
                        "without one) or, when asked, the CPU")
    return p


def main(argv=None) -> int:
    p = _parser()
    args = p.parse_args(argv)
    if not args.port:
        args.port = int(os.environ.get("PORT", "8000"))

    from ..distributed import cluster_spec_from_env
    from ..models import named_config
    from ..train import Trainer

    try:
        config = named_config(args.family, args.config)
    except KeyError as e:
        p.error(str(e))
    # a grant that spans workers: its contract describes the cluster, and
    # the lock-step engine serves it (a malformed contract raises)
    cluster = cluster_spec_from_env()
    _refuse_unported(args, multihost=cluster is not None)
    if cluster is not None:
        return _serve_multihost(args, config, cluster)

    from ..device import resolve_device
    device = resolve_device(args.device)   # no card and no --device cpu: raise

    trainer = Trainer.create(config, device=device)
    if args.host_load:
        # the dense tree never touches the card: built on the host, then
        # streamed leaf by leaf as int8
        params = _host_load(trainer, args.checkpoint, args.quantize)
        print(f"host-loaded + streamed int8 ({args.quantize}) to {device}",
              flush=True)
    else:
        params = _load_params(trainer, args.checkpoint)
        if args.quantize:
            from ..ops.quant import quantize_params
            params = quantize_params(params, args.quantize)
            print(f"quantized matmul weights to int8 ({args.quantize})",
                  flush=True)
    draft = None
    if args.draft_config:
        try:
            dcfg = named_config(args.family, args.draft_config)
        except KeyError as e:
            p.error(str(e))
        # fresh-init drafts use seed 1: under the target's seed 0 a
        # same-named-config draft would BE the target
        dparams = _load_params(Trainer.create(dcfg, device=device),
                               args.draft_checkpoint, init_seed=1)
        if dcfg.vocab_size != config.vocab_size:
            raise SystemExit("draft and target must share a vocab")
        draft = (dcfg, dparams)
        print(f"speculative decoding armed: draft {args.draft_config}, "
              f"gamma {args.gamma}", flush=True)
    srv = _Server(config, params, kv_quant=args.kv_quant, draft=draft,
                  gamma=args.gamma)
    reg_tenant = None
    if args.batch_slots > 0:
        # --draft-config composes (speculative rounds over the whole slot
        # batch), so does --kv-quant (int8 caches, both models), and so
        # does --kv-block (paged_verify writes each row's gamma+1 tokens
        # through its page table; admission reserves the overshoot).
        # Fractional co-tenancy: a share-granted container
        # (TDAPI_TPU_SHARES / TDAPI_PRIORITY) registers with its chip's
        # regulator, so its device chunks time-slice against co-tenants
        # by share weight
        from .. import regulator
        reg_tenant = regulator.tenant_from_env()
        if reg_tenant is not None:
            print(f"chip co-tenancy: weight {reg_tenant.weight}, "
                  f"class {reg_tenant.priority}", flush=True)
        try:
            srv.batcher = _Batcher(config, params, slots=args.batch_slots,
                                   max_len=args.batch_max_len
                                   or config.max_seq_len,
                                   prefill_chunk=args.batch_prefill_chunk,
                                   prefix_cache=args.prefix_cache,
                                   kv_quant=args.kv_quant,
                                   kv_block=args.kv_block,
                                   kv_pool_blocks=args.kv_pool,
                                   decode_chunk=args.decode_chunk,
                                   draft=draft, gamma=args.gamma,
                                   regulator=reg_tenant)
        except ValueError as e:
            if reg_tenant is not None:
                reg_tenant.unregister()
            raise SystemExit(str(e))
        mode = (f"paged ({srv.batcher.kv_pool_blocks} x {args.kv_block} "
                f"token blocks)" if args.kv_block else "dense")
        spec = (f", speculative (draft {args.draft_config}, gamma "
                f"{args.gamma})" if draft else "")
        print(f"continuous batching: {args.batch_slots} slots x "
              f"{srv.batcher.max_len} tokens, {mode} KV{spec}", flush=True)

    name = f"{args.family}/{args.config}"
    try:
        httpd = ThreadingHTTPServer((args.host, args.port),
                                    _handler_for(srv, name,
                                                 admit_queue=args.admit_queue))
        print(f"serving {name} ({srv.n_params:,} params) on "
              f"{args.host}:{httpd.server_address[1]}", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
    finally:
        if srv.batcher is not None:
            srv.batcher.close()
        if reg_tenant is not None:
            # leave the chip's regulator clean: a replaced version must not
            # leave a dead tenant in the process-wide registry
            reg_tenant.unregister()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
