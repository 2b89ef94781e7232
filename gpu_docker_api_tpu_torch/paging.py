"""Paged KV cache, PyTorch port of gpu_docker_api_tpu/paging.py: a shared
block pool for continuous batching.

The dense slot cache (batching.py) reserves `slots x max_len` tokens of KV
up front. Here ONE pool of `n_blocks` fixed-size blocks ([L, n_blocks,
block, Hkv, D]) backs every slot; each slot holds a PAGE TABLE (block
indices) and takes only the blocks its request needs. Admission becomes a
free-block question, and cache memory follows resident tokens, not
slots x max_len.

Block 0 is a SCRATCH block: never allocated, the write target of inactive
rows, so their junk never lands in a live page. Quantized pools (int8 K/V
with per-token-per-head f32 scales "ks"/"vs") follow infer.init_cache's
kv8 layout.

Differences from the JAX version:
- the pools are written in place (the JAX functions donate the cache and
  return a new one); every function returns the cache dict it was given,
  with `lengths` (int32 [slots] on the device) and `host_lengths` moved
  together, and `pages` (int32 [slots, max_pages] on the device) mirrored
  by `host_pages`, row by row (set_pages);
- the JAX attend walks a row's pages in a fori_loop whose trip count is a
  device value (the furthest active row's frontier). Here the number of
  pages is a host int, from the host lengths of the active rows, and each
  layer reads those pages of every row with ONE gather of
  pool[pages[:, :n]], then one masked f32 softmax (infer._softmax_attend):
  the same columns, the same masks, summed in another order. A step makes
  no device sync;
- writes are one index_put_ per buffer at (block, offset) pairs built once
  per step and shared by every layer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .batching import (_active, _advance, _buf_keys, _set_length,
                       make_decode_multi, make_decode_pick, to_device)
from .device import resolve_device
from .infer import (Frontiers, _llama_view, _out_and_mlp, _qkv,
                    _quantize_kv, _run_layers, _softmax_attend)
from .models.llama import rope_frequencies


@torch.no_grad()
def init_paged_cache(config, n_blocks: int, block_size: int, slots: int,
                     max_pages: int, quantized: bool = False,
                     device=None) -> dict:
    """Block pool + per-slot page tables on `device` (None: the card,
    raising without one). Pool memory = n_blocks x block_size tokens of KV
    per layer, independent of slots and max_len. pages[s, j] is the pool
    block backing token positions [j*block, (j+1)*block) of slot s; 0 is
    the scratch block."""
    dev = resolve_device(device)
    c = _llama_view(config)
    shape = (c.n_layers, n_blocks, block_size, c.n_kv_heads, c.head_dim)
    dtype = torch.int8 if quantized else c.dtype
    out = {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pages": torch.zeros((slots, max_pages), dtype=torch.int32,
                             device=dev),
        "lengths": torch.zeros(slots, dtype=torch.int32, device=dev),
        "host_lengths": [0] * slots,
        "host_pages": [[0] * max_pages for _ in range(slots)],
    }
    if quantized:
        sshape = shape[:-1] + (1,)
        out["ks"] = torch.ones(sshape, dtype=torch.float32, device=dev)
        out["vs"] = torch.ones(sshape, dtype=torch.float32, device=dev)
    return out


def set_pages(cache, slot: int, blocks) -> None:
    """Slot `slot`'s page table: `blocks` then zeros, on the host and on
    the device (through pinned memory, without blocking)."""
    row = list(blocks) + [0] * (cache["pages"].shape[1] - len(blocks))
    cache["host_pages"][slot] = row
    cache["pages"][slot].copy_(to_device(row, torch.int32,
                                         cache["pages"].device))


class _Step:
    """The pool indices of one paged step, built once and shared by every
    layer: where each row's T new positions land (block, offset), and which
    pages the attend gathers.

    pages [B, P] (device), frontiers `fr` (host ints and the same on the
    device). Inactive rows (dev_active False) write to the scratch block
    0. There `index_put_` sees duplicate indices, and CUDA does not promise
    which write lands: harmless, since block 0 is read only where a
    row's mask hides it. A row's page-table entries past its own pages are
    0 too, and its frontier masks them. The attend reads the first n pages
    of every row, n covering the furthest active row's frontier (host
    ints: no device sync)."""

    def __init__(self, pages, block: int, fr: Frontiers, t: int,
                 host_active=None, dev_active=None):
        max_pages = pages.shape[1]
        steps = torch.arange(t, device=pages.device)
        self.rows = fr.dev[:, None] + steps                     # [B, T]
        page_of = (self.rows // block).clamp(max=max_pages - 1)
        bidx = pages.gather(1, page_of)
        if dev_active is not None:
            bidx = torch.where(dev_active[:, None], bidx, 0)
        self.bidx, self.off = bidx.long(), self.rows % block
        live = (fr.host if host_active is None
                else [p for p, a in zip(fr.host, host_active) if a])
        far = max(live, default=0) + t
        self.n = min(max(-(-far // block), 1), max_pages)
        self.gather = pages[:, :self.n].reshape(-1).long()
        self.cols = torch.arange(self.n * block, device=pages.device)

    def write(self, pool, new) -> None:
        """new [B,T,...] into pool [n_blocks, block, ...] in place."""
        pool.index_put_((self.bidx, self.off), new.to(pool.dtype))

    def read(self, pool, scale=None):
        """The gathered pages of every row, [B, n*block, ...] f32
        (dequantized by `scale` for an int8 pool)."""
        b = self.rows.shape[0]
        out = pool.index_select(0, self.gather).float()
        if scale is not None:
            out = out * scale.index_select(0, self.gather)
        return out.reshape(b, self.n * pool.shape[1], *pool.shape[2:])

    def attend(self, q, pool_k, pool_v, scale_k=None, scale_v=None):
        """q [B,T,H,D] over each row's pages up to its causal frontier."""
        mask = self.cols[None, None, :] <= self.rows[:, :, None]
        return _softmax_attend(q, self.read(pool_k, scale_k),
                               self.read(pool_v, scale_v),
                               mask[:, None, None])


def _paged_layer_step(x, layer, pool_k, pool_v, step, config, cos, sin,
                      scale_k=None, scale_v=None, active=None):
    """One decoder layer over a T-token slice with paged cache read and
    write: the paged twin of infer._layer_step (step: the _Step)."""
    q, k, v = _qkv(x, layer, config, cos, sin)
    if scale_k is not None:
        k, ks_new = _quantize_kv(k)
        v, vs_new = _quantize_kv(v)
        step.write(scale_k, ks_new)
        step.write(scale_v, vs_new)
    step.write(pool_k, k)
    step.write(pool_v, v)
    out = step.attend(q, pool_k, pool_v, scale_k, scale_v)
    return _out_and_mlp(x, out, layer, config)


def _block(cache) -> int:
    return cache["k"].shape[2]


@torch.no_grad()
def paged_prefill(params, prompt, cache, slot: int, config,
                  append: bool = False):
    """Run prompt [1, T] through the model into slot `slot`'s pages (which
    the host allocator must already cover through start+T). Returns (last
    logits [1, V] f32, cache). append=True continues at the slot's current
    length (chunked prefill)."""
    slot, t = int(slot), prompt.shape[1]
    start = cache["host_lengths"][slot] if append else 0
    blk, max_pages = _block(cache), cache["pages"].shape[1]
    if start + t > max_pages * blk:
        raise ValueError(
            f"paged KV overflow: length {start} + {t} new token(s) exceeds "
            f"the {max_pages} pages of {blk} tokens a slot holds")
    dev = prompt.device
    fr = Frontiers([start], to_device([start], torch.int32, dev))
    step = _Step(cache["pages"][slot:slot + 1], blk, fr, t)
    x = F.embedding(prompt, params["embed"])
    cos, sin = rope_frequencies(config, torch.arange(start, start + t,
                                                     device=dev))
    logits = _run_layers(params, x, cache, step, config, cos, sin,
                         last_only=True, layer_step=_paged_layer_step)
    _set_length(cache, slot, start + t)
    return logits[:, -1], cache


def _paged_decode_core(params, tokens, cache, active, config,
                       dev_active=None):
    """One decode step for every slot (batching._slot_decode_core's
    signature): tokens [slots], active [slots] host bools. Inactive rows
    write to the scratch block and do not advance."""
    if dev_active is None:
        active, dev_active = _active(active, tokens.device)
    fr = Frontiers(cache["host_lengths"], cache["lengths"])
    step = _Step(cache["pages"], _block(cache), fr, 1, active, dev_active)
    x = F.embedding(tokens[:, None], params["embed"])         # [slots,1,D]
    cos, sin = rope_frequencies(config, fr.dev)
    logits = _run_layers(params, x, cache, step, config, cos[:, None],
                         sin[:, None], layer_step=_paged_layer_step)
    _advance(cache, active, dev_active)
    return logits[:, -1], cache


@torch.no_grad()
def paged_decode(params, tokens, cache, active, config):
    """One decode step for every slot together over the shared pool."""
    return _paged_decode_core(params, tokens, cache, active, config)


paged_decode_multi = make_decode_multi(_paged_decode_core)
paged_decode_pick = make_decode_pick(_paged_decode_core)


@torch.no_grad()
def paged_verify(params, blocks, cache, active, config):
    """Multi-token forward at each row's OWN frontier over the paged pool,
    the paged twin of batching.slot_verify: blocks [slots, T] append T
    tokens per row from that row's length, each position written through
    the page table, so a row's T positions may span a block edge.

    The batcher reserves gamma positions of block budget per request (the
    verify overshoot before rollback), so no active row's write falls
    through to the scratch block, where two rows' overshoots would corrupt
    each other's verify logits. Inactive rows write junk to scratch and do
    not advance. Returns (logits [slots, T, V] f32, cache)."""
    t = blocks.shape[1]
    active, dev_active = _active(active, blocks.device)
    fr = Frontiers(cache["host_lengths"], cache["lengths"])
    step = _Step(cache["pages"], _block(cache), fr, t, active, dev_active)
    x = F.embedding(blocks, params["embed"])                  # [slots,T,D]
    cos, sin = rope_frequencies(config, step.rows)            # [slots,T,d/2]
    logits = _run_layers(params, x, cache, step, config, cos, sin,
                         layer_step=_paged_layer_step)
    _advance(cache, active, dev_active, t)
    return logits, cache


class BlockAllocator:
    """Host-side REFCOUNTED free-list over the pool's blocks (block 0 =
    scratch, never handed out). The batcher's admission control: a request
    is admitted only when its full reservation fits. Refcounts enable
    zero-copy prefix sharing: a cached prompt prefix's blocks appear in
    many page tables at once and return to the free list only when the
    last reference drops."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is scratch)")
        self._free = list(range(n_blocks - 1, 0, -1))   # pop() -> low ids
        self._rc = [0] * n_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """n fresh blocks (rc 1 each) or None (caller keeps queueing)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._rc[b] = 1
        return out

    def share(self, blocks) -> None:
        """One more reference to already-live blocks (prefix reuse)."""
        for b in blocks:
            if self._rc[b] <= 0:     # a real raise: python -O strips asserts
                raise RuntimeError(f"sharing dead block {b}")
            self._rc[b] += 1

    def free(self, blocks) -> None:
        """Drop one reference each; blocks return at refcount zero."""
        for b in blocks:
            if self._rc[b] <= 0:
                # a double free would re-list a block a stored prefix still
                # references: cross-request KV corruption
                raise RuntimeError(f"double free of block {b}")
            self._rc[b] -= 1
            if self._rc[b] == 0:
                self._free.append(b)


@torch.no_grad()
def paged_extract_blocks(cache, block_ids) -> dict:
    """Host copies of the pool blocks backing a KV handoff export
    (workloads/serve.py): {buffer name: numpy [L, len(block_ids), ...]}.
    bf16 pools go out as float32 (exact for every bf16 value), so the wire
    carries float32 and int8 only and needs no bfloat16 numpy type on
    either side; int8 pools and the f32 scales go out as they are."""
    idx = torch.tensor(list(block_ids), dtype=torch.long,
                       device=cache["k"].device)
    out = {}
    for name in _buf_keys(cache):
        arr = cache[name].index_select(1, idx)
        if arr.dtype not in (torch.int8, torch.float32):
            arr = arr.float()
        out[name] = arr.cpu().numpy()
    return out


@torch.no_grad()
def paged_inject_blocks(cache, block_ids, bufs) -> dict:
    """Inverse of paged_extract_blocks: write fetched KV into this slot's
    (private, freshly allocated) pool blocks, in place. Raises (and writes
    nothing) on a missing buffer or a geometry mismatch: the caller then
    prefills from scratch. Returns the cache."""
    idx = torch.tensor(list(block_ids), dtype=torch.long,
                       device=cache["k"].device)
    new = {}
    for name in _buf_keys(cache):
        buf = np.asarray(bufs[name])
        want = (cache[name].shape[0], len(idx), *cache[name].shape[2:])
        if tuple(buf.shape) != want:
            raise ValueError(f"kv import buffer {name} shape mismatch")
        new[name] = torch.from_numpy(np.array(buf)).to(
            device=cache[name].device, dtype=cache[name].dtype)
    for name, t in new.items():
        cache[name].index_copy_(1, idx, t)
    return cache
