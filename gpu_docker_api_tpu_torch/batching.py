"""Continuous batching, PyTorch port of gpu_docker_api_tpu/batching.py: a
slot-based KV cache with per-row lengths.

The server holds ONE cache of `slots` rows; requests claim a free slot,
prefill into it, and every decode step advances ALL active slots together,
so new requests join between steps instead of waiting for the batch to
drain. Each row attends to its own frontier (per-row causal mask), RoPE
runs at per-row positions and cache writes land at per-row offsets.

Per-step decode picks each row's token with ITS OWN sampling parameters
(rowwise_pick: temperature 0 = greedy, else temperature / top-k / top-p as
[slots] vectors), with a pure-argmax fast path when nothing samples;
speculative decoding runs per slot on the shared step (slot_spec_draft,
slot_verify, spec_accept_greedy, rowwise_spec_accept).

Differences from the JAX version:
- the cache is written in place (the JAX functions donate it and return a
  new one). Every function here returns the cache dict it was given, with
  `lengths` (int32 [slots] on the device) and `host_lengths` (the same as
  Python ints) moved together;
- per-row frontiers reach infer.py as infer.Frontiers: host ints for the
  attend's key range, one device tensor per step for the writes and RoPE,
  so a step makes no device sync before its tokens are fetched. Small host
  lists (the active mask, tokens) go to the card through pinned memory
  without blocking;
- the device-side lax.scan of a decode chunk is a Python loop of eager
  steps with no host sync inside it, and per-row budgets are host ints;
- sampling draws from an explicit torch.Generator (the JAX version folds a
  PRNG key), so sampled tokens differ from JAX's; greedy tokens agree.

PrefixTrie, the radix index of the paged block pool (paging.py), is the JAX
class as it is: host-side Python.

Not ported: kv_shard_specs (multi-host). Every public function runs under
torch.no_grad().
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .device import resolve_device
from .infer import (Frontiers, _categorical, _checked_length,
                    _forward_cached, _run_layers, init_cache)
from .models.llama import rope_frequencies


@torch.no_grad()
def init_slot_cache(config, slots: int, max_len: int,
                    quantized: bool = False, device=None) -> dict:
    """Cache of `slots` rows, each up to max_len tokens, with per-row
    lengths, on `device` (None: the card, raising without one).
    quantized=True stores K/V as int8 with per-token-per-head f32 scales
    ("ks"/"vs"), the layout of infer.init_cache."""
    dev = resolve_device(device)
    cache = init_cache(config, slots, max_len, quantized=quantized,
                       device=dev)
    del cache["length"], cache["host_length"]
    cache["lengths"] = torch.zeros(slots, dtype=torch.int32, device=dev)
    cache["host_lengths"] = [0] * slots
    return cache


def to_device(values, dtype, device) -> torch.Tensor:
    """A short host list as a tensor on `device`. On the card the copy goes
    through pinned memory without blocking: a copy from pageable memory
    would wait for the stream to drain."""
    if device.type != "cuda":
        return torch.tensor(values, dtype=dtype, device=device)
    return torch.tensor(values, dtype=dtype, pin_memory=True).to(
        device, non_blocking=True)


def _active(active, device):
    """(host list of bools, the same as a bool tensor on `device`)."""
    host = [bool(a) for a in active]
    return host, to_device(host, torch.bool, device)


def _set_length(cache, slot: int, length: int) -> None:
    cache["lengths"][slot] = length
    cache["host_lengths"][slot] = length


def set_lengths(cache, lengths) -> None:
    """Every row's length at once, on the host and on the device (the
    speculative rollback)."""
    cache["host_lengths"] = [int(n) for n in lengths]
    cache["lengths"].copy_(to_device(cache["host_lengths"], torch.int32,
                                      cache["lengths"].device))


def _advance(cache, host_active, dev_active, t: int = 1) -> None:
    """Active rows move on t positions, on the device and on the host."""
    cache["lengths"] += t * dev_active.int()
    cache["host_lengths"] = [n + t * a for n, a in
                             zip(cache["host_lengths"], host_active)]


@torch.no_grad()
def slot_prefill(params, prompt, cache, slot: int, config,
                 append: bool = False):
    """Run prompt [1, T] through the model into slot row `slot`, written in
    place through the row's view of the cache. Returns (last logits [1, V]
    f32, cache).

    append=False: the row's previous content is logically discarded (its
    length resets to T, writes start at 0). append=True: continues at the
    row's current length (chunked prefill)."""
    slot = int(slot)
    start = cache["host_lengths"][slot] if append else 0
    row = {kk: cache[kk][:, slot:slot + 1] for kk in _buf_keys(cache)}
    row["length"] = cache["lengths"][slot]
    row["host_length"] = start
    _checked_length(row, prompt.shape[1])
    logits, _ = _forward_cached(params, prompt, row, config, last_only=True)
    _set_length(cache, slot, start + prompt.shape[1])
    return logits[:, -1], cache


def _buf_keys(cache) -> tuple:
    """The per-slot device buffers, in a fixed order ("k","v"[,"ks","vs"])."""
    return tuple(kk for kk in ("k", "v", "ks", "vs") if kk in cache)


@torch.no_grad()
def slot_extract_kv(cache, slot: int, length: int) -> tuple:
    """COPIES of the first `length` cache positions of slot row `slot`, as
    [L, length, Hkv, ...] buffers, one per cache buffer key (2 dense, 4
    quantized): the prefix-cache store entry. A copy, not a view: the
    slot's next occupant overwrites the row."""
    return tuple(cache[kk][:, slot, :length].clone()
                 for kk in _buf_keys(cache))


@torch.no_grad()
def slot_restore_kv(cache, slot: int, prefix_bufs, length: int):
    """Write a stored prefix's buffers (the slot_extract_kv tuple) into
    slot row `slot` from position 0 and set the row length to `length`;
    the buffers may be bucket-padded, only [0, length) is attendable."""
    for kk, buf in zip(_buf_keys(cache), prefix_bufs):
        cache[kk][:, slot, :buf.shape[1]] = buf.to(cache[kk].dtype)
    _set_length(cache, int(slot), int(length))
    return cache


def _slot_decode_core(params, tokens, cache, active, config, dev_active=None):
    """One decode step for every slot: tokens [slots] int (last token per
    row), active [slots] host bools (dev_active: the same on the device,
    when the caller has it). Returns (logits [slots, V] f32, cache):
    inactive rows write junk at their frozen frontier (overwritten by their
    next prefill) and do NOT advance."""
    if dev_active is None:
        active, dev_active = _active(active, tokens.device)
    fr = Frontiers(cache["host_lengths"], cache["lengths"])
    x = F.embedding(tokens[:, None], params["embed"])        # [slots,1,D]
    cos, sin = rope_frequencies(config, fr.dev)               # [slots, d/2]
    logits = _run_layers(params, x, cache, fr, config, cos[:, None],
                         sin[:, None], active=active)
    _advance(cache, active, dev_active)
    return logits[:, -1], cache


@torch.no_grad()
def slot_decode(params, tokens, cache, active, config):
    """One decode step for every slot together (_slot_decode_core)."""
    return _slot_decode_core(params, tokens, cache, active, config)


def _rowwise_filter(lt, top_ks, top_ps):
    """Per-row top-k/top-p filtering of temperature-scaled logits lt
    [..., V]; top_ks/top_ps broadcast over the leading dims ([slots] for
    one position per row, [slots, 1] for a [slots, T, V] block). Filtered
    entries go to -inf; the top token always survives.

    The JAX version's semantics, via one descending sort: the k-th largest
    is the top-k cutoff; the nucleus cutoff is the smallest sorted logit
    whose cumulative probability (within the k-filtered set) stays inside
    top_p."""
    v = lt.shape[-1]
    sl = torch.sort(lt, dim=-1, descending=True).values
    k_eff = torch.where(top_ks > 0, top_ks, v)
    idx = (k_eff - 1).clamp(0, v - 1)[..., None]
    kth = sl.gather(-1, idx.expand(*sl.shape[:-1], 1).long())
    ranks = torch.arange(v, device=lt.device)
    sl_k = torch.where(ranks < k_eff[..., None], sl, float("-inf"))
    p_sorted = torch.softmax(sl_k, dim=-1)
    cum = torch.cumsum(p_sorted, dim=-1)
    inside = cum - p_sorted < top_ps[..., None]
    cutoff = torch.where(inside, sl_k, float("inf")).amin(dim=-1,
                                                          keepdim=True)
    return torch.where((lt >= kth) & (lt >= cutoff), lt, float("-inf"))


def _scaled(logits, temps):
    """logits / temperature per row (greedy rows, temperature 0, by 1)."""
    t = torch.where(temps > 0, temps, 1.0)
    return logits.float() / t.reshape(-1, *([1] * (logits.dim() - 1)))


def rowwise_pick(logits, temps, top_ks, top_ps, generator):
    """Per-ROW next-token selection: row i is greedy when temps[i] == 0,
    else categorical over logits[i]/temps[i] filtered by ITS top_ks[i]
    (0 = off) and top_ps[i], drawn from `generator`. Returns [slots]
    int64."""
    sampled = _categorical(
        _rowwise_filter(_scaled(logits, temps), top_ks, top_ps), generator)
    return torch.where(temps > 0, sampled, logits.argmax(dim=-1))


def make_decode_multi(core):
    """`steps` decode steps over `core` (a _slot_decode_core-shaped body)
    as one call with no host sync inside it: the caller fetches the
    [steps, slots] tokens once.

    remaining [slots] host ints: per-row budget; a row stops advancing after
    its budget (its tokens beyond that are junk the caller discards). With
    `sample` (temps, top_ks, top_ps, generator), rows pick via
    rowwise_pick; without it, pure greedy. Returns (tokens [steps, slots],
    cache)."""

    @torch.no_grad()
    def decode_multi(params, tokens, cache, active, remaining, config,
                     steps: int, sample=None):
        out = []
        for t in range(steps):
            act, dev_act = _active(
                [a and t < r for a, r in zip(active, remaining)],
                tokens.device)
            logits, cache = core(params, tokens, cache, act, config, dev_act)
            nxt = (logits.argmax(dim=-1) if sample is None
                   else rowwise_pick(logits, *sample))
            tokens = torch.where(dev_act, nxt, tokens)
            out.append(nxt)
        return torch.stack(out), cache

    return decode_multi


def make_decode_pick(core):
    """One decode step that picks the next token on the device with
    per-row sampling parameters (rowwise_pick): one [slots] fetch per step
    instead of a [slots, V] logits fetch."""

    @torch.no_grad()
    def decode_pick(params, tokens, cache, active, temps, top_ks, top_ps,
                    generator, config):
        logits, cache = core(params, tokens, cache, active, config)
        return rowwise_pick(logits, temps, top_ks, top_ps, generator), cache

    return decode_pick


slot_decode_multi = make_decode_multi(_slot_decode_core)
slot_decode_pick = make_decode_pick(_slot_decode_core)


# ---- speculative decoding inside the slot batch ----------------------------
#
# A draft model (its own slot cache) proposes gamma tokens for every active
# row, the target verifies all rows' gamma+1 positions in ONE multi-token
# forward, and acceptance and rollback are per row: greedy rows emit exactly
# the target-only greedy stream; sampling rows keep exact target statistics
# via per-row rejection sampling.

@torch.no_grad()
def slot_verify(params, blocks, cache, active, config):
    """Multi-token forward at each row's OWN frontier: blocks [slots, T]
    append T tokens per row from that row's length (per-row RoPE positions,
    per-row causal mask inside the block). Active rows advance T; inactive
    rows write junk at their frozen frontier and do not advance. Returns
    (logits [slots, T, V] f32, cache): the speculative VERIFY step."""
    t = blocks.shape[1]
    active, dev_active = _active(active, blocks.device)
    fr = Frontiers(cache["host_lengths"], cache["lengths"])
    x = F.embedding(blocks, params["embed"])                  # [slots,T,D]
    rows = fr.dev[:, None] + torch.arange(t, device=blocks.device)
    cos, sin = rope_frequencies(config, rows)                 # [slots,T,d/2]
    logits = _run_layers(params, x, cache, fr, config, cos, sin,
                         active=active)
    _advance(cache, active, dev_active, t)
    return logits, cache


@torch.no_grad()
def slot_spec_draft(params, tokens, cache, active, config, gamma: int,
                    sample=None):
    """The draft model proposes `gamma` tokens per active row,
    autoregressively over its own slot cache. Greedy rows take argmax; with
    `sample` (temps, top_ks, top_ps, generator), sampling rows draw from the
    draft's FILTERED distribution q, whose log-probs are returned for the
    acceptance test. Returns (drafts [slots, gamma], dlogp [gamma, slots, V]
    or None when greedy, cache)."""
    active, dev_active = _active(active, tokens.device)
    drafts, dlogp = [], []
    for _ in range(gamma):
        logits, cache = _slot_decode_core(params, tokens, cache, active,
                                          config, dev_active)
        nxt = logits.argmax(dim=-1)
        if sample is not None:
            temps, tks, tps, gen = sample
            lp = torch.log_softmax(
                _rowwise_filter(_scaled(logits, temps), tks, tps), dim=-1)
            nxt = torch.where(temps > 0, _categorical(lp, gen), nxt)
            dlogp.append(lp)
        tokens = torch.where(dev_active, nxt, tokens)
        drafts.append(nxt)
    return (torch.stack(drafts, dim=1),
            torch.stack(dlogp) if dlogp else None, cache)


def _first_false(ok):
    """Index of the first False of each row of ok [slots, g]; g when all
    are True."""
    pad = ok.new_zeros(ok.shape[0], 1)
    return torch.cat([ok, pad], dim=1).int().argmin(dim=1)


def _emit(drafts, a, new_tok):
    """[slots, g+1]: drafts[:, :a] then new_tok from position a on."""
    g1 = drafts.shape[1] + 1
    padded = torch.cat([drafts, drafts.new_zeros(drafts.shape[0], 1)], dim=1)
    keep = torch.arange(g1, device=drafts.device)[None, :] < a[:, None]
    return torch.where(keep, padded, new_tok[:, None])


@torch.no_grad()
def spec_accept_greedy(tlogits, drafts):
    """Greedy acceptance for every row: keep the longest proposal prefix
    matching the target's argmax, then the target's token at the first
    divergence. tlogits [slots, g+1, V], drafts [slots, g]. Returns (a
    [slots] accepted counts, emit [slots, g+1]: positions >= a[i]+1 in row
    i are padding the caller discards)."""
    greedy = tlogits.argmax(dim=-1)                           # [slots, g+1]
    a = _first_false(drafts == greedy[:, :-1])
    return a, _emit(drafts, a, greedy.gather(1, a[:, None])[:, 0])


@torch.no_grad()
def rowwise_spec_accept(tlogits, drafts, dlogp, temps, top_ks, top_ps,
                        generator):
    """Mixed-traffic acceptance: greedy rows (temps 0) use the exact-prefix
    rule; sampling rows run per-row rejection sampling: token j accepted
    with prob min(1, p_j(x_j)/q_j(x_j)) against the draft's dlogp, the
    first rejection resampled from norm(max(0, p - q)), the bonus token
    from p when all gamma are accepted. dlogp [gamma, slots, V]. Returns
    (a [slots], emit [slots, g+1])."""
    s, g1, v = tlogits.shape
    g = g1 - 1
    a_g, emit_g = spec_accept_greedy(tlogits, drafts)
    # the target's filtered log-probs at every verified position
    tlp = torch.log_softmax(_rowwise_filter(
        _scaled(tlogits, temps), top_ks[:, None], top_ps[:, None]), dim=-1)
    dlp = dlogp.transpose(0, 1)                               # [slots, g, V]
    p_tok = tlp[:, :-1].gather(-1, drafts[..., None])[..., 0]
    q_tok = dlp.gather(-1, drafts[..., None])[..., 0]
    u = torch.rand((s, g), generator=generator, device=tlogits.device)
    a_s = _first_false(u < torch.exp(torch.clamp(p_tok - q_tok, max=0.0)))
    # replacement at the first rejection: sample from the residual
    # norm(max(0, p_a - q_a)); all accepted: the bonus token from p_gamma
    p_a = tlp.gather(1, a_s[:, None, None].expand(s, 1, v))[:, 0].exp()
    q_row = dlp.gather(1, a_s.clamp(max=g - 1)[:, None, None].expand(
        s, 1, v))[:, 0].exp()
    q_a = torch.where((a_s < g)[:, None], q_row, 0.0)
    resid = torch.clamp(p_a - q_a, min=0.0)
    total = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(total > 0, resid / total.clamp_min(1e-38), p_a)
    tok_s = _categorical(torch.log(resid + 1e-38), generator)
    sampling = temps > 0
    a = torch.where(sampling, a_s, a_g)
    emit = torch.where(sampling[:, None], _emit(drafts, a_s, tok_s), emit_g)
    return a, emit


class PrefixTrie:
    """Radix index over the paged block pool: which prompt prefixes are
    block-resident, and in which physical blocks.

    Host-side, owned by the scheduler thread (workloads/serve.py). Keys are
    block-sized token chunks: a node at depth i holds ONE pool block —
    the KV for tokens[i*block:(i+1)*block] of every prompt reaching it —
    so two prompts sharing a 3-block prefix share 3 nodes (and 3 physical
    blocks), diverging only below. The trie does NOT own refcounts: the
    caller shares exactly the blocks `insert` reports as newly indexed
    and frees exactly the blocks `evict_lru`/`clear` return, keeping the
    BlockAllocator ledger the single source of truth.

    Eviction is leaf-only and LRU: an interior block backs every cached
    prefix running through it, so freeing one would orphan its subtree's
    KV; dropping the least-recently-touched leaf always removes the
    coldest *complete* prefix first. The serve loop evicts only when the
    free list runs dry (admission pressure), never on a count bound.
    """

    __slots__ = ("block", "_root", "_clock")

    class _Node:
        __slots__ = ("chunk", "block", "parent", "children", "stamp")

        def __init__(self, chunk, block, parent, stamp):
            self.chunk = chunk
            self.block = block
            self.parent = parent
            self.children = {}
            self.stamp = stamp

    def __init__(self, block: int):
        if block <= 0:
            raise ValueError("PrefixTrie needs a positive block size")
        self.block = block
        self._root = self._Node((), -1, None, 0)
        self._clock = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def __len__(self) -> int:
        """Number of indexed blocks (trie nodes, root excluded)."""
        n = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n

    @property
    def leaf_count(self) -> int:
        """Number of distinct complete prefixes indexed."""
        n = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if not node.children:
                n += 1
            stack.extend(node.children.values())
        return n

    def insert(self, key, blocks) -> list:
        """Index `key`'s complete blocks; returns the block ids NEWLY
        referenced (caller rc++'s exactly those). A level already present
        keeps its existing block — the content is identical by key."""
        n = min(len(key) // self.block, len(blocks))
        node = self._root
        added = []
        stamp = self._tick()
        for i in range(n):
            chunk = tuple(key[i * self.block:(i + 1) * self.block])
            child = node.children.get(chunk)
            if child is None:
                child = self._Node(chunk, blocks[i], node, stamp)
                node.children[chunk] = child
                added.append(blocks[i])
            else:
                child.stamp = stamp
            node = child
        return added

    def lookup(self, key) -> tuple:
        """Longest indexed prefix of `key`: (block ids, matched tokens).
        Touches the matched path so lookups refresh LRU order."""
        node = self._root
        blocks = []
        stamp = self._tick()
        for i in range(len(key) // self.block):
            chunk = tuple(key[i * self.block:(i + 1) * self.block])
            child = node.children.get(chunk)
            if child is None:
                break
            child.stamp = stamp
            blocks.append(child.block)
            node = child
        return blocks, len(blocks) * self.block

    def evict_lru(self) -> list:
        """Drop the least-recently-touched LEAF; returns its block ids
        (empty when the trie is empty). Caller frees them."""
        victim = None
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif victim is None or node.stamp < victim.stamp:
                victim = node
        if victim is None:
            return []
        del victim.parent.children[victim.chunk]
        return [victim.block]

    def clear(self) -> list:
        """Drop everything; returns every indexed block id for freeing."""
        freed = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            freed.append(node.block)
            stack.extend(node.children.values())
        self._root.children.clear()
        return freed

    def iter_leaf_prefixes(self):
        """Token tuples of every complete indexed prefix (for sketch
        builds: hashing a leaf's path covers all its ancestor levels)."""
        out = []
        stack = [(self._root, ())]
        while stack:
            node, prefix = stack.pop()
            if node is not self._root:
                prefix = prefix + node.chunk
                if not node.children:
                    out.append(prefix)
            stack.extend((c, prefix) for c in node.children.values())
        return out
