"""KV prefix-affinity primitives, the port's own copy of
gpu_docker_api_tpu/kvaffinity.py (stdlib only).

A replica summarizes the prompt prefixes its paged pool holds (the prefix
trie of workloads/serve.py) into a fixed-size Bloom sketch, advertised on
every response as X-TDAPI-KV-Sketch; routers score candidate replicas by
how many prompt tokens the sketch says are already resident. A gateway
scores JAX and PyTorch replicas with one decoder, so every function here
must give the JAX module's bits: the same FNV-1a hashes, the same sketch
words and the same hex.

Prefixes are summarized at a fixed CHUNK_TOKENS granularity that is
independent of the replica's kv_block size: the router hashes the incoming
prompt the same way without knowing any replica's block geometry. One
64-bit FNV-1a hash per prefix *level* — hash i covers
tokens[0 : (i+1) * CHUNK_TOKENS] — computed incrementally so hashing a
prompt is one pass. A level's hash sets 2 bits in the SKETCH_WORDS * 64
bit Bloom filter; a hit is the longest run of consecutive levels present
(a deeper level without its ancestors is a false positive by
construction, so the run must be consecutive).

Scoring: candidates sort by `queue_depth * W_QUEUE - hit_tokens`
ascending. W_QUEUE is large enough that one unit of queue depth always
outweighs the deepest possible sketch hit, so affinity only breaks ties
and steers between near-equal queues; with no sketch match anywhere the
ordering is exactly least-queued.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

#: tokens per prefix level — the granularity both sides hash at
CHUNK_TOKENS = 32
#: deepest advertised prefix = MAX_LEVELS * CHUNK_TOKENS tokens
MAX_LEVELS = 8
#: 64-bit words in the Bloom sketch (SKETCH_WORDS * 64 bits total)
SKETCH_WORDS = 4

_SKETCH_BITS = SKETCH_WORDS * 64
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1

#: one queue-depth unit outweighs the deepest possible hit
#: (MAX_LEVELS * CHUNK_TOKENS = 256 tokens), so scoring strictly refines
#: least-queued order instead of overriding it
W_QUEUE = MAX_LEVELS * CHUNK_TOKENS + 1


def _fnv_step(h: int, token: int) -> int:
    t = int(token) & 0xFFFFFFFF
    for shift in (0, 8, 16, 24):
        h ^= (t >> shift) & 0xFF
        h = (h * _FNV_PRIME) & _MASK64
    return h


def extend_hash(h: int, tokens: Sequence[int]) -> int:
    """Fold `tokens` into a running FNV-1a state (incremental chunking)."""
    for t in tokens:
        h = _fnv_step(h, t)
    return h


def chunk_hashes(tokens: Sequence[int],
                 chunk: int = CHUNK_TOKENS,
                 levels: int = MAX_LEVELS) -> list[int]:
    """One hash per complete prefix level of `tokens`.

    hashes[i] covers tokens[0:(i+1)*chunk]; partial trailing chunks are
    not hashed (they can't be block-resident on any replica anyway).
    """
    out: list[int] = []
    h = _FNV_OFFSET
    n_levels = min(len(tokens) // chunk, levels)
    for lvl in range(n_levels):
        h = extend_hash(h, tokens[lvl * chunk:(lvl + 1) * chunk])
        out.append(h)
    return out


def _bit_positions(h: int) -> tuple[int, int]:
    # two independent probes from one 64-bit hash (upper bits reshuffled)
    return h % _SKETCH_BITS, ((h >> 17) ^ (h >> 43)) % _SKETCH_BITS


def sketch_add(words: list[int], h: int) -> None:
    """Set `h`'s bits in the sketch (words mutated in place)."""
    for bit in _bit_positions(h):
        words[bit // 64] |= 1 << (bit % 64)


def sketch_test(words: Sequence[int], h: int) -> bool:
    for bit in _bit_positions(h):
        if not (words[bit // 64] >> (bit % 64)) & 1:
            return False
    return True


def build_sketch(hashes: Iterable[int]) -> list[int]:
    words = [0] * SKETCH_WORDS
    for h in hashes:
        sketch_add(words, h)
    return words


def hit_tokens(words: Optional[Sequence[int]], hashes: Sequence[int],
               chunk: int = CHUNK_TOKENS) -> int:
    """Longest consecutive run of prefix levels present, in tokens."""
    if not words or not hashes:
        return 0
    depth = 0
    for h in hashes:
        if not sketch_test(words, h):
            break
        depth += 1
    return depth * chunk


def score(hit: int, queue_depth: int) -> int:
    """Sort key — LOWER is better (matches least-queued's ascending sort)."""
    return queue_depth * W_QUEUE - hit


def encode_sketch_hex(words: Sequence[int]) -> str:
    """Fixed-width hex for the X-TDAPI-KV-Sketch header (16 chars/word)."""
    return "".join(f"{w & _MASK64:016x}" for w in words)


def decode_sketch_hex(text: str) -> Optional[list[int]]:
    """Inverse of encode_sketch_hex; None on any malformed input."""
    if not text or len(text) != SKETCH_WORDS * 16:
        return None
    try:
        return [int(text[i * 16:(i + 1) * 16], 16)
                for i in range(SKETCH_WORDS)]
    except ValueError:
        return None


def signed64(w: int) -> int:
    """Reinterpret an unsigned sketch word as int64 for a c_int64 shm cell."""
    w &= _MASK64
    return w - (1 << 64) if w >= (1 << 63) else w
