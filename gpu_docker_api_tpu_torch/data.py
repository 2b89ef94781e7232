"""Training data: memory-mapped token files + device prefetch.

The port's own copy of gpu_docker_api_tpu/data.py (numpy only), so both
runtimes draw the same batches from the same (seed, step):

- **Zero-copy host reads**: token corpora are flat binary files of uint16
  (vocab < 65536) or uint32 token ids (the nanoGPT/llm.c convention —
  `np.memmap` serves random [B, S] crops without loading the file).
- **Deterministic + resumable**: batch i of a run is a pure function of
  (seed, step) — resuming from step N replays exactly the batches N, N+1,
  ... with no iterator state to checkpoint.
- **Per-process streams**: each process draws from a disjoint stream
  (seed folded with process_id); the port runs one process for now.
- **Prefetch**: a background thread prepares the NEXT batch (crop, pinned
  host copy) while the current step runs. The non-blocking device copy
  (`to_device`) is issued on the device's default stream, the one the step
  runs on, so it waits for the running step: only the host-side work
  overlaps compute.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def _fold_seed(seed: int, process_id: int) -> int:
    """Disjoint per-process streams; same (seed, step) -> same batch.
    Wrapped mod 2^64 so any Python int (negative --seed included) works."""
    return (seed * 1_000_003 + process_id) % (1 << 64)


class TokenFileDataset:
    """Random [batch, seq] crops from a flat binary token file.

    dtype is inferred from the filename (.u16/.u32 suffix) or the `dtype`
    argument; default uint16. Crops are drawn at uniform random offsets —
    the standard LM training regime (epoch-less, no shuffling state).
    """

    def __init__(self, path: str, batch: int, seq: int,
                 dtype: Optional[np.dtype] = None, seed: int = 0,
                 process_id: int = 0, vocab_size: int = 0):
        if dtype is None:
            dtype = np.uint32 if path.endswith(".u32") else np.uint16
        self.path = path
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        if len(self.tokens) < seq + 1:
            raise ValueError(
                f"{path}: {len(self.tokens)} tokens < seq {seq} + 1")
        self.batch = batch
        self.seq = seq
        self.vocab_size = vocab_size
        self.seed = _fold_seed(seed, process_id)

    @property
    def n_tokens(self) -> int:
        return int(len(self.tokens))

    def batch_at(self, step: int) -> np.ndarray:
        """The deterministic batch for a step: [batch, seq] int32."""
        rng = np.random.default_rng((int(self.seed), int(step)))
        # inclusive last start is len - seq (the crop ending on the final
        # token); integers() has an exclusive high
        starts = rng.integers(0, len(self.tokens) - self.seq + 1,
                              size=self.batch)
        out = np.empty((self.batch, self.seq), np.int32)
        for i, s in enumerate(starts):
            out[i] = self.tokens[s:s + self.seq]
        if self.vocab_size and out.max() >= self.vocab_size:
            # a corpus tokenized for a bigger vocab is refused here, on the
            # host, before an out-of-range embedding index reaches the card
            raise ValueError(
                f"{self.path}: token id {int(out.max())} >= model vocab "
                f"{self.vocab_size} — wrong tokenizer for this config?")
        return out

    def iter_from(self, step: int) -> Iterator[np.ndarray]:
        while True:
            yield self.batch_at(step)
            step += 1


class SyntheticDataset:
    """Uniform random tokens — the no-data smoke/benchmark regime (what the
    training workload used inline before). Same (seed, step) determinism
    and API as TokenFileDataset."""

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 process_id: int = 0):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = _fold_seed(seed, process_id)

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((int(self.seed), int(step)))
        return rng.integers(0, self.vocab_size,
                            size=(self.batch, self.seq)).astype(np.int32)

    def iter_from(self, step: int) -> Iterator[np.ndarray]:
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Stage batches onto the device ahead of the training loop.

    place(np_batch) -> device tensor runs in a background thread (it calls
    Trainer.shard_batch, i.e. to_device); `depth` batches are in flight, so
    the host-side preparation of step N+1 overlaps the compute of step N
    (the device copy itself queues behind step N on the default stream).
    Iterate, or call next(); close() (or exhaustion) joins the thread.
    """

    _DONE = object()

    def __init__(self, it: Iterator[np.ndarray], place: Callable,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()

        self._error: Optional[BaseException] = None

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(place(item))
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                self._error = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._error is not None:
                raise self._error   # the producer's real failure, not a
                                    # bare StopIteration masking it
            raise StopIteration
        return item

    def close(self):
        import time as _time
        self._stop.set()
        # keep draining until the producer's DONE sentinel: each get frees
        # a producer blocked on a full queue so it can observe _stop, and
        # its final put(_DONE) always finds room eventually
        deadline = _time.time() + 5
        while _time.time() < deadline:
            try:
                if self._q.get(timeout=0.1) is self._DONE:
                    break
            except queue.Empty:
                if not self._thread.is_alive():
                    break
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            import warnings
            warnings.warn(
                "Prefetcher.close(): producer still running after 5s "
                "(a slow in-flight host->device transfer?) — abandoned as "
                "a daemon thread", RuntimeWarning, stacklevel=2)


def to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch as an int64 tensor on `device`. To a CUDA device it goes
    through pinned host memory with a non-blocking copy on the current
    stream, which orders it before the step that reads it."""
    t = torch.from_numpy(np.ascontiguousarray(batch)).long()
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def make_dataset(path: str, vocab_size: int, batch: int, seq: int,
                 seed: int = 0, process_id: int = 0):
    """`path` empty -> synthetic; else a token file (must exist). Token
    files are validated batch-by-batch against vocab_size."""
    if not path:
        return SyntheticDataset(vocab_size, batch, seq, seed=seed,
                                process_id=process_id)
    if not os.path.exists(path):
        raise FileNotFoundError(f"token file {path} not found")
    return TokenFileDataset(path, batch, seq, seed=seed,
                            process_id=process_id, vocab_size=vocab_size)
