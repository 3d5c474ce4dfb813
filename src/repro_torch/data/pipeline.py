"""Data pipeline with CAPre-style background prefetch.

The training data stream is the third "persistent store" in the system
(after parameters and KV caches).  Access to it is *perfectly* predictable
— batch t+1 follows batch t — so, exactly like the paper's generated
prefetch methods, a background producer keeps a bounded queue of
ready-to-consume batches ahead of the train loop, overlapping host-side
batch assembly (and in real deployments, storage reads) with device
compute.  Determinism: batch content is a pure function of (seed, step), so
elastic restarts resume the stream exactly (the step index is in the
checkpoint).

A copy of ``repro.data.pipeline`` (the port imports nothing of the JAX
package): batches are numpy arrays, and the trainer moves them to its
device.  The same (seed, step) gives the same batch in both packages.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLMSource:
    """Deterministic synthetic token stream: batch = f(seed, step).

    Serves as the corpus stand-in; swap for a real tokenized shard reader
    behind the same (seed, step) -> batch interface."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                 embeds_dim: int = 0, frames: int = 0, mrope: bool = False,
                 active_vocab: int = 512):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.embeds_dim = embeds_dim
        self.frames = frames
        self.mrope = mrope
        self.active_vocab = min(vocab_size, active_vocab) if active_vocab else vocab_size

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.batch, self.seq_len
        # learnable structure (uniform-random tokens would already sit at the
        # ln(V) CE optimum): a noisy affine Markov chain over an active
        # sub-vocabulary.  Restricting the chain to ``active_vocab`` tokens
        # keeps short smoke runs learnable — the model first discovers the
        # support (ln(V) -> ln(A) within a few steps), then the transitions;
        # a chain over all 32k tokens is a permutation table no small token
        # budget can memorize, so the loss never moves.
        V = self.active_vocab
        tokens = np.empty((B, S + 1), np.int32)
        tokens[:, 0] = rng.integers(0, V, size=B)
        noise = rng.random(size=(B, S)) < 0.15
        noise_tok = rng.integers(0, V, size=(B, S), dtype=np.int64)
        for t in range(S):
            nxt = (tokens[:, t].astype(np.int64) * 31 + 17) % V
            tokens[:, t + 1] = np.where(noise[:, t], noise_tok[:, t], nxt).astype(np.int32)
        out = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
        if self.embeds_dim:
            out["embeds"] = rng.normal(0, 0.02, size=(B, S, self.embeds_dim)).astype(np.float32)
            if self.mrope:
                pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
                out["positions"] = np.broadcast_to(pos[None], (3, B, S)).copy()
        if self.frames:
            out["frames"] = rng.normal(0, 0.02, size=(B, self.frames, self.embeds_dim or 64)).astype(np.float32)
        return out


class DataPipeline:
    """Bounded-queue background prefetcher over a (seed, step)-addressable
    source."""

    def __init__(self, source, start_step: int = 0, prefetch: int = 2,
                 transform=None):
        self.source = source
        self.prefetch = prefetch
        self.transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._step = start_step
        self._produced = 0
        self._thread = threading.Thread(target=self._produce, daemon=True, name="data-prefetch")
        self._thread.start()

    def _produce(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            if self.transform is not None:
                batch = self.transform(batch)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1
            self._produced += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        if self._stop.is_set():
            raise StopIteration
        return self._q.get()

    @property
    def produced(self) -> int:
        return self._produced

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
