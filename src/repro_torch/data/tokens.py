"""Synthetic LM data pipeline with deterministic sharding + prefetch: the
port of `repro.data.tokens`.

A Zipf-distributed Markov token stream (enough structure that a small
model's loss visibly drops within a few hundred steps). Deterministic per
(seed, step): a restarted job regenerates exactly the same global batch.
The generator is the reference's numpy code, copied so that the port
imports nothing of the JAX package, and the batches equal the reference's
for every (seed, step): int32 tensors on the host.

One addition: the reference's stream holds tokens only, so a family whose
stub frontend needs more (paligemma's image embeddings, seamless's audio
frames) cannot train on it there. `stub_inputs` draws such inputs, named
with each example's shape (`models.model_zoo.stub_shapes`), as float32
normals from a generator of their own, seeded with (seed, step, 1), so
the tokens stay the reference's.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    markov_order: int = 1
    n_states: int = 64


class SyntheticTokens:
    """Markov-chain token source: state s → Zipf over a state-specific slice."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # state transition matrix + per-state vocab offset
        self.trans = rng.dirichlet(np.ones(cfg.n_states) * 0.3, size=cfg.n_states)
        self.offsets = rng.integers(0, max(cfg.vocab - 256, 1), cfg.n_states)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        states = rng.integers(0, cfg.n_states, b)
        toks = np.zeros((b, s + 1), np.int64)
        # vectorized over batch, sequential over time (cheap at test scales)
        zipf_cache = rng.zipf(cfg.zipf_a, size=(b, s + 1)) % 256
        for t in range(s + 1):
            toks[:, t] = (self.offsets[states] + zipf_cache[:, t]) % cfg.vocab
            u = rng.random(b)
            cum = np.cumsum(self.trans[states], axis=1)
            states = (cum < u[:, None]).sum(1).clip(0, cfg.n_states - 1)
        return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
                "targets": torch.from_numpy(toks[:, 1:].astype(np.int32))}


def stub_inputs(cfg: DataConfig, step: int,
                shapes: Mapping[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    """Step `step`'s stub frontend inputs: for each name in `shapes`, float32
    normals of shape (global_batch, *shape), seeded with (seed, step, 1)."""
    rng = np.random.default_rng((cfg.seed, step, 1))
    return {name: torch.from_numpy(
                rng.normal(size=(cfg.global_batch,) + tuple(shape)).astype(np.float32))
            for name, shape in shapes.items()}


class PrefetchLoader:
    """Background-thread prefetch (double buffered) over a batch source."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0, depth: int = 2):
        self.source = source
        self.step = start_step
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
