"""Deterministic synthetic token pipeline.

Seeded, shardable, restart-safe: batch ``i`` is a pure function of
(seed, i), so resuming from a checkpoint at step k replays the exact
stream without any state files.  A lightweight mixture (zipf unigram +
repeated n-gram motifs) gives the loss curve some structure to descend.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 enc_frames: int = 0, d_model: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.enc_frames, self.d_model = enc_frames, d_model

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        zipf = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (zipf % (self.vocab - 2)) + 1
        # inject repeated motifs so the model has learnable structure
        motif = (np.arange(8) * 7 + 11) % (self.vocab - 2) + 1
        pos = rng.integers(0, self.seq - 8, size=(self.batch,))
        for b in range(min(self.batch, 64)):
            toks[b, pos[b]:pos[b] + 8] = motif
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if self.enc_frames:
            out["enc_inputs"] = rng.standard_normal(
                (self.batch, self.enc_frames, self.d_model)).astype(
                np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
