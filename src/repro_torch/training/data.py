"""Synthetic token pipeline — the port's copy of
``repro.training.data``: the same numpy stream from the same seed, so its
batches are the reference's bit for bit (an encoder's frames and random
labels and a VLM's image embeddings included).  Batches are numpy; the
training loop moves them to its device."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_batches(mcfg, batch: int, seq_len: int,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-ish synthetic LM data: structured enough that loss decreases."""
    rng = np.random.default_rng(seed)
    V = mcfg.vocab_size
    # fixed random bigram preference table (sparse structure to learn)
    nxt = rng.integers(0, V, size=(V,))
    while True:
        toks = np.empty((batch, seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, size=batch)
        noise = rng.random((batch, seq_len)) < 0.15
        rand = rng.integers(0, V, size=(batch, seq_len))
        for t in range(seq_len):
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt[toks[:, t]])
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if mcfg.arch_type == "encoder":
            out["frames"] = rng.standard_normal(
                (batch, seq_len, mcfg.d_model)).astype(np.float32)
            out["labels"] = rng.integers(0, V, (batch, seq_len)).astype(np.int32)
        if mcfg.arch_type == "vlm":
            out["image_embeds"] = rng.standard_normal(
                (batch, mcfg.num_image_tokens, mcfg.d_model)).astype(np.float32)
        yield out
