"""Deterministic synthetic data pipelines (LM tokens / speech / images).

Per-host sharding: each host generates only its shard of the global batch from
a (seed, step, host) counter — no host ever materializes the global batch, no
inter-host data traffic, and restarts are reproducible from the step number
alone (checkpoint stores just ``step``). Numpy only: the JAX package keeps
the same file, so both packages draw the same batches from the same seed.

Content is a mixture of Zipf-distributed tokens with injected n-gram structure
so losses are non-degenerate (a pure-uniform stream gives no learnable signal
for the examples).
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int, host: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, host]))


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    """Zipf tokens + copied spans (gives in-context signal to learn)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq), p=probs).astype(np.int32)
    # inject copy structure: second half repeats a window of the first half
    if seq >= 8:
        w = seq // 4
        src = toks[:, :w]
        toks[:, seq // 2:seq // 2 + w] = src
    return {"tokens": toks}


def synthetic_cnn_batch(rng: np.random.Generator, batch: int, image: int,
                        channels: int, n_classes: int):
    """Class-conditional Gaussian blobs (linearly separable => loss decreases)."""
    labels = rng.integers(0, n_classes, size=(batch,)).astype(np.int32)
    base = rng.standard_normal((batch, image, image, channels)).astype(np.float32)
    # class signature pattern
    sig = np.zeros_like(base)
    xs = np.linspace(0, 2 * np.pi, image)
    for i, lbl in enumerate(labels):
        freq = 1 + (lbl % 7)
        sig[i, :, :, 0] = np.outer(np.sin(freq * xs), np.cos(freq * xs))
    return {"images": base * 0.3 + sig, "labels": labels}


def lm_batches(seed: int, batch: int, seq: int, vocab: int, *, host: int = 0,
               n_hosts: int = 1, start_step: int = 0):
    """Infinite iterator over this host's shard of the global LM batch."""
    assert batch % n_hosts == 0
    local = batch // n_hosts
    step = start_step
    while True:
        yield synthetic_lm_batch(_rng(seed, step, host), local, seq, vocab)
        step += 1


def cnn_batches(seed: int, batch: int, image: int, channels: int, n_classes: int,
                *, host: int = 0, n_hosts: int = 1, start_step: int = 0):
    assert batch % n_hosts == 0
    local = batch // n_hosts
    step = start_step
    while True:
        yield synthetic_cnn_batch(_rng(seed, step, host), local, image, channels, n_classes)
        step += 1


def make_batch(cfg, shape, *, seed: int = 0, step: int = 0, np_rng=None):
    """One global batch matching input_specs(cfg, shape) (for runtime tests)."""
    rng = np_rng or _rng(seed, step)
    if cfg.family == "cnn":
        return synthetic_cnn_batch(rng, shape.global_batch, cfg.image_size,
                                   cfg.in_channels, cfg.n_classes)
    b = synthetic_lm_batch(rng, shape.global_batch, shape.seq_len, cfg.vocab_size)
    if cfg.family == "vlm":
        b["image_embed"] = rng.standard_normal(
            (shape.global_batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.family == "encdec":
        b["audio_embed"] = rng.standard_normal(
            (shape.global_batch, cfg.n_audio_frames, cfg.d_model)).astype(np.float32) * 0.02
    return b
