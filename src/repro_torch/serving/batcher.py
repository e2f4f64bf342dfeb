"""Request batching for the drained path: pad variable-length prompts into
fixed (batch, bucket) shapes.

A copy of the reference's ``serving/batcher.py`` drain-path part
(``Request``, ``Batch``, ``pad_to_bucket``, ``Batcher``, FIFO only); the
continuous path's ``AdmissionQueue`` and the request fields it reads join
with the scheduler.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int = 16


@dataclass
class Batch:
    tokens: np.ndarray                   # (B, S) right-padded
    lengths: np.ndarray                  # (B,)
    request_ids: np.ndarray              # (B,) -1 = padding slot
    max_new_tokens: int

    @property
    def bucket(self) -> int:
        """The padded sequence length; with the batch size it keys the
        engine's cache buffers."""
        return self.tokens.shape[1]


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n.  A prompt longer than every bucket is an
    error: clamping would truncate the prompt and serve a corrupted
    request."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"prompt length {n} exceeds the largest bucket {max(buckets)}; "
        f"raise the bucket ladder or split the prompt")


class Batcher:
    """Accumulate requests; emit fixed (batch_size, bucket) batches in
    submission order.  Empty rows of a short batch carry the pad prompt."""

    def __init__(self, batch_size: int, buckets: Sequence[int] = (32, 64, 128),
                 pad_id: int = 0):
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.pad_id = pad_id
        self.queue: List[Request] = []

    def submit(self, req: Request) -> None:
        if len(req.prompt) > self.buckets[-1]:
            raise ValueError(
                f"request {req.request_id}: prompt length {len(req.prompt)} "
                f"exceeds the largest bucket {self.buckets[-1]}")
        self.queue.append(req)

    def next_batch(self) -> Optional[Batch]:
        if not self.queue:
            return None
        take = self.queue[: self.batch_size]
        self.queue = self.queue[self.batch_size:]
        bucket = pad_to_bucket(max(len(r.prompt) for r in take), self.buckets)
        tokens = np.full((self.batch_size, bucket), self.pad_id, np.int32)
        lengths = np.zeros((self.batch_size,), np.int32)
        rids = np.full((self.batch_size,), -1, np.int32)
        for i, r in enumerate(take):
            tokens[i, : len(r.prompt)] = r.prompt
            lengths[i] = len(r.prompt)
            rids[i] = r.request_id
        return Batch(tokens, lengths, rids,
                     max(r.max_new_tokens for r in take))
