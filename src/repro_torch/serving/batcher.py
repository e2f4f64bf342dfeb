"""Request batching: pad variable-length prompts into fixed shapes.

A copy of the reference's ``serving/batcher.py``.  Two consumers:

* :class:`Batcher` — the drain path: accumulate ``batch_size`` requests and
  emit one fixed (B, bucket) batch for ``HIEngine.serve``.
* :class:`AdmissionQueue` — the continuous path: requests are bucketized
  (and, for prefix sharing, chain-hashed per page) on submit and handed to
  the scheduler one at a time as decode slots free up
  (``HIEngine.serve_stream``).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0            # <= 0 -> greedy (the only mode ported)
    eos_id: Optional[int] = None        # early stop (continuous path only)
    latency_budget: Optional[float] = None  # seconds; expired S->L escalations
    #                                       are dropped (the S answer stands)
    tclass: str = ""                    # traffic class (read by the gate
    #                                   audit, which is not ported yet)


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


@dataclass
class AdmittedRequest:
    """One request, bucketized and ready for a decode slot.

    ``page_hashes`` / ``full_hash`` are the prompt's content addresses in the
    KV pool's prefix index, computed once at submit and reused by every tier
    the request visits, the S->L escalation replay included."""
    request: Request
    tokens: np.ndarray                  # (bucket,) right-padded to its bucket
    bucket: int                         # padded prompt length (= prefill pos)
    page_hashes: Optional[Tuple[bytes, ...]] = None  # rolling chain, per page
    full_hash: Optional[bytes] = None   # chain extended over the partial tail
    submit_time: float = 0.0            # monotonic; drives the drop policy
    admit_retries: int = 0              # fruitless admission ticks so far; the
    #                                     scheduler rejects the request past
    #                                     RetryPolicy.admit_retry_limit (reset
    #                                     when the escalation enters L-tier
    #                                     admission)


def _chain(prev: bytes, chunk: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(np.ascontiguousarray(chunk, np.int32).tobytes())
    return h.digest()


def prompt_hashes(tokens: np.ndarray, page_size: int
                  ) -> Tuple[Tuple[bytes, ...], bytes]:
    """Rolling chain hash of a padded prompt at page granularity.

    ``h_i = H(h_{i-1} || tokens[i*page:(i+1)*page])`` keys the whole prefix
    ending at page i, so a flat hash->page dict behaves as a prefix trie.
    The full-prompt key extends the chain over the partial tail page (or a
    length-domain separator when the prompt is page-aligned, so it never
    collides with a page key)."""
    n_full = len(tokens) // page_size
    prev = b"hi-prefix-v1"
    hashes = []
    for i in range(n_full):
        prev = _chain(prev, tokens[i * page_size:(i + 1) * page_size])
        hashes.append(prev)
    tail = tokens[n_full * page_size:]
    full = _chain(prev, tail if len(tail) else np.asarray([-1], np.int32))
    return tuple(hashes), full


class AdmissionQueue:
    """FIFO admission queue for the continuous scheduler.

    Requests are validated and bucketized at ``submit`` with the drain
    path's ``pad_to_bucket`` ladder, so both paths see identical padded
    prompts.  With ``page_size`` set, submit also chain-hashes the padded
    prompt for the pool's prefix index."""

    def __init__(self, buckets: Sequence[int] = (32, 64, 128),
                 pad_id: int = 0, page_size: Optional[int] = None):
        self.buckets = tuple(sorted(buckets))
        self.pad_id = pad_id
        self.page_size = page_size
        self._queue: List[AdmittedRequest] = []
        self.submitted = 0

    def submit(self, req: Request) -> None:
        bucket = pad_to_bucket(len(req.prompt), self.buckets)   # raises if too long
        tokens = np.full((bucket,), self.pad_id, np.int32)
        tokens[: len(req.prompt)] = req.prompt
        hashes = full = None
        if self.page_size:
            hashes, full = prompt_hashes(tokens, self.page_size)
        self._queue.append(AdmittedRequest(req, tokens, bucket, hashes, full,
                                           time.monotonic()))
        self.submitted += 1

    def pop(self) -> Optional[AdmittedRequest]:
        return self._queue.pop(0) if self._queue else None

    def push_front(self, adm: AdmittedRequest) -> None:
        """Put a popped request back at the head (admission retry)."""
        self._queue.insert(0, adm)

    # deque-compatible aliases: the scheduler treats the S-tier admission
    # queue and the L-tier escalation deque through one head-pop interface
    popleft = pop
    appendleft = push_front

    def __len__(self) -> int:
        return len(self._queue)
