"""Deterministic, resumable synthetic LM data pipeline with async prefetch
(the port's copy of the JAX package's ``data/pipeline.py``: pure numpy, so
the two packages produce the same batches byte for byte).

Determinism contract: batch #i is a pure function of (seed, i) via Philox
counter streams — so the checkpoint stores ONLY the consumption counter and
restart resumes bit-identically on any topology (no data files to reposition).

Prefetch: a producer thread keeps `prefetch` batches ahead; every in-flight
batch is registered as a REQUEST-kind virtual id with the rank's Mana, so the
checkpoint drain protocol (paper §5 category 1) completes/accounts for them
exactly like pending MPI messages."""
from __future__ import annotations

import queue
import threading

import numpy as np


def synth_batch(cfg, batch_size: int, seq_len: int, seed: int, index: int):
    """Pure (seed, index) -> batch. Markov-ish tokens so the loss can fall."""
    rng = np.random.Generator(np.random.Philox(key=[seed, index]))
    V = cfg.vocab_size
    shape = (batch_size, cfg.n_codebooks, seq_len + 1) if cfg.n_codebooks > 1 \
        else (batch_size, seq_len + 1)
    # low-entropy stream: next token correlates with previous (learnable)
    base = rng.integers(0, V, size=shape, dtype=np.int32)
    drift = rng.integers(0, 7, size=shape, dtype=np.int32)
    toks = np.minimum((np.cumsum(drift, axis=-1) + base[..., :1]) % V, V - 1)
    batch = {"tokens": toks[..., :-1].astype(np.int32),
             "targets": toks[..., 1:].astype(np.int32)}
    if cfg.img_tokens:
        pe = rng.standard_normal(
            (batch_size, cfg.img_tokens, 1024)).astype(np.float32)
        batch["patch_embeds"] = pe
    return batch


class DataPipeline:
    def __init__(self, cfg, batch_size: int, seq_len: int, *, seed: int = 17,
                 prefetch: int = 2, mana=None, start_index: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.prefetch = prefetch
        self.mana = mana
        self._next_produce = start_index
        self._next_consume = start_index
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._requests: dict[int, int] = {}   # batch index -> request handle
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        while not self._stop.is_set():
            idx = self._next_produce
            b = synth_batch(self.cfg, self.batch_size, self.seq_len,
                            self.seed, idx)
            if self.mana is not None:
                # a generalized request (MPI_Grequest_start) through the
                # generated wrapper: produced == completed, so the quiesce
                # protocol accounts for it without waiting on it
                self._requests[idx] = self.mana.grequest_start(
                    "prefetch", index=idx, done=True)
            while not self._stop.is_set():
                try:
                    self._q.put((idx, b), timeout=0.2)
                    break
                except queue.Full:
                    continue
            self._next_produce = idx + 1

    def next(self):
        idx, b = self._q.get(timeout=30)
        assert idx == self._next_consume, (idx, self._next_consume)
        self._next_consume = idx + 1
        if self.mana is not None:
            # consumed == waited-on: retire the request vid (MPI_Request_free)
            # so the table the checkpoint snapshots doesn't grow per step
            h = self._requests.pop(idx, None)
            if h is not None:
                self.mana.request_free(h)
        return b

    # -- checkpoint integration ------------------------------------------
    def state(self) -> dict:
        """Everything needed to resume bit-identically: the consume counter.
        (Prefetched-but-unconsumed batches are pure functions of the counter,
        the RECORD_REPLAY strategy for data.)"""
        return {"seed": self.seed, "next_index": self._next_consume,
                "batch_size": self.batch_size, "seq_len": self.seq_len}

    @classmethod
    def resume(cls, cfg, state: dict, *, prefetch: int = 2, mana=None):
        return cls(cfg, state["batch_size"], state["seq_len"],
                   seed=state["seed"], prefetch=prefetch, mana=mana,
                   start_index=state["next_index"])

    def reattach(self, mana) -> dict:
        """Online reshard: move the pipeline onto another rank's Mana after a
        live membership change (the owning rank departed, or a joiner takes
        over a slice).  Stops the producer, drops prefetched-but-unconsumed
        batches (pure functions of the counter — nothing is lost), and
        restarts production from ``_next_consume`` on the new Mana, so the
        determinism contract (batch #i from (seed, i)) survives the move."""
        self.stop()
        cursor = self._next_consume
        self.mana = mana
        self._next_produce = cursor
        self._requests = {}
        self._q = queue.Queue(maxsize=max(self.prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        return {"next_index": cursor}

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
