"""Token data pipeline: deterministic, shard-aware, resumable — a copy of
the reference package's ``data/pipeline.py`` (numpy only; ``batch_at``
gives the same bytes).

Every batch is a pure function of (seed, step), so a restarted job resumes
mid-epoch with no data-order drift — the property the fault-tolerance layer
(runtime/fault.py) relies on.  Sources: a synthetic Zipf stream (default),
or a memory-mapped token file.  A background prefetch thread keeps
``prefetch`` batches ready so host-side generation overlaps device compute.
"""
from __future__ import annotations

import dataclasses
import pathlib
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"           # synthetic | file
    path: str | None = None
    zipf_a: float = 1.2
    prefetch: int = 2


class TokenPipeline:
    """Deterministic batches of (tokens, labels), step-indexed."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._tokens = None
        if cfg.source == "file":
            assert cfg.path, "file source needs a path"
            self._tokens = np.memmap(pathlib.Path(cfg.path), dtype=np.int32,
                                     mode="r")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The batch for ``step`` — pure, so restart-safe."""
        c = self.cfg
        n = c.global_batch * (c.seq_len + 1)
        if self._tokens is not None:
            start = (step * n) % max(len(self._tokens) - n, 1)
            flat = np.asarray(self._tokens[start:start + n], np.int32)
        else:
            rng = np.random.default_rng((c.seed, step))
            flat = rng.zipf(c.zipf_a, size=n).astype(np.int32) % c.vocab
        flat = flat.reshape(c.global_batch, c.seq_len + 1)
        return {"tokens": flat[:, :-1].copy(), "labels": flat[:, 1:].copy()}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start_step: int) -> Iterator[dict[str, np.ndarray]]:
        """Prefetching iterator resuming at ``start_step``."""
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def write_token_file(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(path)
