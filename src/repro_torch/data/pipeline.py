"""Deterministic synthetic data pipeline with sequence packing, from the
JAX package's ``data/pipeline.py``: batches are the reference's, bit
for bit, as numpy arrays (the training driver moves them to the card).

Per-host shards, deterministic by (seed, step, host), so a restart
from a checkpoint replays identically and a different host count keeps
the global stream stable.

Packing: variable-length documents are packed into fixed (B, S)
windows; the document offsets AND the document ordinals (the
segment-id base) are both exclusive prefix sums over the same document
stream, computed in one pass with ``core.scan_api.host_fused_exscan``,
the host twin of the collective ``fused_scan``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.scan_api import host_fused_exscan


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    pad_id: int = 0


class SyntheticLM:
    """Markov-ish synthetic token stream: enough structure that CE
    decreases under training, fully deterministic."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        if cfg.global_batch % n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = cfg.global_batch // n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.cfg.seed, step, self.host_id))

    def docs_for_step(self, step: int) -> list[np.ndarray]:
        """Variable-length documents for this host at this step."""
        cfg = self.cfg
        rng = self._rng(step)
        need = self.local_batch * cfg.seq_len
        docs = []
        total = 0
        while total < need * 2:
            n = int(rng.integers(cfg.mean_doc_len // 4,
                                 cfg.mean_doc_len * 2))
            # structured: a random walk over the vocab with momentum
            start = int(rng.integers(1, cfg.vocab))
            stride = int(rng.integers(1, 17))
            doc = (start + stride * np.arange(n)) % (cfg.vocab - 1) + 1
            noise = rng.integers(0, cfg.vocab, n)
            mask = rng.random(n) < 0.05
            doc = np.where(mask, noise, doc)
            docs.append(doc.astype(np.int32))
            total += n
        return docs

    def pack(self, docs: list[np.ndarray]):
        """Pack docs into (local_batch, seq_len) with position reset:
        each document's offset in the flat stream and its ordinal are
        two exscans over the same stream, in one fused pass."""
        cfg = self.cfg
        lengths = np.array([len(d) for d in docs], np.int64)
        offsets, ordinals = host_fused_exscan(
            [lengths, np.ones_like(lengths)])
        need = self.local_batch * cfg.seq_len
        flat = np.zeros(need, np.int32)
        pos = np.zeros(need, np.int32)
        seg = np.zeros(need, np.int32)
        for d, o, ordinal in zip(docs, offsets, ordinals):
            o = int(o)
            if o >= need:
                break
            n = min(len(d), need - o)
            flat[o:o + n] = d[:n]
            pos[o:o + n] = np.arange(n)
            seg[o:o + n] = int(ordinal) + 1
        shape = (self.local_batch, cfg.seq_len)
        return {
            "tokens": flat.reshape(shape),
            "positions": pos.reshape(shape),
            "segments": seg.reshape(shape),
            "labels": flat.reshape(shape),
        }

    def batch(self, step: int, rows: slice | None = None):
        """The batch of ``step``; with ``rows``, only those rows of it:
        a process of a run over processes draws the global batch from the
        seed and keeps its data shard's rows (``models.moe.held_rows``),
        so the processes read the tokens one program would."""
        out = self.pack(self.docs_for_step(step))
        return out if rows is None else {k: v[rows] for k, v in out.items()}


def synthetic_batch(cfg_model, batch: int, seq: int, seed: int = 0):
    """One-shot batch for examples and tests (``Model.loss``'s schema),
    numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg_model.frontend == "audio":
        out["embeds"] = rng.standard_normal(
            (batch, seq, cfg_model.d_model)).astype(np.float32)
        out["labels"] = rng.integers(
            0, cfg_model.vocab, (batch, seq)).astype(np.int32)
        return out
    dc = DataConfig(vocab=cfg_model.vocab, seq_len=seq, global_batch=batch,
                    seed=seed)
    b = SyntheticLM(dc).batch(0)
    out["tokens"] = b["tokens"]
    out["labels"] = b["labels"]
    if cfg_model.frontend == "vision":
        out["prefix"] = rng.standard_normal(
            (batch, cfg_model.n_prefix, cfg_model.d_model)
        ).astype(np.float32)
    return out
