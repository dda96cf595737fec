"""The training cells' token corpus: documents of varying length as the
launcher's pipeline reads them (one row a document, positions along the
second axis), and the batches the pipeline must serve from them.

Every seed gets the same set of document lengths, in another order, so
the work does not move with the seed; the tokens are drawn anew."""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np


def document_lengths(p: Mapping, seed: int) -> np.ndarray:
    """``n_docs`` lengths spread evenly over [min_len_frac * seq, seq],
    permuted by ``seed``."""
    lo = max(2, int(p["seq"] * p["min_len_frac"]))
    lens = np.linspace(lo, p["seq"], p["n_docs"]).round().astype(np.int64)
    return np.random.default_rng(seed).permutation(lens)


def documents(p: Mapping, vocab: int, seed: int) -> List[np.ndarray]:
    """The corpus: one int64 token array a document, ids in [1, vocab)
    (0 is the pipeline's pad id)."""
    lens = document_lengths(p, seed)
    rng = np.random.default_rng([seed, 1])
    return [rng.integers(1, vocab, size=int(n)) for n in lens]


def file_arrays(docs: List[np.ndarray], n_files: int):
    """The documents as sparse [sample, position] cells (1-based), the
    token in a float32 attribute, dealt round-robin over ``n_files``
    files: a list of (coords (n, 2) int64, attrs (n, 1) float32)."""
    per_file: List[list] = [[] for _ in range(n_files)]
    for s, toks in enumerate(docs):
        pos = np.arange(len(toks))
        coords = np.stack([np.full(len(toks), s + 1), pos + 1], axis=1)
        per_file[s % n_files].append((coords, toks))
    out = []
    for parts in per_file:
        coords = np.concatenate([c for c, _ in parts]).astype(np.int64)
        attrs = np.concatenate([t for _, t in parts]).astype(
            np.float32)[:, None]
        out.append((coords, attrs))
    return out


def batch_rows(step: int, batch: int, n_docs: int) -> range:
    """Documents (0-based) of the ``step``-th batch: epochs of ``n_docs
    // batch`` steps, each epoch's ranges shifted by half a batch per
    epoch, rows past the last document left empty."""
    per_epoch = max(1, n_docs // batch)
    epoch, k = divmod(step, per_epoch)
    start = (k * batch + (epoch * batch) // 2) % n_docs
    return range(start, min(start + batch, n_docs))


def expected_batch(docs: List[np.ndarray], step: int, batch: int,
                   seq: int, pad: int = 0) -> Dict[str, np.ndarray]:
    """The batch the pipeline must serve at ``step``: int32 ``tokens``
    (batch, seq), each row its document's first ``seq`` tokens padded
    with ``pad``, and ``labels``, the next token or -1 where none
    follows."""
    full = np.full((batch, seq + 1), pad, np.int64)
    valid = np.zeros((batch, seq + 1), bool)
    for r, d in enumerate(batch_rows(step, batch, len(docs))):
        toks = docs[d][:seq + 1]
        full[r, :len(toks)] = toks
        valid[r, :len(toks)] = True
    labels = np.where(valid[:, 1:], full[:, 1:], -1)
    return {"tokens": full[:, :-1].astype(np.int32),
            "labels": labels.astype(np.int32)}
