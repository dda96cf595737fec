"""Training input pipeline over the paper's distributed raw-array cache.

The corpus is a sparse 2-D array ``tokens[sample, position]`` stored in raw
(CSV/FITS-like/HDF5-like) files spread across pod hosts — unorganized, as in
the paper's setting. Every training step issues a subarray query
``[sample_lo..sample_hi] x [0..seq]``; the cache coordinator runs the full
stack on it (evolving R-tree chunking -> Alg. 2 eviction -> Alg. 3
placement), so repeated epochs hit the distributed cache instead of
re-scanning raw shards. The pipeline is deterministic given
``(epoch, step)`` — its state rides in the training checkpoint, giving
bit-exact resume after failures.

The port of ``repro/data/pipeline.py`` over the port's ``arrayio`` and
``core``: batches are numpy arrays, equal bit for bit to the
reference's; the trainer moves them to its device. A pipeline's
``telemetry`` is its cluster's too: ``pipeline.next_batch`` spans hold
the cluster's ``query`` spans, then ``pipeline.assemble``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.arrayio.catalog import Catalog, FileReader, build_catalog
from repro_torch.arrayio.generator import GeneratedFile
from repro_torch.core.cluster import RawArrayCluster
from repro_torch.core.coordinator import SimilarityJoinQuery
from repro_torch.core.geometry import Box, points_in_box
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry


def make_token_corpus(n_samples: int, max_len: int, vocab: int,
                      n_files: int, seed: int = 0,
                      min_len_frac: float = 0.3):
    """Variable-length documents as a sparse [sample, position] array;
    round-robin rows across files (files overlap in sample ranges the same
    way PTF nights overlap the sky)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(2, int(max_len * min_len_frac)), max_len + 1,
                        size=n_samples)
    per_file = [[] for _ in range(n_files)]
    for s in range(n_samples):
        toks = rng.integers(1, vocab, size=lens[s])
        pos = np.arange(lens[s])
        rows = np.stack([np.full(lens[s], s + 1), pos + 1], axis=1)
        per_file[s % n_files].append((rows, toks))
    files = []
    for chunks in per_file:
        coords = np.concatenate([c for c, _ in chunks]).astype(np.int64)
        attrs = np.concatenate([t for _, t in chunks]
                               ).astype(np.float32)[:, None]
        lo, hi = coords.min(0), coords.max(0)
        files.append(GeneratedFile(coords, attrs,
                                   Box(tuple(map(int, lo)),
                                       tuple(map(int, hi)))))
    return files, lens


@dataclasses.dataclass
class PipelineStats:
    """Per-pipeline counters: steps served, raw bytes and files scanned,
    and steps that scanned nothing (answered from the cache)."""
    steps: int = 0
    bytes_scanned: int = 0
    files_scanned: int = 0
    cache_hit_steps: int = 0


class RawArrayTokenPipeline:
    """Batch iterator over a raw-array corpus through the caching stack."""

    def __init__(self, catalog: Catalog, reader: FileReader, *,
                 n_hosts: int, host_budget_bytes: int, batch: int,
                 seq: int, policy: str = "cost", min_cells: int = 2048,
                 pad_id: int = 0, telemetry: Telemetry = NULL_TELEMETRY):
        # The reference's cluster defaults: plan and read on the host,
        # execute no join (the port's cluster defaults to the card).
        self.cluster = RawArrayCluster(
            catalog, reader, n_hosts, host_budget_bytes, policy=policy,
            min_cells=min_cells, execute_joins=False, backend="simulated",
            join_backend="numpy", telemetry=telemetry)
        self.telemetry = telemetry
        self.reader = reader
        self.batch = batch
        self.seq = seq
        self.pad_id = pad_id
        self.n_samples = catalog.domain.hi[0]
        self.epoch = 0
        self.step_in_epoch = 0
        self.steps_per_epoch = max(1, self.n_samples // batch)
        self.stats = PipelineStats()

    # ------------------------------------------------------------- state --

    def state(self) -> Dict[str, int]:
        """The resumable position: epoch and step within it."""
        return {"epoch": self.epoch, "step_in_epoch": self.step_in_epoch}

    def set_state(self, state: Dict[str, int]) -> None:
        """Resume from :meth:`state`'s output."""
        self.epoch = int(state["epoch"])
        self.step_in_epoch = int(state["step_in_epoch"])

    # ------------------------------------------------------------ batches --

    def _sample_range(self) -> Tuple[int, int]:
        # Deterministic epoch-strided order (shift per epoch so chunk reuse
        # across epochs is partial, like PTF-2's shifted ranges).
        start = (self.step_in_epoch * self.batch +
                 (self.epoch * self.batch) // 2) % self.n_samples
        return start + 1, min(start + self.batch, self.n_samples) + 1

    def next_batch(self) -> Dict[str, np.ndarray]:
        """The next batch: one subarray query through the cluster, then
        the queried chunks' cells scattered into (batch, seq + 1)
        tokens; returns int32 ``tokens`` and next-token ``labels`` (-1
        where no token follows)."""
        tracer = self.telemetry.tracer
        with tracer.span("pipeline.next_batch"):
            s_lo, s_hi = self._sample_range()
            qbox = Box((s_lo, 1), (s_hi - 1, self.seq + 1))
            ex = self.cluster.run_query(SimilarityJoinQuery(qbox, eps=1))
            rep = ex.report
            self.stats.steps += 1
            scanned = sum(rep.scan_bytes_by_node.values())
            self.stats.bytes_scanned += scanned
            self.stats.files_scanned += len(rep.files_scanned)
            if scanned == 0:
                self.stats.cache_hit_steps += 1
            with tracer.span("pipeline.assemble"):
                return self._assemble(rep, qbox, s_lo)

    def _assemble(self, rep, qbox: Box, s_lo: int) -> Dict[str, np.ndarray]:
        """The queried chunks' cells of ``qbox`` scattered into the batch
        (rows from sample ``s_lo``), and the pipeline's position
        advanced."""
        out = np.full((self.batch, self.seq + 1), self.pad_id, np.int64)
        valid = np.zeros((self.batch, self.seq + 1), bool)
        coord = self.cluster.coordinator
        for cm in rep.queried_chunks:
            all_coords, attrs = self.reader.read(cm.file_id)
            idx = coord.chunks.cell_indices(cm.chunk_id, cm.file_id)
            if idx is None:            # file-granularity unit (file_lru)
                coords = all_coords
                chunk_attrs = attrs
            else:
                coords = all_coords[idx]
                chunk_attrs = attrs[idx]
            mask = points_in_box(coords, qbox)
            cc = coords[mask]
            toks = chunk_attrs[mask][:, 0].astype(np.int64)
            rows = cc[:, 0] - s_lo
            cols = cc[:, 1] - 1
            out[rows, cols] = toks
            valid[rows, cols] = True

        tokens = out[:, :-1]
        labels = np.where(valid[:, 1:], out[:, 1:], -1)
        self.step_in_epoch += 1
        if self.step_in_epoch >= self.steps_per_epoch:
            self.step_in_epoch = 0
            self.epoch += 1
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32)}


def build_pipeline(tmpdir: str, *, n_samples: int = 256, seq: int = 64,
                   vocab: int = 512, n_files: int = 8, n_hosts: int = 4,
                   batch: int = 16, host_budget_bytes: int = 1 << 20,
                   fmt: str = "hdf5", policy: str = "cost",
                   seed: int = 0, telemetry: Telemetry = NULL_TELEMETRY
                   ) -> RawArrayTokenPipeline:
    """A token corpus from ``seed`` written as raw files of ``fmt`` over
    ``n_hosts``, and a pipeline over it that records into
    ``telemetry``."""
    files, _ = make_token_corpus(n_samples, seq, vocab, n_files, seed)
    catalog, data = build_catalog(files, tmpdir, fmt, n_hosts)
    reader = FileReader(catalog, data)
    return RawArrayTokenPipeline(
        catalog, reader, n_hosts=n_hosts,
        host_budget_bytes=host_budget_bytes, batch=batch, seq=seq,
        policy=policy, telemetry=telemetry)
