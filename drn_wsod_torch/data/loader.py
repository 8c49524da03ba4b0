"""Dataset records and batch loaders (counterpart of
``drn_wsod_tpu/data/loader.py``).

``TrainLoader`` is an infinite, seeded, shuffled loader whose batches are
grouped by size bucket (every image of a batch has one bucket, so a batch
has one shape); ``EvalLoader`` is one sequential pass, its last batch
padded. Both collate to host (CPU) tensors, never device tensors: the
trainer's prefetch copies each batch to the device. Images stay uint8.

The multi-process loader (each process decoding its slice of a global
batch) is not ported yet (ROADMAP.md queue 1, item 16).
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..structures.batch import WSODBatch
from .catalog import DatasetCatalog
from .proposals import load_proposals_into_dataset

logger = logging.getLogger(__name__)


def get_detection_dataset_dicts(names: Sequence[str],
                                proposal_files: Sequence[str] = (),
                                filter_empty: bool = True) -> List[dict]:
    """Load and concatenate the named datasets, attaching each one's
    proposal file; with ``filter_empty`` drop records without annotations."""
    if isinstance(names, str):
        names = [names]
    all_dicts = []
    for i, name in enumerate(names):
        dicts = DatasetCatalog.get(name)
        if not dicts:
            raise ValueError(f"Dataset '{name}' is empty!")
        if proposal_files:
            dicts = load_proposals_into_dataset(dicts, proposal_files[i])
        all_dicts.append(dicts)
    records = list(itertools.chain.from_iterable(all_dicts))
    if filter_empty:
        records = [r for r in records if r.get("annotations")]
    return records


def _collate(samples: List[Dict[str, np.ndarray]]) -> WSODBatch:
    """Stack the samples' arrays into a batch of CPU tensors (keys starting
    with "_" are bookkeeping and left out). The copy to the device is the
    trainer's, so that it can overlap the device's work."""
    return WSODBatch(**{
        k: torch.from_numpy(np.stack([s[k] for s in samples]))
        for k in samples[0] if not k.startswith("_")})


class TrainLoader:
    """Infinite shuffled loader with bucket-grouped batches of
    ``batch_size`` images.

    The index stream is the JAX package's: one ``np.random.RandomState(seed)``
    draws each epoch's permutation (or, with ``repeat_factors``, the
    stochastically rounded repeats first) and, per sample, the seed of the
    sample's own RandomState, which the mapper's augmentations draw from.
    So the port yields the JAX loader's batches one for one.
    ``num_workers`` > 1 threads run the mapper on samples in stream order
    (numpy releases the GIL in the resize), and the samples are taken in
    that order."""

    def __init__(self, records: List[dict], mapper: Callable,
                 batch_size: int, seed: int = 0, prefetch: int = 2,
                 num_workers: int = 0, process_count: int = 1,
                 repeat_factors: Optional[np.ndarray] = None):
        if not records:
            raise ValueError("TrainLoader needs at least one record")
        self._records = records
        self._mapper = mapper
        self._batch_size = batch_size
        self._seed = seed
        self._prefetch = prefetch
        self._num_workers = num_workers
        self._repeat_factors = (None if repeat_factors is None
                                else np.asarray(repeat_factors, np.float64))
        self._world = process_count
        if batch_size % self._world:
            raise ValueError(f"IMS_PER_BATCH {batch_size} not divisible by "
                             f"{self._world} processes")

    def _index_iter(self):
        rng = np.random.RandomState(self._seed)
        rf = self._repeat_factors
        while True:
            if rf is None:
                epoch = rng.permutation(len(self._records))
            else:
                # the repeat-factor sampler: the integer part of each factor
                # repeats deterministically, the fraction by a draw per epoch
                reps = np.floor(rf).astype(np.int64)
                reps += (rng.rand(len(rf)) < (rf - np.floor(rf)))
                epoch = rng.permutation(np.repeat(
                    np.arange(len(self._records)), reps))
            for idx in epoch:
                yield int(idx), int(rng.randint(2 ** 31))

    def _map(self, idx: int, seed: int):
        return self._mapper(self._records[idx], np.random.RandomState(seed),
                            dataset_index=idx)

    def _sample_iter(self):
        """Mapped samples in index-stream order."""
        indices = self._index_iter()
        if self._num_workers <= 1:
            for idx, seed in indices:
                sample = self._map(idx, seed)
                if sample is not None:
                    yield sample
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self._num_workers) as pool:
            inflight = []
            depth = self._num_workers * 2
            for idx, seed in indices:
                inflight.append(pool.submit(self._map, idx, seed))
                if len(inflight) >= depth:
                    sample = inflight.pop(0).result()
                    if sample is not None:
                        yield sample

    def _batch_iter(self):
        if self._world > 1:
            raise NotImplementedError(
                "the multi-process train loader is not ported yet: "
                "ROADMAP.md queue 1, item 16 (multi-device)")
        buffers: Dict[int, list] = {}
        for sample in self._sample_iter():
            b = buffers.setdefault(sample["_bucket"], [])
            b.append(sample)
            if len(b) == self._batch_size:
                yield _collate(b)
                buffers[sample["_bucket"]] = []

    def __iter__(self) -> Iterator[WSODBatch]:
        if self._prefetch <= 0:
            return self._batch_iter()
        return _prefetch_iter(self._batch_iter(), self._prefetch)


class EvalLoader:
    """One sequential pass in dataset order; yields (batch, n_real). Each
    batch is padded to its largest bucket (masks with 0, label maps with
    255), and the last one filled up with copies of its last sample
    (``n_real`` counts the real ones)."""

    def __init__(self, records: List[dict], mapper: Callable,
                 batch_size: int = 1, prefetch: int = 2,
                 process_count: int = 1):
        if process_count > 1:
            raise NotImplementedError(
                "the multi-process eval loader is not ported yet: "
                "ROADMAP.md queue 1, item 16 (multi-device)")
        self._records = records
        self._mapper = mapper
        self._batch_size = batch_size
        self._prefetch = prefetch

    def __len__(self):
        return -(-len(self._records) // self._batch_size)

    def _batch_iter(self):
        rng = np.random.RandomState(0)  # the test augmentation draws nothing
        bs = self._batch_size
        for i in range(0, len(self._records), bs):
            chunk = self._records[i:i + bs]
            samples = [self._mapper(r, rng, dataset_index=i + j)
                       for j, r in enumerate(chunk)]
            n_real = len(samples)
            while len(samples) < bs:
                samples.append(samples[-1])
            bucket = max(s["_bucket"] for s in samples)
            for k, s in enumerate(samples):
                if s["_bucket"] != bucket:
                    img = s["image"]
                    canvas = np.zeros((bucket, bucket) + img.shape[2:],
                                      dtype=img.dtype)
                    canvas[:img.shape[0], :img.shape[1]] = img
                    samples[k] = {**s, "image": canvas, "_bucket": bucket}
                    if "gt_masks" in s:
                        old = s["gt_masks"]
                        m = np.zeros(old.shape[:1] + (bucket, bucket),
                                     dtype=old.dtype)
                        m[:, :old.shape[1], :old.shape[2]] = old
                        samples[k]["gt_masks"] = m
                    if "sem_seg" in s:
                        # 255, whatever the mapper's ignore value, as the
                        # JAX loader pads
                        old = s["sem_seg"]
                        m = np.full((bucket, bucket), 255, dtype=np.int32)
                        m[:old.shape[0], :old.shape[1]] = old
                        samples[k]["sem_seg"] = m
            yield _collate(samples), n_real

    def __iter__(self):
        if self._prefetch <= 0:
            return self._batch_iter()
        return _prefetch_iter(self._batch_iter(), self._prefetch)


def _prefetch_iter(it: Iterator, depth: int) -> Iterator:
    """Run ``it`` on a background thread, at most ``depth`` items ahead;
    an exception there re-raises in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            q.put(e)
        q.put(end)

    threading.Thread(target=worker, daemon=True,
                     name="loader-prefetch").start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def repeat_factors_from_category_frequency(records: List[dict],
                                           repeat_thresh: float) -> np.ndarray:
    """Per-image repeat factor r(I) = max over the categories c in I of
    max(1, sqrt(t / f(c))), f(c) the fraction of images holding c (the
    LVIS oversampling recipe)."""
    freq: Dict[int, int] = {}
    for r in records:
        for c in {a["category_id"] for a in r.get("annotations", [])}:
            freq[c] = freq.get(c, 0) + 1
    n = len(records)
    cat_rep = {c: max(1.0, np.sqrt(repeat_thresh / (f / n)))
               for c, f in freq.items()}
    return np.asarray(
        [max([cat_rep[a["category_id"]]
              for a in r.get("annotations", [])] or [1.0])
         for r in records])


def build_detection_train_loader(cfg, mapper) -> TrainLoader:
    """The train loader of ``DATASETS.TRAIN`` (with their proposal files
    where ``MODEL.LOAD_PROPOSALS``), ``IMS_PER_BATCH`` images a batch."""
    records = get_detection_dataset_dicts(
        cfg.DATASETS.TRAIN, cfg.DATASETS.PROPOSAL_FILES_TRAIN
        if cfg.MODEL.LOAD_PROPOSALS else (),
        filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS)
    sampler = cfg.DATALOADER.SAMPLER_TRAIN
    if sampler == "RepeatFactorTrainingSampler":
        rf = repeat_factors_from_category_frequency(
            records, cfg.DATALOADER.REPEAT_THRESHOLD)
    elif sampler == "TrainingSampler":
        rf = None
    else:
        raise ValueError(f"Unknown DATALOADER.SAMPLER_TRAIN: {sampler}")
    if not cfg.DATALOADER.ASPECT_RATIO_GROUPING:
        logger.warning("DATALOADER.ASPECT_RATIO_GROUPING=False has no "
                       "effect: batches are always bucket-grouped.")
    return TrainLoader(records, mapper, cfg.SOLVER.IMS_PER_BATCH,
                       seed=max(cfg.SEED, 0),
                       prefetch=cfg.DATALOADER.PREFETCH,
                       num_workers=cfg.DATALOADER.NUM_WORKERS,
                       repeat_factors=rf)


def build_detection_test_loader(cfg, dataset_name: str, mapper,
                                batch_size: int = 1,
                                proposal_file: Optional[str] = None
                                ) -> EvalLoader:
    """The eval loader of one dataset. ``proposal_file`` overrides the
    lookup in ``DATASETS.PROPOSAL_FILES_TEST`` (a train dataset evaluated
    for CorLoc brings its own)."""
    if proposal_file is None and cfg.MODEL.LOAD_PROPOSALS:
        names = list(cfg.DATASETS.TEST)
        proposal_files = list(cfg.DATASETS.PROPOSAL_FILES_TEST)
        if dataset_name in names and proposal_files:
            proposal_file = proposal_files[names.index(dataset_name)]
    pf = [proposal_file] if (proposal_file and cfg.MODEL.LOAD_PROPOSALS) else ()
    records = get_detection_dataset_dicts([dataset_name], pf,
                                          filter_empty=False)
    return EvalLoader(records, mapper, batch_size,
                      prefetch=cfg.DATALOADER.PREFETCH)
