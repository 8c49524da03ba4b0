"""Dataset records and batch loaders (counterpart of
``drn_wsod_tpu/data/loader.py``).

``TrainLoader`` is an infinite, seeded, shuffled loader whose batches are
grouped by size bucket (every image of a batch has one bucket, so a batch
has one shape); ``EvalLoader`` is one sequential pass, its last batch
padded. Both collate to host (CPU) tensors, never device tensors: the
trainer's prefetch copies each batch to the device. Images stay uint8.

Over several processes (``process_count`` > 1, by default the process
group's size) every process runs the same index stream and plans each
global batch's bucket from the records' metadata alone
(``DatasetMapper.plan_bucket``), then decodes only its slice
``b[rank::world]``: its rows of the global batch, which is rank-major (rank
0's slice first). The eval loader takes ``records[rank::world]`` and keeps
the whole list as ``all_records``, which the evaluator's ground truth
needs.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..parallel import multihost
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
    that order.

    ``batch_size`` is the global batch. With ``process_count`` > 1 (by
    default the process group's size; ``process_index`` its rank) the
    loader yields process ``process_index``'s slice of each global batch,
    ``batch_size // process_count`` images (module docstring)."""

    def __init__(self, records: List[dict], mapper: Callable,
                 batch_size: int, seed: int = 0, prefetch: int = 2,
                 num_workers: int = 0, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
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
        self._rank = (multihost.get_rank() if process_index is None
                      else process_index)
        self._world = (multihost.get_world_size() if process_count is None
                       else process_count)
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
            return self._batch_iter_multiprocess()
        return self._batch_iter_single()

    def _batch_iter_single(self):
        buffers: Dict[int, list] = {}
        for sample in self._sample_iter():
            b = buffers.setdefault(sample["_bucket"], [])
            b.append(sample)
            if len(b) == self._batch_size:
                yield _collate(b)
                buffers[sample["_bucket"]] = []

    def _batch_iter_multiprocess(self):
        """Buckets planned from metadata on the shared stream; only this
        process's slice of each global batch is decoded, on
        ``num_workers`` threads where there are more than one."""
        local_bs = self._batch_size // self._world

        def decode(item):
            sample = self._map(*item)
            if sample is None:
                raise RuntimeError("the mapper dropped a sample inside a "
                                   "global batch of several processes")
            return sample

        def slices():
            buffers: Dict[int, list] = {}
            for idx, seed in self._index_iter():
                bucket = self._mapper.plan_bucket(
                    self._records[idx], np.random.RandomState(seed))
                b = buffers.setdefault(bucket, [])
                b.append((idx, seed))
                if len(b) == self._batch_size:
                    yield b[self._rank::self._world][:local_bs]
                    buffers[bucket] = []

        if self._num_workers <= 1:
            for local in slices():
                yield _collate([decode(item) for item in local])
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self._num_workers) as pool:
            inflight = []
            # about as many samples in flight as _sample_iter keeps
            depth = -(-self._num_workers * 2 // local_bs)
            for local in slices():
                inflight.append([pool.submit(decode, item)
                                 for item in local])
                if len(inflight) >= depth:
                    yield _collate([f.result() for f in inflight.pop(0)])

    def __iter__(self) -> Iterator[WSODBatch]:
        if self._prefetch <= 0:
            return self._batch_iter()
        return _prefetch_iter(self._batch_iter(), self._prefetch)


class EvalLoader:
    """One sequential pass in dataset order; yields (batch, n_real). Each
    batch is padded to its largest bucket (masks with 0, label maps with
    255), and the last one filled up with copies of its last sample
    (``n_real`` counts the real ones). With ``process_count`` > 1 (by
    default the process group's size) it runs over
    ``records[process_index::process_count]``; ``all_records`` keeps the
    whole list."""

    def __init__(self, records: List[dict], mapper: Callable,
                 batch_size: int = 1, prefetch: int = 2,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        rank = multihost.get_rank() if process_index is None \
            else process_index
        world = multihost.get_world_size() if process_count is None \
            else process_count
        self.all_records = records
        self._records = records[rank::world] if world > 1 else records
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


def build_detection_train_loader(cfg, mapper,
                                 process_index: Optional[int] = None,
                                 process_count: Optional[int] = None
                                 ) -> TrainLoader:
    """The train loader of ``DATASETS.TRAIN`` (with their proposal files
    where ``MODEL.LOAD_PROPOSALS``), ``IMS_PER_BATCH`` images a global
    batch, this process's slice of it (``TrainLoader``)."""
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
                       process_index=process_index,
                       process_count=process_count, repeat_factors=rf)


def build_detection_test_loader(cfg, dataset_name: str, mapper,
                                batch_size: int = 1,
                                proposal_file: Optional[str] = None,
                                process_index: Optional[int] = None,
                                process_count: Optional[int] = None
                                ) -> EvalLoader:
    """The eval loader of one dataset, this process's shard of it
    (``EvalLoader``). ``proposal_file`` overrides the lookup in
    ``DATASETS.PROPOSAL_FILES_TEST`` (a train dataset evaluated for CorLoc
    brings its own)."""
    if proposal_file is None and cfg.MODEL.LOAD_PROPOSALS:
        names = list(cfg.DATASETS.TEST)
        proposal_files = list(cfg.DATASETS.PROPOSAL_FILES_TEST)
        if dataset_name in names and proposal_files:
            proposal_file = proposal_files[names.index(dataset_name)]
    pf = [proposal_file] if (proposal_file and cfg.MODEL.LOAD_PROPOSALS) else ()
    records = get_detection_dataset_dicts([dataset_name], pf,
                                          filter_empty=False)
    return EvalLoader(records, mapper, batch_size,
                      prefetch=cfg.DATALOADER.PREFETCH,
                      process_index=process_index,
                      process_count=process_count)
