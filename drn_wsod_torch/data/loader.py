"""Dataset records for evaluation (counterpart of
``drn_wsod_tpu/data/loader.py:get_detection_dataset_dicts``). The train and
eval loaders come with the data path (ROADMAP.md queue 1, item 10)."""

from __future__ import annotations

import itertools
from typing import List, Sequence

from .catalog import DatasetCatalog
from .proposals import load_proposals_into_dataset


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
