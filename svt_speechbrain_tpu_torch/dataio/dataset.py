"""Dynamic-item dataset (a copy of ``svt_speechbrain_tpu/dataio/dataset.py``).

A dataset is a dict-of-dicts of raw annotations (from CSV/JSON manifests) plus
a host-side ``DataPipeline`` that lazily computes requested output keys per
data point. The engine reads it through ``dataio.dataloader``, which is a
``torch.utils.data.DataLoader`` over it.
"""
from __future__ import annotations

import contextlib

from svt_speechbrain_tpu_torch.dataio.dataio import load_data_csv, load_data_json
from svt_speechbrain_tpu_torch.utils.data_pipeline import DataPipeline


class DynamicItemDataset:
    """Reference ``dataset.py:19``: ``from_csv``/``from_json`` constructors,
    ``add_dynamic_item``, ``set_output_keys``, ``filtered_sorted`` views.

    Example
    -------
    >>> data = {"u1": {"text": "hello world"}, "u2": {"text": "foo"}}
    >>> ds = DynamicItemDataset(data)
    >>> ds.add_dynamic_item(lambda text: text.split(), takes="text",
    ...                     provides="words")
    >>> ds.set_output_keys(["id", "words"])
    >>> ds[0]
    {'id': 'u1', 'words': ['hello', 'world']}
    >>> short = ds.filtered_sorted(key_test={"text": lambda t: len(t) < 5})
    >>> len(short)
    1
    """

    def __init__(self, data, dynamic_items=(), output_keys=()):
        self.data = data
        self.data_ids = list(self.data.keys())
        static_keys = list(self.data[self.data_ids[0]].keys())
        if "id" in static_keys:
            raise ValueError("The key 'id' is reserved for the data point id.")
        static_keys.append("id")
        self.pipeline = DataPipeline(static_keys, dynamic_items, output_keys)

    def __len__(self):
        return len(self.data_ids)

    def __getitem__(self, index):
        data_id = self.data_ids[index]
        data_point = self.data[data_id]
        return self.pipeline.compute_outputs({"id": data_id, **data_point})

    def add_dynamic_item(self, func, takes=None, provides=None):
        self.pipeline.add_dynamic_item(func, takes, provides)

    def set_output_keys(self, keys):
        self.pipeline.set_output_keys(keys)

    @contextlib.contextmanager
    def output_keys_as(self, keys):
        """Temporarily change output keys (reference ``dataset.py:158``)."""
        saved_output = self.pipeline.output_mapping
        self.pipeline.set_output_keys(keys)
        yield self
        self.pipeline.output_mapping = saved_output
        self.pipeline._exec_order = None

    def filtered_sorted(self, key_min_value={}, key_max_value={}, key_test={},
                        sort_key=None, reverse=False, select_n=None):
        """Filtered and/or sorted view sharing static data and pipeline
        (reference ``dataset.py:236``)."""
        filtered_sorted_ids = self._filtered_sorted_ids(
            key_min_value, key_max_value, key_test, sort_key, reverse, select_n)
        return FilteredSortedDynamicItemDataset(self, filtered_sorted_ids)

    def _filtered_sorted_ids(self, key_min_value={}, key_max_value={}, key_test={},
                             sort_key=None, reverse=False, select_n=None):
        def combined_filter(computed):
            for key, limit in key_min_value.items():
                if computed[key] < limit:
                    return False
            for key, limit in key_max_value.items():
                if computed[key] > limit:
                    return False
            for key, func in key_test.items():
                if not bool(func(computed[key])):
                    return False
            return True

        temp_keys = (
            set(key_min_value) | set(key_max_value) | set(key_test)
            | ({sort_key} if sort_key is not None else set())
        )
        filtered_ids = []
        with self.output_keys_as(temp_keys):
            for i, data_id in enumerate(self.data_ids):
                if select_n is not None and len(filtered_ids) == select_n:
                    break
                data_point = self.data[data_id]
                computed = self.pipeline.compute_outputs({"id": data_id, **data_point})
                if combined_filter(computed):
                    if sort_key is not None:
                        filtered_ids.append((computed[sort_key], i, data_id))
                    else:
                        filtered_ids.append(data_id)
        if sort_key is not None:
            return [t[2] for t in sorted(filtered_ids, reverse=reverse)]
        return filtered_ids

    @classmethod
    def from_csv(cls, csv_path, replacements={}, dynamic_items=(), output_keys=()):
        data = load_data_csv(csv_path, replacements)
        return cls(data, dynamic_items, output_keys)

    @classmethod
    def from_json(cls, json_path, replacements={}, dynamic_items=(), output_keys=()):
        data = load_data_json(json_path, replacements)
        return cls(data, dynamic_items, output_keys)


class FilteredSortedDynamicItemDataset(DynamicItemDataset):
    """A filtered/sorted view (reference ``dataset.py:381``)."""

    def __init__(self, from_dataset, data_ids):
        self.data = from_dataset.data
        self.data_ids = data_ids
        self.pipeline = from_dataset.pipeline


def add_dynamic_item(datasets, func, takes=None, provides=None):
    """Helper over many datasets (reference ``dataset.py:406``)."""
    for dataset in datasets:
        dataset.add_dynamic_item(func, takes, provides)


def set_output_keys(datasets, output_keys):
    """Helper over many datasets (reference ``dataset.py:412``)."""
    for dataset in datasets:
        dataset.set_output_keys(output_keys)
