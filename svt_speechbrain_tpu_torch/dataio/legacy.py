"""Legacy-format dataset support (a copy of
``svt_speechbrain_tpu/dataio/legacy.py``, ``ExtendedCSVDataset``, over the
port's ``DynamicItemDataset`` and audio reading)."""
from __future__ import annotations

import collections
import csv

from svt_speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from svt_speechbrain_tpu_torch.dataio import dataio

CSVItem = collections.namedtuple("CSVItem", ["data", "format", "opts"])


class ExtendedCSVDataset(DynamicItemDataset):
    """SpeechBrain legacy "extended CSV" (triplet columns
    ``<name>, <name>_format, <name>_opts``; reference ``legacy.py:28``).
    wav entries load audio automatically; string entries pass through.

    Example
    -------
    >>> import os, tempfile
    >>> path = os.path.join(tempfile.mkdtemp(), "data.csv")
    >>> _ = open(path, "w").write(
    ...     "ID, duration, text, text_format, text_opts\\n"
    ...     "u1, 1.0, hello, string, \\n"
    ...     "u2, 2.5, world, string, \\n")
    >>> ds = ExtendedCSVDataset(path, sorting="descending")
    >>> [ds[i]["text_data"] for i in range(len(ds))]
    ['world', 'hello']
    """

    def __init__(self, csvpath, replacements={}, sorting="original",
                 min_duration=0, max_duration=36000, dynamic_items=(),
                 output_keys=()):
        if sorting not in ("original", "ascending", "descending"):
            raise ValueError(f"Unexpected sorting: {sorting}")
        data, di_to_add, data_names = load_sb_extended_csv(csvpath, replacements)
        super().__init__(data, dynamic_items, output_keys)
        for di in di_to_add:
            self.add_dynamic_item(**di)
        reverse = sorting == "descending"
        # The reference's ``if sorting == "ascending" or "descending":``
        # (legacy.py:97) is always truthy, so it ALWAYS sorts by duration —
        # even for sorting="original". Mirrored: corpus order feeds
        # AddNoise/AddReverb noise/RIR pairing.
        sort_key = "duration"
        filtered_ids = self._filtered_sorted_ids(
            key_min_value={"duration": min_duration},
            key_max_value={"duration": max_duration},
            sort_key=sort_key, reverse=reverse)
        self.data_ids = filtered_ids
        # default output keys = the data items only, like the reference
        # (legacy.py:109) — so batch.at_position(0) is the first data column
        if not output_keys:
            self.set_output_keys(data_names)


def load_sb_extended_csv(csv_path, replacements={}):
    """Parse the triplet-column CSV (reference ``legacy.py:180``)."""
    with open(csv_path, newline="") as csvfile:
        result = {}
        reader = csv.DictReader(csvfile, skipinitialspace=True)
        fields = reader.fieldnames
        if fields[:2] != ["ID", "duration"]:
            raise KeyError("Extended CSV must begin with 'ID', 'duration'")
        if (len(fields) - 2) % 3:
            raise ValueError("All named fields must have 3 entries: "
                             "<name>, <name>_format, <name>_opts")
        names = fields[2::3]
        for row in reader:
            data_id = row["ID"]
            duration = float(row["duration"])
            entry = {"duration": duration}
            values = list(row.values())[2:]
            for i, name in enumerate(names):
                data, fmt, opts_str = values[3 * i:3 * i + 3]
                for key, val in replacements.items():
                    data = data.replace(f"${key}", str(val))
                opts = dict(opt.split(":") for opt in opts_str.split(" ") if opt)
                entry[name] = CSVItem(data, fmt, opts)
            result[data_id] = entry

    dynamic_items_to_add = []
    for name in names:
        def make_loader(name=name):
            def load(item):
                if item.format == "wav":
                    return dataio.read_audio(item.data)
                if item.format == "string":
                    return item.data
                raise ValueError(f"Unsupported format {item.format}")
            return load

        dynamic_items_to_add.append(
            dict(func=make_loader(), takes=name, provides=name + "_data"))
    return result, dynamic_items_to_add, [n + "_data" for n in names]


def read_pkl(file, data_format="pkl", sampling_rate=None):
    """Unpickle a data file (reference ``legacy.py:read_pkl``)."""
    from svt_speechbrain_tpu_torch.dataio.dataio import load_pkl

    del data_format, sampling_rate
    return load_pkl(file)
