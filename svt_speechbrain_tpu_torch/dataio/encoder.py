"""Categorical/text label encoders (port of
``svt_speechbrain_tpu/dataio/encoder.py``).

The same encoders, special-label slots and on-disk literal format (labels
as ``repr => int`` lines, then the extras separator, then
``repr(key) => repr(value)`` extras incl. ``starting_index``), so a file
saved by either package loads in the other. The ``*_torch`` variants return
int64 torch tensors with the values of the JAX package's int64 arrays.
``load_or_create`` builds and saves on the main process only, through the
port's ``parallel.distributed``."""
from __future__ import annotations

from ast import literal_eval
from collections import Counter
from itertools import chain
from logging import getLogger

import torch

_LOG = getLogger(__name__)

DEFAULT_UNK = "<unk>"
DEFAULT_BOS = "<bos>"
DEFAULT_EOS = "<eos>"
DEFAULT_BLANK = "<blank>"

_MISSING = object()


class CategoricalEncoder:
    """Label ⇄ index encoder (reference ``encoder.py:19``).

    Example
    -------
    >>> enc = CategoricalEncoder()
    >>> enc.update_from_iterable(["spk1", "spk2", "spk1"])
    >>> len(enc)
    2
    >>> enc.encode_sequence(["spk2", "spk1"])
    [1, 0]
    >>> enc.decode_ndim([1, 0])
    ['spk2', 'spk1']
    """

    VALUE_SEPARATOR = " => "
    EXTRAS_SEPARATOR = "================\n"

    # Special-label slots this class persists, in on-disk extras order.
    # Each slot is an attribute that may be entirely absent (hasattr
    # convention — None is a legal special label).
    _special_slots = ("unk_label",)
    # Whether iterables fed to update_* hold sequences of labels by
    # default (text subclasses flip this).
    _iterables_hold_sequences = False

    def __init__(self, starting_index=0, **special_labels):
        self.lab2ind, self.ind2lab = {}, {}
        self.starting_index = starting_index
        self.handle_special_labels(special_labels)

    def handle_special_labels(self, special_labels):
        """Apply constructor-passed special labels (here: ``unk_label``)."""
        unk = special_labels.get("unk_label", _MISSING)
        if unk is not _MISSING:
            self.add_unk(unk)

    def __len__(self):
        return len(self.ind2lab)

    @classmethod
    def from_saved(cls, path):
        """Recreate a previously saved encoder directly (reference ``:153``)."""
        fresh = cls()
        fresh.load(path)
        return fresh

    def _resolve_sequence_flag(self, sequence_input):
        if sequence_input is None:
            return self._iterables_hold_sequences
        return sequence_input

    def update_from_iterable(self, iterable, sequence_input=None):
        """Collect labels (reference ``:160``)."""
        flat = (chain.from_iterable(iterable)
                if self._resolve_sequence_flag(sequence_input) else iterable)
        for lab in flat:
            self.ensure_label(lab)

    def update_from_didataset(self, didataset, output_key,
                              sequence_input=None):
        """Collect labels from a DynamicItemDataset key (reference ``:178``)."""
        with didataset.output_keys_as([output_key]):
            values = (didataset[i][output_key]
                      for i in range(len(didataset)))
            self.update_from_iterable(values, sequence_input)

    def limited_labelset_from_iterable(self, iterable, sequence_input=None,
                                       n_most_common=None, min_count=1):
        """Count-limited label mapping (reference ``:199``): keep at most
        ``n_most_common`` labels appearing at least ``min_count`` times.
        Returns the (unfiltered) label Counter."""
        if self.lab2ind:
            _LOG.info("limited_labelset_from_iterable on a non-empty %s; "
                        "new labels add on.", type(self).__name__)
        flat = (chain.from_iterable(iterable)
                if self._resolve_sequence_flag(sequence_input) else iterable)
        counts = Counter(flat)
        for lab, n in counts.most_common(n_most_common):
            if n < min_count:
                break
            self.add_label(lab)
        return counts

    def load_or_create(self, path, from_iterables=(), from_didatasets=(),
                       sequence_input=False, output_key=None,
                       special_labels={}):
        """Load if the file exists, else build from the sources and save
        (reference ``:245``; main-process-gated like the reference)."""
        from svt_speechbrain_tpu_torch.parallel.distributed import (ddp_barrier,
                                                              if_main_process)

        try:
            if if_main_process() and not self.load_if_possible(path):
                for source in from_iterables:
                    self.update_from_iterable(source, sequence_input)
                if from_didatasets and output_key is None:
                    raise ValueError("Provide an output_key for "
                                     "DynamicItemDataset")
                for ds in from_didatasets:
                    self.update_from_didataset(ds, output_key,
                                               sequence_input)
                self.handle_special_labels(special_labels)
                self.save(path)
        finally:
            ddp_barrier()
            self.load(path)
        return self

    def _bind(self, lab, idx):
        self.lab2ind[lab] = idx
        self.ind2lab[idx] = lab

    def _first_free_index(self):
        idx = self.starting_index
        while idx in self.ind2lab:
            idx += 1
        return idx

    def add_label(self, label):
        """Add a new label; raises if present (reference ``:280``)."""
        if self.lab2ind.get(label, _MISSING) is not _MISSING:
            raise KeyError(f"Label already present: {label}")
        idx = self._first_free_index()
        self._bind(label, idx)
        return idx

    def ensure_label(self, label):
        """Add a label only if it's absent (reference ``:303``)."""
        got = self.lab2ind.get(label, _MISSING)
        return self.add_label(label) if got is _MISSING else got

    def insert_label(self, label, index):
        """Add a new label at a forced index; raises if present
        (reference ``:323``)."""
        if self.lab2ind.get(label, _MISSING) is not _MISSING:
            raise KeyError(f"Label already present in {type(self).__name__}")
        return self.enforce_label(label, index)

    def enforce_label(self, label, index):
        """Ensure ``label`` encodes to ``index``, relocating any occupant to
        the next free slot (reference ``:344``)."""
        at = int(index)
        current = self.lab2ind.get(label, _MISSING)
        if current is not _MISSING:
            if current == at:
                return
            del self.ind2lab[current]
        evicted = self.ind2lab.get(at, _MISSING)
        self._bind(label, at)
        if evicted is not _MISSING:
            _LOG.info("Relocating label %r: %r now occupies its index %d.",
                      evicted, label, at)
            self._bind(evicted, self._first_free_index())

    def add_unk(self, unk_label=DEFAULT_UNK):
        """Add the out-of-vocab label (reference ``:379``); may be None."""
        self.unk_label = unk_label
        return self.add_label(self.unk_label)

    def is_continuous(self):
        """True when the index set has no gaps from ``starting_index``
        (reference ``:406``)."""
        taken = sorted(self.ind2lab)
        span = range(self.starting_index, self.starting_index + len(taken))
        return bool(taken) and taken == list(span)

    def encode_label(self, label, allow_unk=True):
        """Label → int with the reference's unk semantics (``:428``)."""
        got = self.lab2ind.get(label, _MISSING)
        if got is not _MISSING:
            return got
        if hasattr(self, "unk_label"):
            if allow_unk:
                # raise (not .get→None) when unk_label is set but unbound in
                # lab2ind (e.g. a hand-built saved file missing its line)
                return self.lab2ind[self.unk_label]
            raise KeyError(f"Unknown label {label}, and explicitly "
                           "disallowed the use of the existing unk-label")
        if allow_unk:
            raise KeyError(f"Cannot encode unknown label {label}. You have "
                           "not called add_unk() to add a special unk-label "
                           "for unknown labels.")
        raise KeyError(f"Couldn't and wouldn't encode unknown label {label}.")

    def encode_label_torch(self, label, allow_unk=True):
        """Length-1 int64 tensor variant."""
        return torch.tensor([self.encode_label(label, allow_unk)],
                            dtype=torch.int64)

    def encode_sequence(self, sequence, allow_unk=True):
        return [self.encode_label(lab, allow_unk) for lab in sequence]

    def encode_sequence_torch(self, sequence, allow_unk=True):
        """Int64 tensor variant."""
        return torch.tensor(self.encode_sequence(sequence, allow_unk),
                            dtype=torch.int64)

    def decode_torch(self, x):
        """Decode an array/tensor of indices to a (nested) list of labels."""
        return self.decode_ndim(x)

    def decode_ndim(self, x):
        """Recursively decode arrays/lists of indices (reference ``:542``)."""
        try:
            subs = iter(x)
        except TypeError:
            return self.ind2lab[int(x)]
        return [self.decode_ndim(sub) for sub in subs]

    # --- persistence: the reference's exact literal on-disk format ------

    def save(self, path):
        """Write the literal format (reference ``:569``)."""
        sep = self.VALUE_SEPARATOR
        lines = [f"{lab!r}{sep}{ind}\n" for lab, ind in self.lab2ind.items()]
        lines.append(self.EXTRAS_SEPARATOR)
        lines += [f"{k!r}{sep}{v!r}\n" for k, v in self._get_extras().items()]
        with open(path, "w") as fo:
            fo.writelines(lines)
            fo.flush()

    def load(self, path):
        """Read the literal format, overwriting state (reference ``:583``)."""
        if self.lab2ind:
            _LOG.info("load() on a non-empty %s; loaded data overwrites "
                        "everything.", type(self).__name__)
        self.lab2ind, self.ind2lab = {}, {}
        in_extras, extras = False, {}
        with open(path) as fi:
            for line in fi:
                if line == self.EXTRAS_SEPARATOR and not in_extras:
                    in_extras = True
                    continue
                lhs, _, rhs = line.strip().partition(self.VALUE_SEPARATOR)
                if in_extras:
                    extras[literal_eval(lhs)] = literal_eval(rhs)
                else:
                    self._bind(literal_eval(lhs), int(rhs))
        self._set_extras(extras)

    def load_if_possible(self, path, end_of_epoch=False, device=None):
        """Load, returning success as bool (reference ``:609``)."""
        del end_of_epoch, device
        try:
            self.load(path)
        except (FileNotFoundError, ValueError, SyntaxError):
            return False
        return True

    def _get_extras(self):
        extras = {"starting_index": self.starting_index}
        extras.update((slot, getattr(self, slot))
                      for slot in self._special_slots if hasattr(self, slot))
        return extras

    def _set_extras(self, extras):
        for slot in self._special_slots:
            if slot in extras:
                setattr(self, slot, extras[slot])
        self.starting_index = extras["starting_index"]

    def _require_special(self, slot, exc_type, message):
        """Fetch a special label or raise with the slot's idiom."""
        got = getattr(self, slot, _MISSING)
        if got is _MISSING:
            raise exc_type(message)
        return got


class TextEncoder(CategoricalEncoder):
    """Adds bos/eos handling (reference ``encoder.py:720``); sequence input
    is the default for text.

    Example
    -------
    >>> enc = TextEncoder()
    >>> enc.update_from_iterable([["hello", "world"], ["how", "are"]])
    >>> enc.add_bos_eos()
    >>> enc.prepend_bos_index(enc.encode_sequence(["hello"]))
    [4, 0]
    """

    _special_slots = ("unk_label", "bos_label", "eos_label")
    _iterables_hold_sequences = True

    def handle_special_labels(self, special_labels):
        super().handle_special_labels(special_labels)
        given = [k for k in ("bos_label", "eos_label") if k in special_labels]
        if len(given) == 1:
            raise TypeError("Only BOS or EOS specified. Need both for init.")
        if given:
            # constructor quirk kept from the reference: the kwargs carry
            # the INDEXES for the default "<bos>"/"<eos>" labels
            self.insert_bos_eos(bos_index=special_labels["bos_label"],
                                eos_index=special_labels["eos_label"])

    def add_bos_eos(self, bos_label=DEFAULT_BOS, eos_label=DEFAULT_EOS):
        """Append sentence boundaries to the label set; equal labels share
        one boundary symbol (reference ``:826``)."""
        for lab in dict.fromkeys((bos_label, eos_label)):
            self.add_label(lab)
        self.bos_label, self.eos_label = bos_label, eos_label

    def insert_bos_eos(self, bos_label=DEFAULT_BOS, eos_label=DEFAULT_EOS,
                       bos_index=0, eos_index=None):
        """Insert sentence boundaries at given indexes (reference ``:857``)."""
        self.insert_label(bos_label, bos_index)
        if eos_label != bos_label:
            where = bos_index + 1 if eos_index is None else eos_index
            self.insert_label(eos_label, where)
        self.bos_label, self.eos_label = bos_label, eos_label

    def get_bos_index(self):
        return self.encode_label(self._require_special(
            "bos_label", RuntimeError, "BOS label is not set!"))

    def get_eos_index(self):
        return self.encode_label(self._require_special(
            "eos_label", RuntimeError, "EOS label is not set!"))

    def _bos(self):
        return self._require_special(
            "bos_label", KeyError, "BOS label has not been added to label set!")

    def _eos(self):
        return self._require_special(
            "eos_label", KeyError, "EOS label has not been added to label set!")

    def prepend_bos_label(self, x):
        return [self._bos()] + list(x)

    def prepend_bos_index(self, x):
        return [self.lab2ind[self._bos()]] + list(x)

    def append_eos_label(self, x):
        return list(x) + [self._eos()]

    def append_eos_index(self, x):
        return list(x) + [self.lab2ind[self._eos()]]


class CTCTextEncoder(TextEncoder):
    """Adds a blank symbol + CTC collapsing (reference ``encoder.py:940``).

    Example
    -------
    >>> enc = CTCTextEncoder()
    >>> enc.update_from_iterable(["abcd"])
    >>> enc.add_blank()
    >>> enc.collapse_indices_ndim([4, 4, 0, 1, 2, 3, 4, 4])   # 4 is <blank>
    [0, 1, 2, 3]
    >>> enc.collapse_labels(["a", "a", "b", "c", "d"])
    ['a', 'b', 'c', 'd']
    """

    _special_slots = ("unk_label", "bos_label", "eos_label", "blank_label")

    def handle_special_labels(self, special_labels):
        # blank goes in FIRST so its forced index wins, like the reference
        blank_at = special_labels.get("blank_label", _MISSING)
        if blank_at is not _MISSING:
            self.insert_blank(index=blank_at)
        super().handle_special_labels(special_labels)

    def add_blank(self, blank_label=DEFAULT_BLANK):
        self.add_label(blank_label)
        self.blank_label = blank_label

    def insert_blank(self, blank_label=DEFAULT_BLANK, index=0):
        self.insert_label(blank_label, index)
        self.blank_label = blank_label

    def get_blank_index(self):
        return self.encode_label(self._require_special(
            "blank_label", RuntimeError, "Blank label is not set!"))

    def _blank(self):
        return self._require_special(
            "blank_label", KeyError, "Blank label has not been added")

    @staticmethod
    def _merge_repeats(seq):
        """Drop elements equal to their predecessor (one pass)."""
        shifted = chain([_MISSING], seq)
        return [v for v, prev in zip(seq, shifted) if v != prev]

    def collapse_labels(self, x, merge_repeats=True):
        """CTC collapsing on labels (reference ``:1024``);
        ``merge_repeats=False`` for RNN-T topology."""
        blank = self._blank()
        seq = self._merge_repeats(list(x)) if merge_repeats else list(x)
        return [lab for lab in seq if lab != blank]

    def collapse_indices_ndim(self, x, merge_repeats=True):
        """CTC collapsing on (possibly nested) index sequences
        (reference ``:1056``)."""
        blank_index = self.lab2ind[self._blank()]
        items = list(x)
        try:
            return [self.collapse_indices_ndim(sub, merge_repeats)
                    for sub in items]
        except TypeError:
            pass
        seq = self._merge_repeats(items) if merge_repeats else items
        return [ind for ind in seq if ind != blank_index]
