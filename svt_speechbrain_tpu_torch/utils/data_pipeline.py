"""Dynamic-item data pipeline (a copy of
``svt_speechbrain_tpu/utils/data_pipeline.py``).

Recipe code declares host-side feature functions with ``@takes``/``@provides``
decorators; the ``DataPipeline`` resolves which functions to run (and in what
order) for a requested set of output keys via a dependency graph. All of this
executes on the host in the loader's worker processes; only padded tensors
reach the device.
"""
from __future__ import annotations

import inspect

from svt_speechbrain_tpu_torch.utils.depgraph import DependencyGraph


class DynamicItem:
    """A data-pipeline element: ``func(*takes) -> provides``."""

    def __init__(self, takes=None, func=None, provides=None):
        self.takes = takes or []
        self.func = func
        self.provides = provides or []

    def __call__(self, *args):
        return self.func(*args)

    def next_takes(self):
        return self.takes

    def next_provides(self):
        return self.provides

    def provided_in_order(self):
        return [self.provides]

    def reset(self):
        pass


class GeneratorDynamicItem(DynamicItem):
    """A multi-output pipeline element implemented as a generator function:
    each ``yield`` provides the next key (reference ``data_pipeline.py:109``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.current_generator = None
        self.num_provided_items = 0

    def __call__(self, *args):
        if not self.current_generator:
            self.current_generator = self.func(*args)
        out = next(self.current_generator)
        self.num_provided_items += 1
        return out

    def next_takes(self):
        return self.takes if not self.current_generator else []

    def next_provides(self):
        keys = self.provides[self.num_provided_items]
        return [keys] if isinstance(keys, str) else list(keys)

    def provided_in_order(self):
        return [([k] if isinstance(k, str) else list(k)) for k in self.provides]

    def reset(self):
        if self.current_generator is not None:
            self.current_generator.close()
        self.current_generator = None
        self.num_provided_items = 0


def takes(*argkeys):
    """Decorator declaring input keys (reference ``data_pipeline.py:191``)."""

    def decorator(obj):
        if isinstance(obj, DynamicItem):
            if obj.takes:
                raise ValueError("Can't overwrite DynamicItem.takes")
            obj.takes = list(argkeys)
            return obj
        if inspect.isgeneratorfunction(obj):
            return GeneratorDynamicItem(takes=list(argkeys), func=obj)
        return DynamicItem(takes=list(argkeys), func=obj)

    return decorator


def provides(*output_keys):
    """Decorator declaring output keys (reference ``data_pipeline.py:232``)."""

    def decorator(obj):
        if isinstance(obj, DynamicItem):
            if obj.provides:
                raise ValueError("Can't overwrite DynamicItem.provides")
            obj.provides = list(output_keys)
            return obj
        if inspect.isgeneratorfunction(obj):
            return GeneratorDynamicItem(func=obj, provides=list(output_keys))
        return DynamicItem(func=obj, provides=list(output_keys))

    return decorator


takes_decorator = takes
provides_decorator = provides


class DataPipeline:
    """Compute requested output keys from raw data-point dicts
    (reference ``data_pipeline.py:286-405``).

    Example
    -------
    >>> @takes("text")
    ... @provides("words", "n_words")
    ... def tokenize(text):
    ...     words = text.split()
    ...     yield words
    ...     yield len(words)
    >>> pipeline = DataPipeline(["text"], [tokenize],
    ...                         output_keys=["n_words"])
    >>> pipeline.compute_outputs({"text": "the quick brown fox"})
    {'n_words': 4}
    """

    def __init__(self, static_data_keys, dynamic_items=(), output_keys=()):
        self.dg = DependencyGraph()
        self._exec_order = None
        self.key_to_node, self.unaccounted_keys = {}, {}
        self.dynamic_items, self.output_mapping = [], {}
        self.add_static_keys(static_data_keys)
        self.add_dynamic_items(dynamic_items)
        self.set_output_keys(output_keys)

    def add_static_keys(self, static_keys):
        self.key_to_node.update(
            (key, self.dg.add_node(data=StaticItem(key=key)))
            for key in static_keys)

    def add_dynamic_items(self, dynamic_items):
        for item in dynamic_items:
            self.add_dynamic_item(item)

    def add_dynamic_item(self, func, takes=None, provides=None):
        if isinstance(func, DynamicItem):
            if takes is not None or provides is not None:
                raise ValueError("If providing a DynamicItem, don't pass takes/provides")
            self._add_dynamic_item_object(func)
            return
        if isinstance(takes, str):
            takes = [takes]
        if isinstance(provides, str):
            provides = [provides]
        if inspect.isgeneratorfunction(func):
            di = GeneratorDynamicItem(takes=takes, func=func, provides=provides)
        else:
            di = DynamicItem(takes=takes, func=func, provides=provides)
        self._add_dynamic_item_object(di)

    def _add_dynamic_item_object(self, obj):
        if not obj.provides:
            raise ValueError("Dynamic items need to provide something.")
        depended = []
        for key in obj.takes:
            if key not in self.key_to_node:
                dependee_keys = self.unaccounted_keys.setdefault(key, [])
                dependee_keys.extend(obj.next_provides())
            else:
                depended.append(self.key_to_node[key])
        for provided in obj.provided_in_order():
            node_id = self.dg.add_node(data=obj)
            for dep_id in depended:
                self.dg.add_edge(node_id, dep_id)
            for key in provided:
                self.key_to_node[key] = node_id
                if key in self.unaccounted_keys:
                    for dependee_key in self.unaccounted_keys[key]:
                        dependee_id = self.key_to_node[dependee_key]
                        self.dg.add_edge(dependee_id, node_id)
                    del self.unaccounted_keys[key]
            depended = [node_id]
        self.dynamic_items.append(obj)
        self._exec_order = None

    def set_output_keys(self, keys):
        self.output_mapping = self._output_keys_to_mapping(keys)
        self._exec_order = None

    @staticmethod
    def _output_keys_to_mapping(keys):
        if keys is None:
            return {}
        if isinstance(keys, dict):
            return keys
        return {key: key for key in keys}

    def compute_outputs(self, data):
        if self._exec_order is None:
            self._prepare_run(data)
        return self._compute(data, self._exec_order, self.output_mapping)

    def compute_specific(self, keys, data):
        output_mapping = self._output_keys_to_mapping(keys)
        order = self.dg.get_evaluation_order(selected_keys=self.get_selected_node_ids(keys))
        return self._compute(data, order, output_mapping)

    def _compute(self, data, order, output_mapping):
        if self.unaccounted_keys:
            raise RuntimeError(f"These keys are still unaccounted for: {list(self.unaccounted_keys)}")
        intermediate = {}
        for node_id, edges, item in order:
            if isinstance(item, StaticItem):
                try:
                    data[item.key]
                    continue
                except KeyError:
                    raise KeyError(f"Expected key {item.key} in data")
            args = [
                data[argkey] if argkey in data else intermediate[argkey]
                for argkey in item.next_takes()
            ]
            provided_keys = item.next_provides()
            values = item(*args)
            if len(provided_keys) == 1:
                values = [values]
            intermediate.update(zip(provided_keys, values))
        for item in self.dynamic_items:
            item.reset()
        return {
            outkey: data[inkey] if inkey in data else intermediate[inkey]
            for outkey, inkey in output_mapping.items()
        }

    def get_selected_node_ids(self, selected_keys):
        return [self.key_to_node[key] for key in selected_keys]

    def __call__(self, data):
        return self.compute_outputs(data)

    def _prepare_run(self, data):
        self._exec_order = list(
            self.dg.get_evaluation_order(self.get_selected_node_ids(self.output_mapping.values()))
        )


class StaticItem:
    """Marker for keys that come directly from the raw data dict."""

    def __init__(self, key):
        self.key = key
