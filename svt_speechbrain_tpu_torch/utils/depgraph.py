"""A small dependency graph with topological evaluation order (a copy of
``svt_speechbrain_tpu/utils/depgraph.py``)."""
from __future__ import annotations

import collections
import uuid


class CircularDependencyError(ValueError):
    pass


DGNode = collections.namedtuple("DGNode", ["key", "edges", "data"])


class DependencyGraph:
    """Essentially a DAG: ``add_node``/``add_edge`` then iterate
    ``get_evaluation_order()`` — dependencies come out before dependents.

    Example
    -------
    >>> dg = DependencyGraph()
    >>> _ = dg.add_node("features")
    >>> _ = dg.add_node("wav")
    >>> dg.add_edge("features", "wav")     # features depends on wav
    >>> [n.key for n in dg.get_evaluation_order()]
    ['wav', 'features']
    >>> dg.add_edge("wav", "features")     # cycle
    >>> dg.is_valid()
    False
    """

    def __init__(self):
        self.digraph = []
        self.key2ind = {}

    @staticmethod
    def get_unique_key():
        return uuid.uuid4()

    def add_node(self, key=None, data=None):
        if key is None:
            key = self.get_unique_key()
        elif key in self.key2ind:
            ind = self.key2ind[key]
            node = self.digraph[ind]
            # node has already been added (e.g. as a dependency), fill in data
            self.digraph[ind] = DGNode(key, node.edges, data)
            return key
        self.key2ind[key] = len(self.digraph)
        self.digraph.append(DGNode(key, [], data))
        return key

    def add_edge(self, from_key, to_key):
        from_ind = self._get_ind_and_add_if_new(from_key)
        to_ind = self._get_ind_and_add_if_new(to_key)
        edges = self.digraph[from_ind].edges
        if to_ind not in edges:
            edges.append(to_ind)

    def _get_ind_and_add_if_new(self, key):
        if key not in self.key2ind:
            self.key2ind[key] = len(self.digraph)
            self.digraph.append(DGNode(key, [], None))
        return self.key2ind[key]

    def is_valid(self):
        try:
            list(self.get_evaluation_order())
            return True
        except CircularDependencyError:
            return False

    def get_evaluation_order(self, selected_keys=None):
        """Yield nodes so that dependencies precede dependents (DFS postorder)."""
        seen_ever = set()

        def toposort(root_ind, visited):
            if root_ind in visited:
                raise CircularDependencyError(
                    f"{self.digraph[root_ind].key} is part of a circular dependency")
            visited = visited | {root_ind}
            for to_ind in self.digraph[root_ind].edges:
                if to_ind not in seen_ever:
                    yield from toposort(to_ind, visited)
            seen_ever.add(root_ind)
            yield self.digraph[root_ind]

        if selected_keys is None:
            start_inds = range(len(self.digraph))
        else:
            start_inds = [self.key2ind[key] for key in selected_keys]
        for start_ind in start_inds:
            if start_ind not in seen_ever:
                yield from toposort(start_ind, set())
