"""An insertion-ordered directed multigraph for the INDRA extraction.

It stands in for ``networkx.MultiDiGraph`` (which a machine serving the
port does not have) and holds only what the extraction uses, with
networkx's orders and keys, so that the files written from it are the
JAX package's byte for byte:

* nodes iterate in insertion order; an edge adds its missing ends, the
  source first;
* edges iterate by source node, then by successor in the order it first
  became one, then by key in insertion order;
* a new edge's key is the smallest unused integer from the number of
  parallel edges upward;
* removing the last (u, v) edge forgets v as a successor of u, so a later
  (u, v) edge goes to the end of u's successors.

Connected components are those of the undirected graph, discovered in
node order, as ``networkx.connected_components(g.to_undirected())`` finds
them.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, Iterator, List, Optional


class MultiDiGraph:
    """Directed multigraph with attribute dicts on nodes and edges."""

    def __init__(self):
        self._node: Dict[Hashable, dict] = {}
        self._succ: Dict[Hashable, Dict[Hashable, Dict[Hashable, dict]]] = {}
        self._pred: Dict[Hashable, Dict[Hashable, Dict[Hashable, dict]]] = {}

    def __contains__(self, n) -> bool:
        return n in self._node

    def add_node(self, n, **attr) -> None:
        if n not in self._node:
            self._succ[n], self._pred[n], self._node[n] = {}, {}, {}
        self._node[n].update(attr)

    def add_edge(self, u, v, key: Optional[Hashable] = None, **attr) -> Hashable:
        """Add (or update) edge ``(u, v, key)``; returns its key."""
        for n in (u, v):
            if n not in self._node:
                self.add_node(n)
        keydict = self._succ[u].get(v)
        if keydict is None:
            keydict = self._succ[u][v] = self._pred[v][u] = {}
        if key is None:
            key = len(keydict)
            while key in keydict:
                key += 1
        keydict.setdefault(key, {}).update(attr)
        return key

    def node_attrs(self, n) -> dict:
        return self._node[n]

    def nodes(self, data: bool = False) -> list:
        return list(self._node.items()) if data else list(self._node)

    def edges(self, keys: bool = False, data: bool = False) -> Iterator[tuple]:
        for u, nbrs in self._succ.items():
            for v, keydict in nbrs.items():
                for k, d in keydict.items():
                    yield (u, v) + ((k,) if keys else ()) + ((d,) if data else ())

    def number_of_nodes(self) -> int:
        return len(self._node)

    def number_of_edges(self) -> int:
        return sum(len(kd) for nbrs in self._succ.values() for kd in nbrs.values())

    def remove_nodes_from(self, nodes: Iterable) -> None:
        """Remove each node and its edges; unknown nodes are ignored."""
        for n in nodes:
            if n not in self._node:
                continue
            del self._node[n]
            for v in self._succ[n]:
                del self._pred[v][n]
            del self._succ[n]
            for u in self._pred[n]:
                del self._succ[u][n]
            del self._pred[n]

    def remove_edges_from(self, ebunch: Iterable[tuple]) -> None:
        """Remove each ``(u, v, key)`` edge; missing edges are ignored."""
        for u, v, key in ebunch:
            keydict = self._succ.get(u, {}).get(v)
            if keydict is None or key not in keydict:
                continue
            del keydict[key]
            if not keydict:
                del self._succ[u][v]
                del self._pred[v][u]

    def connected_components(self) -> List[List[Hashable]]:
        """Weakly connected components, each in node order, the
        components in the order of their first node."""
        index = {n: i for i, n in enumerate(self._node)}
        parent = list(range(len(index)))

        def find(i: int) -> int:
            root = i
            while parent[root] != root:
                root = parent[root]
            while parent[i] != root:
                parent[i], i = root, parent[i]
            return root

        for u, nbrs in self._succ.items():
            for v in nbrs:
                a, b = find(index[u]), find(index[v])
                if a != b:
                    parent[max(a, b)] = min(a, b)
        comps: Dict[int, List[Hashable]] = {}
        for n, i in index.items():
            comps.setdefault(find(i), []).append(n)
        return list(comps.values())
