"""Small host-side graph utilities.

Replaces the reference's use of ``networkx`` for connected components
(`tracking.py:345-347`, `structure/thread.py:211`), gap-bridging CCs
(`tracking.py:323-329`) and biconnected components
(`structure/thread.py:240`).  These run on metadata-sized graphs
(tracks, shots) — host NumPy/pure Python is the right tool; no device work.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Set, Tuple


class UnionFind:
    """Disjoint-set forest with path compression + union by rank."""

    def __init__(self):
        self._parent: Dict[Hashable, Hashable] = {}
        self._rank: Dict[Hashable, int] = {}

    def add(self, x: Hashable) -> None:
        if x not in self._parent:
            self._parent[x] = x
            self._rank[x] = 0

    def find(self, x: Hashable) -> Hashable:
        self.add(x)
        root = x
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[x] != root:  # path compression
            self._parent[x], x = root, self._parent[x]
        return root

    def union(self, a: Hashable, b: Hashable) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self._rank[ra] < self._rank[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        if self._rank[ra] == self._rank[rb]:
            self._rank[ra] += 1

    def groups(self) -> List[Set[Hashable]]:
        by_root: Dict[Hashable, Set[Hashable]] = {}
        for x in self._parent:
            by_root.setdefault(self.find(x), set()).add(x)
        return list(by_root.values())


class Graph:
    """Minimal undirected graph: nodes, edges, CCs, biconnected components."""

    def __init__(self):
        self._adj: Dict[Hashable, Set[Hashable]] = {}

    def add_node(self, n: Hashable) -> None:
        self._adj.setdefault(n, set())

    def add_nodes_from(self, nodes: Iterable[Hashable]) -> None:
        for n in nodes:
            self.add_node(n)

    def add_edge(self, a: Hashable, b: Hashable) -> None:
        self.add_node(a)
        self.add_node(b)
        self._adj[a].add(b)
        self._adj[b].add(a)

    def nodes(self) -> List[Hashable]:
        return list(self._adj)

    def neighbors(self, n: Hashable) -> Set[Hashable]:
        return self._adj[n]

    def __contains__(self, n: Hashable) -> bool:
        return n in self._adj

    def connected_components(self) -> List[Set[Hashable]]:
        seen: Set[Hashable] = set()
        components: List[Set[Hashable]] = []
        for start in self._adj:
            if start in seen:
                continue
            comp: Set[Hashable] = set()
            stack = [start]
            while stack:
                n = stack.pop()
                if n in comp:
                    continue
                comp.add(n)
                stack.extend(self._adj[n] - comp)
            seen |= comp
            components.append(comp)
        return components

    def biconnected_components(self) -> List[Set[Hashable]]:
        """Biconnected components (sets of nodes), iterative Hopcroft–Tarjan.

        Matches ``networkx.biconnected_components`` output semantics as used
        for scene grouping (`structure/thread.py:240`): each component is
        the node set of a maximal biconnected subgraph; isolated nodes and
        bridge endpoints appear in 2-node components per bridge edge.
        """
        visited: Set[Hashable] = set()
        components: List[Set[Hashable]] = []

        for start in self._adj:
            if start in visited or not self._adj[start]:
                continue
            discovery: Dict[Hashable, int] = {start: 0}
            low: Dict[Hashable, int] = {start: 0}
            root_children = 0
            visited.add(start)
            edge_stack: List[Tuple[Hashable, Hashable]] = []
            stack = [(start, start, iter(self._adj[start]))]
            while stack:
                grandparent, parent, children = stack[-1]
                advanced = False
                for child in children:
                    if child == grandparent:
                        continue
                    if child in discovery:
                        if discovery[child] <= discovery[parent]:  # back edge
                            low[parent] = min(low[parent], discovery[child])
                            edge_stack.append((parent, child))
                    else:
                        low[child] = discovery[child] = len(discovery)
                        visited.add(child)
                        edge_stack.append((parent, child))
                        stack.append((parent, child, iter(self._adj[child])))
                        advanced = True
                        break
                if advanced:
                    continue
                stack.pop()
                if len(stack) > 1:
                    if low[parent] >= discovery[grandparent]:
                        comp: Set[Hashable] = set()
                        while edge_stack:
                            edge = edge_stack.pop()
                            comp.update(edge)
                            if edge == (grandparent, parent):
                                break
                        components.append(comp)
                    low[grandparent] = min(low[parent], low[grandparent])
                elif stack:  # root of DFS tree
                    root_children += 1
                    comp = set()
                    while edge_stack:
                        edge = edge_stack.pop()
                        comp.update(edge)
                        if edge == (grandparent, parent):
                            break
                    if comp:
                        components.append(comp)
        return components


def connected_components_from_edges(
    n_nodes: int, edges: Iterable[Tuple[int, int]]
) -> List[Set[int]]:
    """CCs over integer-indexed nodes 0..n-1 (gap-fill graph, tracking)."""
    uf = UnionFind()
    for i in range(n_nodes):
        uf.add(i)
    for a, b in edges:
        uf.union(a, b)
    return uf.groups()
