"""Monte-Carlo tree search over schedules (paper §III-C).

Tree nodes are schedule prefixes P_k. The four phases:

  selection      recursively maximize (exploration + exploitation):
                   exploration  = c * sqrt(ln N / n),  c = sqrt(2)
                                  (-inf once the child subtree is fully
                                   explored)
                   exploitation = (t_max^c - t_min^c) / (t_max^p - t_min^p)
                                  when both child and parent have >= 2
                                  rollouts, else 1
                 i.e. favor children whose subtree *covers* more of the
                 parent's observed time range — regions where decisions
                 matter — not children that are merely fast. Recursion
                 stops at any node with a zero-rollout child.
  expansion      materialize one zero-rollout child of the selected node
                 (children are the DAG-eligible next ops; GPU ops are bound
                 to a stream, with stream-bijection duplicates pruned via
                 canonical first-use labeling).
  rollout        complete the prefix uniformly at random and add the
                 rollout path to the tree.
  backprop       update t_min/t_max on every node along the path.

The strategy split: ``propose`` runs selection + expansion + rollout and
returns the completed candidates; ``observe`` backpropagates the
measured time along the stored rollout path. With ``propose(1)`` per
evaluation this is exactly the paper's loop; larger proposal batches
trade a little selection fidelity (tree statistics lag by up to one
batch) for batched evaluation throughput.

The tree is space-generic: "prefixes" are move sequences of any
:class:`~repro_torch.space.base.DesignSpace` (DAG-eligible
``BoundOp``\\ s for schedule spaces, per-dimension value assignments
for parameter grids), expanded through ``space.moves`` and keyed by
``space.move_key``. The random choices are the JAX package's, call for
call, so the same seed and the same times give the same trajectory.
"""
from __future__ import annotations

import math
import random

from repro_torch.core.dag import BoundOp, Graph, Schedule
from repro_torch.space.base import DesignSpace, as_space

EXPLORATION_C = math.sqrt(2.0)


class Node:
    __slots__ = ("item", "parent", "children", "n_rollouts",
                 "t_min", "t_max", "fully_explored", "_expandable")

    def __init__(self, item: BoundOp | None, parent: "Node | None"):
        self.item = item
        self.parent = parent
        self.children: dict[tuple, Node] = {}
        self.n_rollouts = 0
        self.t_min = math.inf
        self.t_max = -math.inf
        self.fully_explored = False
        self._expandable: list[BoundOp] | None = None  # lazily computed

    def prefix(self) -> list[BoundOp]:
        out: list[BoundOp] = []
        node = self
        while node.parent is not None:
            out.append(node.item)
            node = node.parent
        out.reverse()
        return out


class MCTSSearch:
    """Paper-faithful MCTS over a design space (a ``Graph`` means its
    schedules on ``n_streams`` streams, 2 by default), with the
    propose/observe strategy protocol."""

    def __init__(self, graph: "Graph | DesignSpace",
                 n_streams: int | None = None, seed: int = 0):
        self.space = as_space(graph, n_streams)
        self.graph = getattr(self.space, "graph", None)
        self.n_streams = getattr(self.space, "n_streams", None)
        self.rng = random.Random(seed)
        self.root = Node(None, None)
        # Rollout leaves awaiting their observation, by candidate key.
        self._pending: dict[tuple, Node] = {}

    # -- phase 1: selection ------------------------------------------------
    def _value(self, parent: Node, child: Node) -> float:
        if child.fully_explored:
            explore = -math.inf
        elif child.n_rollouts == 0:
            explore = math.inf
        else:
            explore = EXPLORATION_C * math.sqrt(
                math.log(parent.n_rollouts) / child.n_rollouts)
        if child.n_rollouts >= 2 and parent.n_rollouts >= 2 and \
                parent.t_max > parent.t_min:
            exploit = (child.t_max - child.t_min) / \
                (parent.t_max - parent.t_min)
        else:
            exploit = 1.0
        return explore + exploit

    def _select(self) -> Node:
        node = self.root
        while True:
            opts = self._expandable(node)
            # Terminate at any node that still has an unmaterialized or
            # zero-rollout child.
            if any(key not in node.children or
                   node.children[key].n_rollouts == 0
                   for key in (self.space.move_key(o) for o in opts)):
                return node
            if not node.children:
                return node  # complete leaf (shouldn't be selected; guard)
            node = max(node.children.values(),
                       key=lambda ch: self._value(node, ch))

    def _expandable(self, node: Node) -> list[BoundOp]:
        if node._expandable is None:
            node._expandable = self.space.moves(node.prefix())
        return node._expandable

    # -- phase 2: expansion ------------------------------------------------
    def _expand(self, node: Node) -> Node:
        opts = self._expandable(node)
        move_key = self.space.move_key
        fresh = [o for o in opts
                 if move_key(o) not in node.children or
                 node.children[move_key(o)].n_rollouts == 0]
        if not fresh:  # fully rolled-out interior node: descend randomly
            return node
        choice = self.rng.choice(fresh)
        key = move_key(choice)
        if key not in node.children:
            node.children[key] = Node(choice, node)
        return node.children[key]

    # -- phase 3: rollout --------------------------------------------------
    def _rollout(self, node: Node) -> tuple[Node, Schedule]:
        """Complete the prefix randomly, materializing path nodes."""
        cur = node
        while True:
            opts = self._expandable(cur)
            if not opts:
                break
            choice = self.rng.choice(opts)
            key = self.space.move_key(choice)
            if key not in cur.children:
                cur.children[key] = Node(choice, cur)
            cur = cur.children[key]
        return cur, self.space.finalize(cur.prefix())

    # -- phase 4: backpropagation -------------------------------------------
    def _backprop(self, leaf: Node, t: float) -> None:
        node: Node | None = leaf
        while node is not None:
            node.n_rollouts += 1
            node.t_min = min(node.t_min, t)
            node.t_max = max(node.t_max, t)
            node = node.parent
        # Mark fully-explored subtrees bottom-up.
        node = leaf
        node.fully_explored = True  # complete program leaf
        node = node.parent
        while node is not None:
            opts = self._expandable(node)
            node.fully_explored = (
                len(node.children) == len(opts) and
                all(c.fully_explored for c in node.children.values()))
            if not node.fully_explored:
                break
            node = node.parent

    def _materialize(self, schedule: Schedule) -> Node:
        """Walk (creating as needed) the tree path for ``schedule``."""
        node = self.root
        for item in self.space.candidate_moves(schedule):
            key = self.space.move_key(item)
            if key not in node.children:
                node.children[key] = Node(item, node)
            node = node.children[key]
        return node

    # -- strategy protocol ---------------------------------------------------
    def propose(self, budget: int) -> list[Schedule]:
        out: list[Schedule] = []
        for _ in range(budget):
            if self.root.fully_explored:
                break
            node = self._select()
            node = self._expand(node)
            leaf, schedule = self._rollout(node)
            self._pending[self.space.candidate_key(schedule)] = leaf
            out.append(schedule)
        return out

    def observe(self, schedule: Schedule, time: float) -> None:
        leaf = self._pending.pop(self.space.candidate_key(schedule),
                                 None)
        if leaf is None:
            # Re-observation or an externally produced schedule: its tree
            # path is the schedule itself.
            leaf = self._materialize(schedule)
        self._backprop(leaf, time)

    def exhausted(self) -> bool:
        return self.root.fully_explored
