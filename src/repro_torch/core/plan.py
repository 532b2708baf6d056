"""Query-plan IR + compiler: multi-way join DAGs as first-class objects.

The paper's operator is an aggregate over an *n*-way equi-join within a
budget (§2, §4).  This module lifts that one level up the stack, the way
the Conclave snippet does for Spark codegen: a :class:`Plan` is a small DAG
of :class:`PlanNode` s, each naming its inputs (registered datasets or
earlier nodes), its aggregate, and its own error/latency budget.

The compiler's central move is **flattening**: a node that references
another node imports that node's *leaf dataset set*, so every node compiles
to a single fused n-way ApproxJoin stage with the cascaded Bloom
intersection (:func:`repro_torch.core.bloom.intersect_all`) of ALL leaf filters
pushed down before any shuffle — a binary join tree never materializes an
intermediate.  On an equi-join chain ``(A ⋈ B) ⋈ C`` the fused 3-way stage
is semantically the same query, and pushing the full 3-way AND below the
shuffle strictly dominates the 2-way-at-a-time filter a binary tree can
apply (quantified by :func:`node_bytes_model`).

Budget propagation rule: a node's budget/aggregate governs exactly its own
fused stage.  A referenced node is *also* an output — it still executes its
own aggregate under its own budget as a separate stage — referencing it
only donates its leaf set to the referencing node.

Execution lives in the engine (``JoinServer.compile_plan`` /
``submit_plan``): each compiled node becomes an ordinary engine request
over the concatenated leaf relations, so plan results are bit-identical to
the equivalent composed direct ``approx_join`` calls by construction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

from repro_torch.core import bloom
from repro_torch.core.budget import QueryBudget
from repro_torch.core.join import TUPLE_BYTES, filter_exchange_bytes
from repro_torch.core.relation import Relation, sort_by_key
from repro_torch.core.sampling import build_strata, exact_count


@dataclass(frozen=True)
class PlanNode:
    """One join+aggregate in the DAG.

    ``inputs`` name registered datasets or EARLIER nodes of the same plan
    (node names shadow dataset names, so a plan can safely reuse a dataset's
    name for a derived node).  Forward references are rejected — the node
    order is the topological order, so the DAG property holds by
    construction.
    """

    name: str
    inputs: Tuple[str, ...]
    budget: QueryBudget = QueryBudget()
    agg: str = "sum"
    expr: str = "sum"
    max_strata: Optional[int] = None
    b_max: int = 2048
    dedup: bool = False
    use_kernels: bool = False
    fp_rate: float = 0.01

    def __post_init__(self):
        object.__setattr__(self, "inputs", tuple(self.inputs))
        if not self.name:
            raise ValueError("PlanNode needs a non-empty name")
        if "/" in self.name:
            raise ValueError(
                f"PlanNode name {self.name!r} may not contain '/' (reserved "
                "for the engine's plan-id/node-id query ids)")
        if len(self.inputs) < 1:
            raise ValueError(f"PlanNode {self.name!r} has no inputs")

    def signature(self) -> tuple:
        return (self.name, self.inputs, tuple(self.budget), self.agg,
                self.expr, self.max_strata, self.b_max, self.dedup,
                self.use_kernels, self.fp_rate)


@dataclass(frozen=True)
class Plan:
    """An ordered DAG of :class:`PlanNode` s (order = topological order)."""

    nodes: Tuple[PlanNode, ...]

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(self.nodes))
        if not self.nodes:
            raise ValueError("Plan needs at least one node")
        seen: set = set()
        for node in self.nodes:
            if node.name in seen:
                raise ValueError(f"duplicate plan node name {node.name!r}")
            for inp in node.inputs:
                if inp == node.name:
                    raise ValueError(
                        f"plan node {node.name!r} references itself")
            seen.add(node.name)

    def signature(self) -> tuple:
        """Hashable identity for the engine's compiled-plan cache."""
        return tuple(n.signature() for n in self.nodes)

    def hierarchy(self) -> Dict[str, List[str]]:
        """Node name -> directly referenced earlier-node names.

        The plan's span hierarchy: the engine's tracer records one query
        span per node and tags the plan's submit instant with these edges,
        so trace consumers (``launch/trace_dump.py``) can nest each node's
        span under the nodes that reference it.  Inputs that resolve as
        datasets (no earlier node of that name) are leaves and excluded.
        """
        earlier: set = set()
        edges: Dict[str, List[str]] = {}
        for node in self.nodes:
            edges[node.name] = [i for i in node.inputs if i in earlier]
            earlier.add(node.name)
        return edges

    def leaf_inputs(self, name: str) -> Tuple[str, ...]:
        """Flattened, order-preserving leaf dataset set of a node.

        Only EARLIER nodes resolve as node references (node order is the
        topological order); a same-named later node reads as a dataset
        name, so the expansion can never cycle.
        """
        earlier: Dict[str, PlanNode] = {}
        target = None
        for n in self.nodes:
            if n.name == name:
                target = n
                break
            earlier[n.name] = n
        if target is None:
            raise ValueError(f"unknown plan node {name!r}")

        def leaves(node: PlanNode) -> List[str]:
            out: List[str] = []
            for inp in node.inputs:
                ref = earlier.get(inp)
                if ref is not None and ref is not node:
                    out.extend(leaves(ref))
                else:
                    out.append(inp)
            return out

        seen: set = set()
        flat: List[str] = []
        for leaf in leaves(target):
            if leaf not in seen:
                seen.add(leaf)
                flat.append(leaf)
        return tuple(flat)


class CompiledNode(NamedTuple):
    node: PlanNode
    datasets: Tuple[str, ...]   # flattened leaf dataset names
    n_rels: int                 # relations after dataset expansion


class CompiledPlan(NamedTuple):
    plan: Plan
    nodes: Tuple[CompiledNode, ...]
    # per node name: modeled shuffle bytes with full cascaded pushdown vs a
    # left-deep binary tree (2-way filters only), plus the live overlap
    # fraction (feeds psum bucket planning as the request's overlap hint)
    bytes_model: Dict[str, dict]


def compile_plan(plan: Plan, datasets: Mapping[str, Sequence[Relation]], *,
                 model_bytes: bool = True, model_seed: int = 0,
                 ) -> CompiledPlan:
    """Resolve, flatten, and cost a plan against registered datasets.

    ``datasets`` maps each registered dataset name to its relation list (a
    registered dataset may hold several relations — its full join input
    set); a leaf contributes *all* its relations to the fused stage, in
    registration order.  Raises typed errors on unknown names and on fused
    stages with fewer than two relations.
    """
    earlier: set = set()
    compiled: List[CompiledNode] = []
    model: Dict[str, dict] = {}
    for node in plan.nodes:
        for inp in node.inputs:
            if inp not in earlier and inp not in datasets:
                raise ValueError(
                    f"plan node {node.name!r} input {inp!r} is neither an "
                    f"earlier plan node nor a registered dataset "
                    f"(known datasets: {sorted(datasets)})")
        earlier.add(node.name)
        leaf_names = plan.leaf_inputs(node.name)
        rels: List[Relation] = []
        for leaf in leaf_names:
            rels.extend(datasets[leaf])
        if len(rels) < 2:
            raise ValueError(
                f"plan node {node.name!r} fuses to {len(rels)} relation(s); "
                "a join stage needs at least two")
        compiled.append(CompiledNode(node, leaf_names, len(rels)))
        if model_bytes:
            model[node.name] = node_bytes_model(
                rels, fp_rate=node.fp_rate, seed=model_seed)
    return CompiledPlan(plan, tuple(compiled), model)


def node_bytes_model(rels: Sequence[Relation], *, fp_rate: float = 0.01,
                     seed: int = 0) -> dict:
    """Modeled shuffle bytes for a fused n-way stage vs a binary join tree.

    ``bytes_pushdown`` charges the paper's §3.1 model for the fused stage:
    every input filtered by the full n-way AND before the shuffle, plus one
    (n + 1) filter exchange.  ``bytes_binary`` models the same query as a
    left-deep binary tree WITHOUT cascaded pushdown: each 2-way stage can
    only AND the two filters it sees, ships its intermediate join result
    into the next stage, and pays its own (2 + 1) filter exchange.  The
    intermediate cardinalities are exact (strata product counts over the
    filtered prefix), not sampled — this is a planning model, computed once
    per compiled plan, never on the serve hot path.

    The binary model is deliberately conservative (it under-counts the
    baseline): stage j's fresh input is charged at its *full-AND* live count
    — fewer rows than the 2-way filter a real binary engine could achieve —
    so ``bytes_pushdown < bytes_binary`` is a lower bound on the real win.
    """
    n = len(rels)
    cap = max(r.capacity for r in rels)
    num_blocks = bloom.num_blocks_for(cap, fp_rate)
    fbytes = num_blocks * bloom.WORDS_PER_BLOCK * 4
    filters = [bloom.build(r.keys, r.valid, num_blocks, seed) for r in rels]
    total = sum(int(r.count().item()) for r in rels)

    def live_under(filter_idxs, j):
        """Rows of rels[j] surviving the AND of the named filters."""
        jf = bloom.intersect_all([filters[i] for i in filter_idxs])
        keep = rels[j].valid & bloom.contains(jf, rels[j].keys)
        return int(keep.sum().item())

    every = tuple(range(n))
    live_full = [live_under(every, j) for j in range(n)]
    bytes_pushdown = (sum(live_full) * TUPLE_BYTES
                      + int(filter_exchange_bytes(n, fbytes)))

    def prefix_join_count(j):
        """|rels[0] ⋈ ... ⋈ rels[j-1]| restricted to keys live under the
        first j+1 filters — the intermediate a binary tree ships into
        stage j after that stage's own 2-way filter."""
        jf = bloom.intersect_all(filters[: j + 1])
        live = [Relation(r.keys, r.values,
                         r.valid & bloom.contains(jf, r.keys))
                for r in rels[:j]]
        strata = build_strata([sort_by_key(r) for r in live], cap)
        return int(exact_count(strata).item())

    bytes_binary = 0
    for j in range(1, n):
        left = (live_under((0, 1), 0) if j == 1 else prefix_join_count(j))
        right = live_under(tuple(range(j + 1)), j)
        bytes_binary += ((left + right) * TUPLE_BYTES
                         + int(filter_exchange_bytes(2, fbytes)))

    return dict(
        n=n, filter_bytes=fbytes,
        live_counts=live_full, total_count=total,
        overlap=sum(live_full) / max(total, 1),
        bytes_pushdown=bytes_pushdown, bytes_binary=bytes_binary,
        reduction_x=bytes_binary / max(bytes_pushdown, 1),
    )
