"""OP-DAG intermediate representation (FusionLLM §3.3–3.4).

The model is a directed acyclic graph of operators.  Each node (``OpNode``)
is one operator (layer); each directed edge carries an ``OpData`` payload:
activations during forward propagation (FP) and boundary gradients during
backward propagation (BP).  The graph is partitioned into ``SubDag``s which
are deployed onto CompNodes (paper Table 2 / Table 3).

PyTorch mapping: every OpNode owns an ``init_fn(gen, *in_shapes) -> params``
(``gen`` a ``torch.Generator``; the tensors land on its device) and a
functional ``apply_fn(params, *inputs) -> output`` over nested dicts of
tensors.  The graph itself is framework-agnostic metadata; execution
happens in :mod:`repro_torch.core.rad` (stage-local autograd — the paper's
remote automatic differentiation) and :mod:`repro_torch.core.executor` (the
multi-CompNode event-driven runtime).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.check.errors import Finding, GraphCheckError

Shape = Tuple[int, ...]


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict/list/tuple tree, in insertion order."""
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def split_generator(gen: torch.Generator, n: int) -> List[torch.Generator]:
    """``n`` new generators on ``gen``'s device, seeded from draws of
    ``gen`` (which advances)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen,
                          device=gen.device).tolist()
    out = []
    for s in seeds:
        g = torch.Generator(device=gen.device)
        g.manual_seed(int(s))
        out.append(g)
    return out


class OpType(enum.Enum):
    """Operator classes from paper Table 2."""

    PLACEHOLDER = "placeholder"       # graph inputs (Input, Label, patch/frame embeds)
    VARIABLE = "variable"             # free tensors (paper's "Tensor A")
    PARAMETRIC = "parametric"         # has trainable params (Conv, Linear, Block, ...)
    NON_PARAMETRIC = "non_parametric" # pure function (ReLU, Add, reshape, ...)
    LOSS = "loss"                     # loss function (CE); BP root


@dataclasses.dataclass
class OpData:
    """Unified inter-operator message (paper §3.4).

    One instance is produced per (producer-op, micro-batch, iteration) and
    consumed by every OP user of that producer.  ``compress_cfg`` carries the
    compression meta-information negotiated by the broker for the link this
    message travels on.
    """

    name: str                         # originating OP node
    op_users: Tuple[str, ...]         # consumers of this output
    actual_op_user: Optional[str] = None  # for gradients: which user produced them
    is_loss: bool = False
    require_grad: bool = True
    local_iter: int = 0
    micro_batch: int = 0
    compress_cfg: Optional[Mapping[str, Any]] = None
    payload: Any = None               # the tensor (or compressed tuple)

    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in tree_leaves(self.payload)))


@dataclasses.dataclass
class OpNode:
    """One operator in the OP-DAG.

    ``args`` lists the producer nodes whose outputs this op consumes, in
    positional order (paper Table 2 "Args").  ``init_fn``/``apply_fn`` are
    pure JAX functions; ``flops_fn`` returns the forward FLOP count given the
    input shapes (estimator C(f,p) numerator, paper §3.5); ``out_shape_fn``
    infers the output shape so the broker can size every edge *before*
    execution (needed for the α–β communication estimate and AdaTopK).
    """

    name: str
    op_type: OpType
    args: Tuple[str, ...] = ()
    init_fn: Optional[Callable[..., Any]] = None        # (rng, *in_shapes) -> params
    apply_fn: Optional[Callable[..., Any]] = None       # (params, *inputs) -> out
    out_shape_fn: Optional[Callable[..., Shape]] = None  # (*in_shapes) -> shape
    flops_fn: Optional[Callable[..., float]] = None      # (*in_shapes) -> flops
    out_dtype: Any = np.float32
    n_params_fn: Optional[Callable[..., int]] = None     # (*in_shapes) -> param count
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def is_parametric(self) -> bool:
        return self.op_type is OpType.PARAMETRIC

    def infer_out_shape(self, *in_shapes: Shape) -> Shape:
        if self.out_shape_fn is None:
            if len(in_shapes) == 1:
                return in_shapes[0]
            raise ValueError(f"op {self.name}: no out_shape_fn and {len(in_shapes)} inputs")
        return tuple(self.out_shape_fn(*in_shapes))

    def flops(self, *in_shapes: Shape) -> float:
        if self.flops_fn is None:
            return 0.0
        return float(self.flops_fn(*in_shapes))


class OpGraph:
    """The OP-DAG (paper Fig. 3).

    Nodes are held in insertion order; :meth:`topo_order` validates acyclicity.
    ``users`` is the reverse-edge map (paper Table 2 "OP users").
    """

    def __init__(self, name: str = "opgraph"):
        self.name = name
        self.nodes: Dict[str, OpNode] = {}

    # ------------------------------------------------------------- building
    def add(self, node: OpNode) -> OpNode:
        findings = []
        if node.name in self.nodes:
            findings.append(Finding(
                "duplicate-op", node.name,
                f"duplicate op name {node.name!r} in graph {self.name!r}"))
        for a in node.args:
            if a not in self.nodes:
                findings.append(Finding(
                    "dangling-dep", node.name,
                    f"op {node.name!r} arg {a!r} not yet defined "
                    "(add producers before consumers)"))
        if findings:
            raise GraphCheckError(
                f"cannot add op {node.name!r}", findings=findings)
        self.nodes[node.name] = node
        return node

    def __contains__(self, name: str) -> bool:
        return name in self.nodes

    def __getitem__(self, name: str) -> OpNode:
        return self.nodes[name]

    def __len__(self) -> int:
        return len(self.nodes)

    # ------------------------------------------------------------ structure
    @property
    def users(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for node in self.nodes.values():
            for a in node.args:
                out[a].append(node.name)
        return out

    def topo_order(self) -> List[str]:
        """Kahn's algorithm; raises on cycles. Insertion order is the tiebreak
        so chains keep their natural layer order."""
        indeg = {n: len(self.nodes[n].args) for n in self.nodes}
        users = self.users
        ready = [n for n in self.nodes if indeg[n] == 0]
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for u in users[n]:
                indeg[u] -= 1
                if indeg[u] == 0:
                    ready.append(u)
        if len(order) != len(self.nodes):
            raise ValueError("OP-DAG contains a cycle")
        return order

    def placeholders(self) -> List[str]:
        return [n for n, v in self.nodes.items() if v.op_type is OpType.PLACEHOLDER]

    def loss_nodes(self) -> List[str]:
        return [n for n, v in self.nodes.items() if v.op_type is OpType.LOSS]

    def max_degree(self) -> int:
        """Paper Observation 1: deep-model DAG degree is usually small (<2)."""
        users = self.users
        return max([len(u) for u in users.values()] +
                   [len(v.args) for v in self.nodes.values()] + [0])

    # -------------------------------------------------------------- shapes
    def infer_shapes(self, input_shapes: Mapping[str, Shape]) -> Dict[str, Shape]:
        """Propagate shapes from placeholders through the DAG."""
        shapes: Dict[str, Shape] = {}
        for n in self.topo_order():
            node = self.nodes[n]
            if node.op_type is OpType.PLACEHOLDER:
                if n not in input_shapes:
                    raise ValueError(f"missing input shape for placeholder {n!r}")
                shapes[n] = tuple(input_shapes[n])
            elif node.op_type is OpType.VARIABLE:
                shapes[n] = tuple(node.meta["shape"])
            else:
                shapes[n] = node.infer_out_shape(*[shapes[a] for a in node.args])
        return shapes

    def annotate(self, input_shapes: Mapping[str, Shape],
                 activation_itemsize: int = 4) -> Dict[str, "OpProfile"]:
        """Per-op forward FLOPs + output bytes + param counts (broker-side
        profiling; feeds the workload estimator §3.5)."""
        shapes = self.infer_shapes(input_shapes)
        out: Dict[str, OpProfile] = {}
        for n in self.topo_order():
            node = self.nodes[n]
            in_shapes = [shapes[a] for a in node.args]
            flops = node.flops(*in_shapes)
            n_params = int(node.n_params_fn(*in_shapes)) if node.n_params_fn else 0
            out_bytes = int(np.prod(shapes[n])) * activation_itemsize if shapes[n] else 0
            out[n] = OpProfile(name=n, out_shape=shapes[n], fwd_flops=flops,
                               out_bytes=out_bytes, n_params=n_params)
        return out

    # ---------------------------------------------------------------- init
    def init(self, gen: torch.Generator, input_shapes: Mapping[str, Shape]
             ) -> Dict[str, Any]:
        """Initialize every parametric op; returns {op_name: params}.  Each
        op draws from its own generator, split off ``gen`` in topological
        order (the counterpart of one ``jax.random.split`` per node)."""
        shapes = self.infer_shapes(input_shapes)
        params: Dict[str, Any] = {}
        for n in self.topo_order():
            node = self.nodes[n]
            if node.init_fn is None:
                continue
            sub, = split_generator(gen, 1)
            params[n] = node.init_fn(sub, *[shapes[a] for a in node.args])
        return params

    # ------------------------------------------------------------- forward
    def apply(self, params: Mapping[str, Any], inputs: Mapping[str, Any],
              variables: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        """Run the full graph on one device; returns all op outputs.

        This is the single-node reference semantics; distributed execution
        (sub-DAGs + message passing) lives in rad.py / executor.py and must
        match this bit-for-bit (tested).
        """
        variables = variables or {}
        vals: Dict[str, Any] = {}
        for n in self.topo_order():
            node = self.nodes[n]
            if node.op_type is OpType.PLACEHOLDER:
                vals[n] = inputs[n]
            elif node.op_type is OpType.VARIABLE:
                vals[n] = variables[n]
            else:
                args = [vals[a] for a in node.args]
                p = params.get(n)
                vals[n] = node.apply_fn(p, *args) if node.apply_fn else args[0]
        return vals


@dataclasses.dataclass(frozen=True)
class OpProfile:
    name: str
    out_shape: Shape
    fwd_flops: float
    out_bytes: int
    n_params: int

    @property
    def bwd_flops(self) -> float:
        # Standard 2x-forward approximation for backprop (dL/dx and dL/dW).
        return 2.0 * self.fwd_flops

    @property
    def param_bytes(self) -> int:
        return self.n_params * 4


@dataclasses.dataclass
class SubDag:
    """A partition of the OP-DAG assigned to one CompNode (paper Table 3).

    The four derived edge sets drive message passing: during FP a CompNode
    waits for ``required_acti`` and pushes ``send_acti``; during BP it waits
    for ``required_grad`` (keyed ``producer->user`` since gradients must be
    identified by which OP generates them *and* which one needs them) and
    pushes ``send_grad``.
    """

    index: int
    node_names: List[str]
    required_acti: List[str] = dataclasses.field(default_factory=list)
    send_acti: List[str] = dataclasses.field(default_factory=list)
    required_grad: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    send_grad: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.node_set = set(self.node_names)
        if len(self.node_set) != len(self.node_names):
            seen: set = set()
            dup = next(n for n in self.node_names
                       if n in seen or seen.add(n))
            raise GraphCheckError(
                f"sub-DAG {self.index} is malformed",
                findings=[Finding(
                    "duplicate-op", dup,
                    f"op {dup!r} listed twice in sub-DAG {self.index}")])


def build_subdags(graph: OpGraph, assignment: Sequence[Sequence[str]]) -> List[SubDag]:
    """Derive Table-3 edge sets for a partition.

    ``assignment[k]`` is the list of op names on sub-DAG k.  Placeholders and
    loss nodes are ordinary ops here — the scheduler decides their placement
    (paper puts Input on CompNode 1 and Label/CE on the last one).
    """
    owner: Dict[str, int] = {}
    findings = []
    for k, names in enumerate(assignment):
        for n in names:
            if n in owner:
                findings.append(Finding(
                    "double-assignment", n,
                    f"op {n!r} assigned to sub-DAGs {owner[n]} and {k}"))
            elif n not in graph:
                findings.append(Finding(
                    "unknown-op", n,
                    f"op {n!r} on sub-DAG {k} is absent from the graph"))
            owner[n] = k
    for n in graph.nodes:
        if n not in owner:
            findings.append(Finding(
                "unassigned-op", n,
                f"op {n!r} is assigned to no sub-DAG"))
    if findings:
        raise GraphCheckError("partition does not cover the OP-DAG",
                              findings=findings)

    subdags = [SubDag(index=k, node_names=list(names))
               for k, names in enumerate(assignment)]
    for n, node in graph.nodes.items():
        for a in node.args:
            if owner[a] != owner[n]:
                producer_grad = graph.nodes[a].op_type not in (
                    OpType.PLACEHOLDER, OpType.VARIABLE)
                # FP: activation a -> n crosses CompNodes
                sd_p, sd_c = subdags[owner[a]], subdags[owner[n]]
                if a not in sd_p.send_acti:
                    sd_p.send_acti.append(a)
                if a not in sd_c.required_acti:
                    sd_c.required_acti.append(a)
                # BP: gradient (a,n) flows back n -> a, unless a is a leaf
                # that requires no gradient (Input / Label placeholders).
                if producer_grad:
                    sd_c.send_grad.append((a, n))
                    sd_p.required_grad.append((a, n))
    return subdags


def chain(graph: OpGraph) -> List[str]:
    """Return the topological order restricted to compute ops (the 'chain'
    view used by the chain partitioners; placeholders/variables excluded)."""
    return [n for n in graph.topo_order()
            if graph.nodes[n].op_type not in (OpType.PLACEHOLDER, OpType.VARIABLE)]
