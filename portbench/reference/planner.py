"""The stage cuts and each edge's Top-K ratio, worked out again from the
configuration and the traffic: a frozen copy of the OP-Fence scheduler and
the uniform and AdaTopK compression plans, as the paper describes them
(FusionLLM section 4 and Eq. 7), for the decoder-only OP-DAG of one node
a block, whatever the block's family.

The reference model reads only what this returns: the op chain cut into
pipeline stages and, for every edge that crosses two stages, the ratio
``r`` that keeps ``ceil(numel / r)`` entries.  Nothing here imports the
program.

The OP-DAG: ``tokens`` and ``labels`` placeholders, then ``embed``,
``block_0`` .. ``block_{L-1}``, ``head`` (norm and logits) and ``loss``.
Each op's forward FLOPs and output bytes (float32) are taken from the
shapes; the scheduler splits the chain over paper testbed 1 (one machine
of 8 RTX 4090 and four of 4 RTX 2080, 24 devices; seed 0) by Louvain
communities of the bandwidth graph, the best path through them, and the
dynamic program that minimises the slowest stage's max(compute, receive).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

from portbench.harness import manifest

# ----------------------------------------------------------- testbed 1 ---
RTX4090, RTX2080 = 165.16e12, 40.0e12          # fp16 tensor FLOP/s sheets


def _bw(mbps: float) -> float:
    return mbps * 1e6 / 8.0


INTRA_MACHINE = (_bw(10_000), 1e-4)            # (bytes/s, alpha seconds)
INTRA_CLUSTER = (_bw(1_000), 1e-3)
INTER_CLUSTER = (_bw(8), 5e-2)


def testbed_1(seed: int = 0, jitter: float = 0.15):
    """(device speeds, links {(i, j): (alpha, beta)} for i < j): cluster A
    is one machine of 8 RTX 4090, cluster B four machines of 4 RTX 2080;
    each device's speed is its sheet times a drawn efficiency, each link's
    bandwidth its tier's times a drawn log-uniform factor."""
    rng = np.random.default_rng(seed)
    speeds: List[float] = []
    machine: List[int] = []
    cluster: List[int] = []
    for g in range(8):
        speeds.append(float(rng.uniform(0.55, 0.75)) * RTX4090)
        machine.append(0)
        cluster.append(0)
    for m in range(1, 5):
        for g in range(4):
            speeds.append(float(rng.uniform(0.5, 0.7)) * RTX2080)
            machine.append(m)
            cluster.append(1)
    links: Dict[Tuple[int, int], Tuple[float, float]] = {}
    n = len(speeds)
    for i in range(n):
        for j in range(i + 1, n):
            if machine[i] == machine[j]:
                bw, alpha = INTRA_MACHINE
            elif cluster[i] == cluster[j]:
                bw, alpha = INTRA_CLUSTER
            else:
                bw, alpha = INTER_CLUSTER
            scale = float(np.exp(rng.uniform(-jitter, jitter)))
            links[(i, j)] = (alpha, 1.0 / (bw * scale))
    return speeds, links


def _link(links, i: int, j: int) -> Tuple[float, float]:
    if i == j:
        return (0.0, 0.0)
    return links[(i, j)] if (i, j) in links else links[(j, i)]


def _seconds(links, i: int, j: int, nbytes: float) -> float:
    alpha, beta = _link(links, i, j)
    return (alpha + beta * float(nbytes)) * 1.0


# ------------------------------------------------------------- Louvain ---
def louvain(weights: np.ndarray, seed: int = 0,
            max_passes: int = 16) -> List[List[int]]:
    """Weighted Louvain (Blondel et al. 2008), nodes visited in an order
    drawn from ``seed``; communities as sorted lists of node indices."""
    w = np.asarray(weights, dtype=np.float64)
    w = (w + w.T) / 2.0
    np.fill_diagonal(w, 0.0)
    members: List[List[int]] = [[i] for i in range(w.shape[0])]
    rng = np.random.default_rng(seed)
    while True:
        n = w.shape[0]
        m2 = w.sum()
        if m2 <= 0:
            break
        k = w.sum(axis=1)
        comm = np.arange(n)
        tot = k.copy()
        improved_any = False
        for _ in range(max_passes):
            improved = False
            for i in rng.permutation(n):
                ci = comm[i]
                nb: Dict[int, float] = {}
                for j in np.nonzero(w[i])[0]:
                    if j != i:
                        nb[comm[j]] = nb.get(comm[j], 0.0) + w[i, j]
                tot[ci] -= k[i]
                best_c, best_gain = ci, 0.0
                base = nb.get(ci, 0.0) - tot[ci] * k[i] / m2
                for c, w_ic in nb.items():
                    gain = (w_ic - tot[c] * k[i] / m2) - base
                    if gain > best_gain + 1e-15:
                        best_gain, best_c = gain, c
                tot[best_c] += k[i]
                if best_c != ci:
                    comm[i] = best_c
                    improved = improved_any = True
            if not improved:
                break
        if not improved_any:
            break
        labels = {c: i for i, c in enumerate(sorted(set(comm.tolist())))}
        nn = len(labels)
        if nn == n:
            break
        new_members: List[List[int]] = [[] for _ in range(nn)]
        for i in range(n):
            new_members[labels[comm[i]]].extend(members[i])
        neww = np.zeros((nn, nn))
        for i in range(n):
            for j in range(n):
                neww[labels[comm[i]], labels[comm[j]]] += w[i, j]
        w, members = neww, new_members
    return [sorted(m) for m in members]


def _path(clusters: List[List[int]], bw: np.ndarray) -> List[int]:
    """The order of the clusters that maximises the weakest link between
    consecutive ones, then their sum (every order tried: at most 6)."""
    nc = len(clusters)
    if nc == 1:
        return [0]
    if nc > 6:
        raise ValueError("more than 6 bandwidth clusters")
    inter = np.zeros((nc, nc))
    for a in range(nc):
        for b in range(nc):
            if a != b:
                inter[a, b] = float(np.mean(
                    [bw[i, j] for i in clusters[a] for j in clusters[b]]))

    def cost(path):
        ls = [inter[path[i], path[i + 1]] for i in range(len(path) - 1)]
        return min(ls) * 1e6 + sum(ls)
    return list(max(itertools.permutations(range(nc)), key=cost))


# ------------------------------------------------------------- the DAG ---
def op_chain(cfg: dict, batch: int, seq: int):
    """[(name, forward FLOPs, output float32 bytes, output numel)] of the
    compute ops, in chain order; a block's FLOPs are its family's
    ``block_flops``."""
    fam = manifest.family(cfg)
    d, L = cfg["d_model"], cfg["n_layers"]
    V = vocab_padded(cfg)
    T = batch * seq
    act = T * d
    ops = [("embed", 0.0, act * 4, act)]
    ops += [(f"block_{i}", fam.block_flops(cfg, i, batch, seq), act * 4, act)
            for i in range(L)]
    ops += [("head", 2.0 * T * d * V, T * V * 4, T * V),
            ("loss", float(T * V), 0, 1)]
    return ops


def vocab_padded(cfg: dict) -> int:
    p = max(cfg["vocab_pad_to"], 1)
    return (cfg["vocab"] + p - 1) // p * p


def _min_bottleneck(ops, speeds, links, device_order) -> List[int]:
    """Chain cut ends (exclusive) of the split of ``ops`` over
    ``device_order`` that minimises max over stages of max(compute seconds,
    seconds to receive the boundary from the stage before)."""
    n, dn = len(ops), len(device_order)
    pre = np.concatenate([[0.0], np.cumsum(
        np.array([o[1] for o in ops], dtype=np.float64))])

    def comp(i, j, k):
        return (pre[j] - pre[i]) / speeds[device_order[k]]

    def recv(i, k):
        if k == 0 or i == 0:
            return 0.0
        src, dst = device_order[k - 1], device_order[k]
        if src == dst:
            return 0.0
        return _seconds(links, src, dst, float(ops[i - 1][2]))

    INF = float("inf")
    best = np.full((n + 1, dn), INF)
    back = np.full((n + 1, dn), -1, dtype=np.int64)
    for j in range(1, n - dn + 2):
        best[j][0] = max(comp(0, j, 0), 0.0)
    for k in range(1, dn):
        for j in range(k + 1, n - (dn - 1 - k) + 1):
            for i in range(k, j):
                if best[i][k - 1] == INF:
                    continue
                pace = max(best[i][k - 1], comp(i, j, k), recv(i, k))
                if pace < best[j][k]:
                    best[j][k] = pace
                    back[j][k] = i
    cuts, j = [n], n
    for k in range(dn - 1, 0, -1):
        j = int(back[j][k])
        cuts.append(j)
    return sorted(cuts)


def plan(cfg: dict, batch: int, seq: int, compress: str, ratio: float,
         testbed: int = 1) -> Dict[str, object]:
    """``{"stages": [[op, ...], ...], "edges": {(producer, consumer):
    ratio}}``: the pipeline's stages in order (placeholders left out) and
    the ratio of each compressed edge, under ``compress`` (``uniform``:
    every crossing edge at ``ratio``; ``adatopk``: Eq. 7 over each edge's
    dense receive seconds, ``3 r R_i / max R``, edges at or below the
    break-even 3 sent dense)."""
    if testbed != 1:
        raise ValueError("only paper testbed 1 is frozen here")
    speeds, links = testbed_1(seed=0)
    n = len(speeds)
    bw = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                bw[i, j] = 1.0 / _link(links, i, j)[1]
    clusters = louvain(bw, seed=0)
    order: List[int] = []
    for c in _path(clusters, bw):
        order.extend(sorted(clusters[c], key=lambda i: -speeds[i]))
    ops = op_chain(cfg, batch, seq)
    order = order[:max(1, min(len(order), len(ops)))]
    cuts = _min_bottleneck(ops, speeds, links, order)
    stages, start = [], 0
    for c in cuts:
        stages.append([o[0] for o in ops[start:c]])
        start = c
    where = {op: s for s, seg in enumerate(stages) for op in seg}
    info = {o[0]: o for o in ops}
    crossing = [(a, b) for a, b in zip([o[0] for o in ops[:-1]],
                                       [o[0] for o in ops[1:]])
                if where[a] != where[b]]
    edges: Dict[Tuple[str, str], float] = {}
    if compress == "uniform":
        edges = {e: float(ratio) for e in crossing}
    elif compress == "adatopk":
        R = np.asarray([_seconds(links, order[where[a]], order[where[b]],
                                 float(info[a][2])) for a, b in crossing],
                       dtype=np.float64)
        be = (4 + 8.0) / 4                      # paper wire at fp32
        raw = be * ratio * R / float(R.max())
        for (a, b), r in zip(crossing, raw):
            if r <= be:
                continue
            numel = info[a][3]
            if ratio_to_k(numel, float(r)) * (4 + 8) >= info[a][2]:
                continue
            edges[(a, b)] = float(r)
    elif compress != "none":
        raise ValueError(f"unknown compression {compress!r}")
    return {"stages": stages, "edges": edges}


def ratio_to_k(numel: int, ratio: float) -> int:
    if ratio <= 1.0:
        return int(numel)
    return max(1, int(np.ceil(numel / ratio)))


def block_k(numel: int, ratio: float, block: int = 4096) -> int:
    """Entries kept in each block of ``block``: the global k split evenly
    over the blocks, rounded up, at most the block."""
    nb = -(-numel // block)
    return int(min(max(-(-ratio_to_k(numel, ratio) // nb), 1), block))


def codec_shapes(cfg: dict, batch: int, seq: int,
                 edges: Dict[Tuple[str, str], float]) -> List[Tuple[int, int]]:
    """(numel, k a block) of each compressed edge's tensor."""
    info = {o[0]: o for o in op_chain(cfg, batch, seq)}
    return [(info[a][3], block_k(info[a][3], r)) for (a, _), r in
            edges.items()]
