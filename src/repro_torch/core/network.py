"""Simulated network topologies (FusionLLM §7.1 testbeds + TPU pods).

The paper evaluates on two physical clusters joined over the Internet:

* Cluster A — 2 machines × 8 RTX 4090
* Cluster B — 8 machines × 4 RTX 2080

with GPU-to-GPU bandwidths spanning 8 Mbps – 10 Gbps (Fig. 9) and four
testbeds (Table 5).  This module reconstructs those topologies as
:class:`ClusterSpec` instances for the scheduler / throughput model /
discrete-event executor, and adds the TPU two-level hierarchy used by the
multi-pod dry-run adaptation (intra-pod ICI vs. inter-pod links).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .estimator import ClusterSpec, DeviceSpec, LinkSpec, make_device


def _bw(mbps: float) -> float:
    """Mbit/s -> bytes/s."""
    return mbps * 1e6 / 8.0


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Bandwidth/latency for one locality tier."""

    bandwidth_Bps: float
    alpha: float

    def link(self) -> LinkSpec:
        return LinkSpec(alpha=self.alpha, beta=1.0 / self.bandwidth_Bps)


# Locality tiers roughly matching paper Fig. 9 (and its §7.1 note that
# intra-machine links deliberately avoid NCCL to mimic slow networks).
TIER_INTRA_MACHINE = TierSpec(bandwidth_Bps=_bw(10_000), alpha=1e-4)   # 10 Gbps
TIER_INTRA_CLUSTER = TierSpec(bandwidth_Bps=_bw(1_000), alpha=1e-3)    # 1 Gbps
TIER_INTER_CLUSTER = TierSpec(bandwidth_Bps=_bw(8), alpha=5e-2)        # 8 Mbps WAN


def paper_testbed(testbed: int = 2, seed: int = 0,
                  jitter: float = 0.15) -> ClusterSpec:
    """Paper Table 5 testbeds.

    testbed=1 : Cluster A 1×8 RTX4090 + Cluster B 4×4 RTX2080 (24 GPUs)
    testbed=2 : Cluster A 2×8 RTX4090 + Cluster B 8×4 RTX2080 (48 GPUs)
    ``jitter`` randomizes per-link bandwidth (log-uniform ±) to mirror the
    measured heterogeneity of Fig. 9.
    """
    if testbed == 1:
        a_machines, b_machines = 1, 4
    elif testbed == 2:
        a_machines, b_machines = 2, 8
    else:
        raise ValueError("testbed in {1, 2}")
    rng = np.random.default_rng(seed)

    devices: List[DeviceSpec] = []
    machine_of: List[int] = []
    cluster_of: List[int] = []
    mid = 0
    for _ in range(a_machines):
        for g in range(8):
            devices.append(make_device(f"A{mid}g{g}", "RTX4090",
                                       lam=float(rng.uniform(0.55, 0.75))))
            machine_of.append(mid)
            cluster_of.append(0)
        mid += 1
    for _ in range(b_machines):
        for g in range(4):
            devices.append(make_device(f"B{mid}g{g}", "RTX2080",
                                       lam=float(rng.uniform(0.5, 0.7))))
            machine_of.append(mid)
            cluster_of.append(1)
        mid += 1

    links: Dict[Tuple[int, int], LinkSpec] = {}
    n = len(devices)
    for i in range(n):
        for j in range(i + 1, n):
            if machine_of[i] == machine_of[j]:
                tier = TIER_INTRA_MACHINE
            elif cluster_of[i] == cluster_of[j]:
                tier = TIER_INTRA_CLUSTER
            else:
                tier = TIER_INTER_CLUSTER
            scale = float(np.exp(rng.uniform(-jitter, jitter)))
            links[(i, j)] = LinkSpec(alpha=tier.alpha,
                                     beta=1.0 / (tier.bandwidth_Bps * scale))
    return ClusterSpec(devices, links)


def homogeneous_lan(n: int = 8, sheet: str = "RTX4090",
                    bandwidth_Bps: float = _bw(10_000),
                    alpha: float = 1e-4) -> ClusterSpec:
    """Flat LAN — the degenerate case where OP-Fence must match
    equal-compute (one Louvain community)."""
    devices = [make_device(f"n{i}", sheet) for i in range(n)]
    link = LinkSpec(alpha=alpha, beta=1.0 / bandwidth_Bps)
    links = {(i, j): link for i in range(n) for j in range(i + 1, n)}
    return ClusterSpec(devices, links)


def geo_random(n: int = 16, n_sites: int = 4, seed: int = 0) -> ClusterSpec:
    """Random geo-distributed volunteers: n GPUs spread over n_sites regions;
    intra-site fast, inter-site slow with distance-dependent α."""
    rng = np.random.default_rng(seed)
    sheets = ["RTX4090", "RTX4080", "RTX3080", "RTX2080"]
    site = rng.integers(0, n_sites, size=n)
    pos = rng.uniform(0.0, 1.0, size=(n_sites, 2))
    devices = [make_device(f"v{i}", sheets[int(rng.integers(len(sheets)))],
                           lam=float(rng.uniform(0.4, 0.8))) for i in range(n)]
    links: Dict[Tuple[int, int], LinkSpec] = {}
    for i in range(n):
        for j in range(i + 1, n):
            if site[i] == site[j]:
                bw = _bw(rng.uniform(1_000, 10_000))
                alpha = 2e-4
            else:
                d = float(np.linalg.norm(pos[site[i]] - pos[site[j]]))
                bw = _bw(rng.uniform(8, 300))
                alpha = 5e-3 + 0.08 * d
            links[(i, j)] = LinkSpec(alpha=alpha, beta=1.0 / bw)
    return ClusterSpec(devices, links)


def fat_pipe_sites(n: int = 8, n_sites: int = 2, seed: int = 0,
                   intra_Bps: float = _bw(1_000), inter_Bps: float = _bw(25),
                   alpha: float = 2e-5, jitter: float = 0.1) -> ClusterSpec:
    """Long-fat-network geo topology: β-dominated links (negligible α on
    every tier), two bandwidth classes, heterogeneous consumer GPUs.

    This is the regime closed-loop link calibration exists for: transport
    seconds scale with payload, so a link silently congesting below its spec
    bandwidth shifts every transfer's observed seconds proportionally — a
    signal :func:`repro_torch.core.costmodel.fit_link_corrections` can fit a clean
    multiplicative correction from (on α-dominated links a bandwidth drop
    barely moves small transfers and hides from the fit).
    """
    rng = np.random.default_rng(seed)
    sheets = ["RTX4090", "RTX4080", "RTX3080", "RTX2080"]
    devices = [make_device(f"f{i}", sheets[i % len(sheets)],
                           lam=float(rng.uniform(0.5, 0.8)))
               for i in range(n)]
    site = [i % n_sites for i in range(n)]
    links: Dict[Tuple[int, int], LinkSpec] = {}
    for i in range(n):
        for j in range(i + 1, n):
            bw = intra_Bps if site[i] == site[j] else inter_Bps
            scale = float(np.exp(rng.uniform(-jitter, jitter)))
            links[(i, j)] = LinkSpec(alpha=alpha, beta=1.0 / (bw * scale))
    return ClusterSpec(devices, links)


# ------------------------------------------------- churn-trace transforms --
def with_slowdowns(cluster: ClusterSpec,
                   factors: Dict[int, float]) -> ClusterSpec:
    """Degraded view of a topology: device i's effective speed is scaled by
    ``factors[i]`` (0 < f ≤ 1; thermal throttling, contention, preemption).

    The elastic runtime uses this twice: the *ground-truth* cluster that a
    scripted ``slowdown`` churn event produces, and the *believed* cluster
    the broker re-plans on once the straggler detector has flagged the node.
    """
    devices = []
    for i, d in enumerate(cluster.devices):
        f = float(factors.get(i, 1.0))
        if f <= 0.0:
            raise ValueError(f"slowdown factor for device {i} must be > 0")
        devices.append(dataclasses.replace(d, lam=d.lam * f))
    return cluster.with_devices(devices)


def with_link_slowdowns(cluster: ClusterSpec,
                        factors: Dict[int, float]) -> ClusterSpec:
    """Degraded links: every link touching device i gets its bandwidth scaled
    by ``factors[i]`` (congestion on the node's uplink).  α is unchanged."""
    links = {}
    for (i, j), lk in cluster.links().items():
        f = float(factors.get(i, 1.0)) * float(factors.get(j, 1.0))
        if f <= 0.0:
            raise ValueError("link slowdown factors must be > 0")
        links[(i, j)] = LinkSpec(alpha=lk.alpha, beta=lk.beta / f)
    return ClusterSpec(list(cluster.devices), links)


def with_shared_links(cluster: ClusterSpec,
                      busy_pairs: Iterable[Tuple[int, int]],
                      foreground_fraction: float = 0.5) -> ClusterSpec:
    """Foreground view of a topology while background bulk transfers run.

    Overlapped migration streams state in the background over specific links;
    each link carrying an active background transfer keeps only
    ``foreground_fraction`` of its bandwidth for foreground boundary traffic
    (fair-share: the transfer slows training, it does not block it).  α is
    unchanged — latency is not consumed by bulk flows.  Contention is
    **per link**, the native granularity of the pairwise α–β model: a bulk
    flow on a fast intra-cluster wire must not throttle the WAN edge the
    pipeline is actually bound by.
    """
    if not (0.0 < foreground_fraction <= 1.0):
        raise ValueError("foreground_fraction in (0, 1]")
    busy = {(int(i), int(j)) for (i, j) in busy_pairs}
    busy |= {(j, i) for (i, j) in busy}
    links = {}
    for (i, j), lk in cluster.links().items():
        if (i, j) in busy:
            lk = LinkSpec(alpha=lk.alpha, beta=lk.beta / foreground_fraction)
        links[(i, j)] = lk
    return ClusterSpec(list(cluster.devices), links)


def tpu_two_pods(chips_per_pod: int = 4, ici_GBps: float = 50.0,
                 dci_GBps: float = 5.0) -> ClusterSpec:
    """TPU adaptation of the geo hierarchy: two pod slices, fast ICI inside,
    ~10× slower inter-pod links — the 'slowest links' AdaTopK targets in the
    multi-pod mapping (DESIGN.md §2)."""
    n = 2 * chips_per_pod
    devices = [make_device(f"pod{i // chips_per_pod}c{i % chips_per_pod}",
                           "TPUv5e") for i in range(n)]
    links: Dict[Tuple[int, int], LinkSpec] = {}
    for i in range(n):
        for j in range(i + 1, n):
            same = (i // chips_per_pod) == (j // chips_per_pod)
            bw = (ici_GBps if same else dci_GBps) * 1e9
            links[(i, j)] = LinkSpec(alpha=1e-6 if same else 1e-4, beta=1.0 / bw)
    return ClusterSpec(devices, links)
