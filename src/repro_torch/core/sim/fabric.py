"""Topology-aware network fabric (DESIGN.md §2.11).

The flat link model (engine.py) gives each MC one private downlink (and,
with ``uplink_bw``, one private uplink) to the compute side — the binding
constraint is always the endpoint link.  At fleet scale the binding
constraint is fabric *oversubscription* between pooled compute and memory:
CC<->MC transfers cross shared switch trunks provisioned below the
aggregate endpoint bandwidth.  This module generalizes the fluid-link
machinery into a routed graph of directed port links, following the CCL
Simulator model (SNIPPETS.md §1):

- every CC->MC and MC->CC transfer resolves to an explicit multi-hop
  *path* of directed ports;
- forwarding is store-and-forward: a transfer fully drains one port, sits
  ``switch_lat`` cycles in the switch, then queues on the next port;
- each port is a single-server output queue with fluid arbitration across
  all flows sharing it (round-robin packet arbitration in the fluid
  limit) — the same link classes the flat model uses, so DaeMon's
  dual-queue line/page partitioning is preserved end-to-end on every hop
  while FIFO baselines get FIFO ports;
- no congestion control, no loss (as in the CCL model).

A topology is a registered builder function producing a
:class:`TopologySpec` — the port list plus the (mc, cc) -> path tables:

    @register_topology("direct", description="...")
    def _direct(*, n_ccs, n_mcs, oversub):
        ...

``direct`` reproduces today's flat per-MC links as 1-hop paths
(bit-identical to ``topology=None``); ``single_switch`` routes everything
through one non-blocking switch; ``two_tier`` adds leaf->spine trunks
provisioned at ``aggregate_endpoint_bw / oversub`` — the oversubscription
regime the sweep in benchmarks/fig10_topology.py measures.

This module is deliberately free of imports from the rest of the package
(config.py imports it for validation): the :class:`Fabric` runtime takes
an injected event engine and per-port link factories, so the engine — not
this module — decides which arbitration class backs each port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "PortSpec",
    "TopologySpec",
    "Fabric",
    "FabricRoute",
    "register_topology",
    "unregister_topology",
    "get_topology",
    "available_topologies",
    "topology_description",
    "build_topology",
]


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PortSpec:
    """One directed port link of a topology.

    ``bw_frac`` scales the direction's endpoint bandwidth (``link_bw`` for
    down ports, ``uplink_bw`` for up ports) — a trunk aggregating k
    endpoint links at oversubscription O declares ``bw_frac = k / O``.
    ``mc`` attaches that MC's :class:`~repro_torch.core.sim.engine.LinkSchedule`
    (network weather stays per-MC-link, as in the flat model; switch-
    internal trunks are weather-free).  ``switch`` marks switch-owned
    ports, whose arbitration follows the policy's ``fabric`` component
    instead of the endpoint ``partitioning``/``uplink`` components."""

    name: str
    down: bool  # MC->CC direction (False: CC->MC)
    bw_frac: float = 1.0
    mc: Optional[int] = None
    switch: bool = False


@dataclass(frozen=True)
class TopologySpec:
    """A built topology: the ports plus the per-(endpoint pair) paths.

    ``down_paths[(mc, cc)]`` / ``up_paths[(cc, mc)]`` are tuples of port
    names crossed in order; within one topology every path of a direction
    has the same hop count."""

    name: str
    n_ccs: int
    n_mcs: int
    oversub: float
    ports: Tuple[PortSpec, ...]
    down_paths: Dict[Tuple[int, int], Tuple[str, ...]]
    up_paths: Dict[Tuple[int, int], Tuple[str, ...]]

    def validate(self) -> "TopologySpec":
        names = [p.name for p in self.ports]
        if len(set(names)) != len(names):
            raise ValueError(f"topology {self.name!r}: duplicate port names")
        by_name = {p.name: p for p in self.ports}
        for (table, down) in ((self.down_paths, True), (self.up_paths, False)):
            pairs = {(a, b) for a in range(self.n_mcs if down else self.n_ccs)
                     for b in range(self.n_ccs if down else self.n_mcs)}
            if set(table) != pairs:
                raise ValueError(
                    f"topology {self.name!r}: "
                    f"{'down' if down else 'up'}_paths must cover exactly "
                    f"every (mc, cc) pair")
            for path in table.values():
                if not path:
                    raise ValueError(f"topology {self.name!r}: empty path")
                for pn in path:
                    p = by_name.get(pn)
                    if p is None:
                        raise ValueError(
                            f"topology {self.name!r}: path references "
                            f"undeclared port {pn!r}")
                    if p.down != down:
                        raise ValueError(
                            f"topology {self.name!r}: port {pn!r} used "
                            f"against its direction")
        return self


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

# name -> (builder(*, n_ccs, n_mcs, oversub) -> TopologySpec, description)
_TOPOLOGIES: Dict[str, Tuple[Callable[..., TopologySpec], str]] = {}


def register_topology(name: str, *, description: str = "",
                      overwrite: bool = False):
    """Decorator: register a topology builder under ``name``.  The builder
    takes keyword-only ``n_ccs``, ``n_mcs``, ``oversub`` and returns a
    :class:`TopologySpec`."""
    if not name or "+" in name or "/" in name:
        raise ValueError(f"bad topology name {name!r}")

    def deco(fn: Callable[..., TopologySpec]):
        if name in _TOPOLOGIES and not overwrite:
            raise ValueError(
                f"topology {name!r} already registered "
                f"(pass overwrite=True to replace)")
        _TOPOLOGIES[name] = (fn, description)
        return fn

    return deco


def unregister_topology(name: str) -> None:
    """Remove a registered topology (tests / experimentation)."""
    _TOPOLOGIES.pop(name, None)


def get_topology(name: str) -> Callable[..., TopologySpec]:
    """Resolve a topology builder; unknown names fail fast listing choices."""
    entry = _TOPOLOGIES.get(name)
    if entry is None:
        raise KeyError(
            f"unknown topology {name!r}; registered topologies: "
            f"{', '.join(available_topologies())}")
    return entry[0]


def available_topologies() -> Tuple[str, ...]:
    return tuple(_TOPOLOGIES)


def topology_description(name: str) -> str:
    entry = _TOPOLOGIES.get(name)
    if entry is None:
        raise KeyError(
            f"unknown topology {name!r}; registered topologies: "
            f"{', '.join(available_topologies())}")
    return entry[1]


def build_topology(name: str, *, n_ccs: int, n_mcs: int,
                   oversub: float = 1.0) -> TopologySpec:
    """Build and validate the named topology for a system shape."""
    if n_ccs < 1 or n_mcs < 1:
        raise ValueError(f"n_ccs={n_ccs} / n_mcs={n_mcs} must be >= 1")
    if oversub < 1.0:
        raise ValueError(f"oversub={oversub} must be >= 1.0")
    return get_topology(name)(n_ccs=n_ccs, n_mcs=n_mcs,
                              oversub=oversub).validate()


# --------------------------------------------------------------------------
# built-in topologies
# --------------------------------------------------------------------------


@register_topology("direct", description=(
        "flat per-MC point-to-point links (the legacy model as 1-hop "
        "paths; oversub is inert)"))
def _direct(*, n_ccs: int, n_mcs: int, oversub: float) -> TopologySpec:
    ports = []
    down_paths, up_paths = {}, {}
    for j in range(n_mcs):
        ports.append(PortSpec(f"d:mc{j}", down=True, mc=j))
        ports.append(PortSpec(f"u:mc{j}", down=False, mc=j))
        for i in range(n_ccs):
            down_paths[(j, i)] = (f"d:mc{j}",)
            up_paths[(i, j)] = (f"u:mc{j}",)
    return TopologySpec("direct", n_ccs, n_mcs, oversub, tuple(ports),
                        down_paths, up_paths)


@register_topology("single_switch", description=(
        "one non-blocking switch between all CCs and MCs: per-CC egress "
        "ports aggregate cross-MC traffic (oversub is inert)"))
def _single_switch(*, n_ccs: int, n_mcs: int, oversub: float) -> TopologySpec:
    ports = []
    down_paths, up_paths = {}, {}
    for j in range(n_mcs):
        ports.append(PortSpec(f"d:mc{j}", down=True, mc=j))
        ports.append(PortSpec(f"u:sw>mc{j}", down=False, mc=j, switch=True))
    for i in range(n_ccs):
        ports.append(PortSpec(f"d:sw>cc{i}", down=True, switch=True))
        ports.append(PortSpec(f"u:cc{i}", down=False))
    for j in range(n_mcs):
        for i in range(n_ccs):
            down_paths[(j, i)] = (f"d:mc{j}", f"d:sw>cc{i}")
            up_paths[(i, j)] = (f"u:cc{i}", f"u:sw>mc{j}")
    return TopologySpec("single_switch", n_ccs, n_mcs, oversub, tuple(ports),
                        down_paths, up_paths)


@register_topology("two_tier", description=(
        "leaf/spine: endpoint NICs feed leaf switches whose spine trunks "
        "carry aggregate_endpoint_bw/oversub — the oversubscribed tier"))
def _two_tier(*, n_ccs: int, n_mcs: int, oversub: float) -> TopologySpec:
    """MCs hang off a memory-side leaf, CCs off a compute-side leaf; the
    two leaves exchange traffic through spine trunks provisioned at the
    aggregate endpoint bandwidth of their source tier divided by
    ``oversub`` (oversub=1.0 is non-blocking)."""
    ports = [
        PortSpec("d:leafm>spine", down=True, bw_frac=n_mcs / oversub,
                 switch=True),
        PortSpec("d:spine>leafc", down=True, bw_frac=n_ccs / oversub,
                 switch=True),
        PortSpec("u:leafc>spine", down=False, bw_frac=n_ccs / oversub,
                 switch=True),
        PortSpec("u:spine>leafm", down=False, bw_frac=n_mcs / oversub,
                 switch=True),
    ]
    down_paths, up_paths = {}, {}
    for j in range(n_mcs):
        ports.append(PortSpec(f"d:mc{j}", down=True, mc=j))
        ports.append(PortSpec(f"u:leafm>mc{j}", down=False, mc=j,
                              switch=True))
    for i in range(n_ccs):
        ports.append(PortSpec(f"d:leafc>cc{i}", down=True, switch=True))
        ports.append(PortSpec(f"u:cc{i}", down=False))
    for j in range(n_mcs):
        for i in range(n_ccs):
            down_paths[(j, i)] = (f"d:mc{j}", "d:leafm>spine",
                                  "d:spine>leafc", f"d:leafc>cc{i}")
            up_paths[(i, j)] = (f"u:cc{i}", "u:leafc>spine",
                                "u:spine>leafm", f"u:leafm>mc{j}")
    return TopologySpec("two_tier", n_ccs, n_mcs, oversub, tuple(ports),
                        down_paths, up_paths)


# --------------------------------------------------------------------------
# runtime
# --------------------------------------------------------------------------


class FabricRoute:
    """Legacy-link facade over one direction of the fabric for one MC: the
    engine keeps calling ``links[mc].send(t, size, cb, cls, flow)`` /
    ``uplinks[mc].backlog(t)`` and this facade resolves the flow's path,
    forwards the transfer hop by hop (store-and-forward: each port fully
    drains the transfer, then ``switch_lat`` cycles of switch processing,
    then the next port), and fires ``cb`` when the LAST hop's transmission
    completes — the caller adds the end-to-end propagation ``net_lat``
    afterwards, exactly as with a flat link.  On 1-hop paths (``direct``)
    the event sequence is identical to the flat link's, bit for bit."""

    def __init__(self, fabric: "Fabric", direction: str,
                 paths: Dict[int, Tuple[str, ...]]):
        self.fabric = fabric
        self.direction = direction
        self.paths = paths
        seen: Dict[str, None] = {}
        for path in paths.values():
            for pn in path:
                seen.setdefault(pn)
        self.port_names: Tuple[str, ...] = tuple(seen)

    def send(self, t: float, size: float, cb: Callable[[float], None],
             cls: str = "line", flow: int = 0):
        fab = self.fabric
        path = self.paths[flow]
        last = len(path) - 1
        fab.sent[self.direction] += size

        def final(a: float):
            fab.delivered[self.direction] += size
            cb(a)

        def hop(i: int, tt: float):
            port = fab.ports[path[i]]
            if i == last:
                port.send(tt, size, final, cls, flow)
            else:
                port.send(
                    tt, size,
                    lambda a, _i=i: fab.eng.at(
                        a + fab.switch_lat, lambda b, _j=_i: hop(_j + 1, b)),
                    cls, flow)

        hop(0, t)

    def backlog(self, t: float) -> float:
        """Outstanding bytes across every port this route crosses (the
        congestion signal writeback compression keys off, DESIGN.md §2.7
        — aggregated over the hops rather than one flat queue)."""
        ports = self.fabric.ports
        return sum(ports[pn].backlog(t) for pn in self.port_names)


class Fabric:
    """Instantiated topology: one link object per port (built by the
    injected ``port_link`` factory, so the engine picks the arbitration
    class per port) plus per-direction byte-conservation counters —
    ``sent[d] == delivered[d]`` once the event heap drains, however many
    hops each transfer crossed."""

    def __init__(self, eng, spec: TopologySpec, switch_lat: float,
                 port_link: Callable[[PortSpec], object], *,
                 include_up: bool = True):
        self.eng = eng
        self.spec = spec
        self.switch_lat = float(switch_lat)
        self.ports: Dict[str, object] = {}
        for p in spec.ports:
            if not p.down and not include_up:
                continue  # folded request path: no up ports exist
            self.ports[p.name] = port_link(p)
        self.sent = {"down": 0.0, "up": 0.0}
        self.delivered = {"down": 0.0, "up": 0.0}

    def down_route(self, mc: int) -> FabricRoute:
        return FabricRoute(self, "down", {
            cc: self.spec.down_paths[(mc, cc)]
            for cc in range(self.spec.n_ccs)})

    def up_route(self, mc: int) -> FabricRoute:
        return FabricRoute(self, "up", {
            cc: self.spec.up_paths[(cc, mc)]
            for cc in range(self.spec.n_ccs)})

    def up_hops(self, mc: int) -> int:
        """Switch hops on the CC->MC request path (path length - 1) — the
        store-and-forward processing the *folded* request model charges as
        pure latency when no explicit uplink exists."""
        return len(self.spec.up_paths[(0, mc)]) - 1
