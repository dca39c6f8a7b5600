"""The port's serving scheduler starts a queued phase no earlier than the
cycle it was queued at (``repro_torch.core.sim.serving``, the port's fifth
departure from ``repro.core.sim.serving``).

``core_step`` runs a core ahead of the event clock, so a core can report
idle at its own clock while a phase queued later in event order waits on
its CC.  JAX's scheduler starts that phase at the popping core's clock, and
under ``disagg_prefill`` a decode phase can then begin before its prefill
ended; the port starts it at ``max(core clock, ready cycle)``.  Where no
queued phase would start early, both give the same ``Metrics`` by ``repr``.
"""
import dataclasses
import itertools

import pytest

import repro.core.sim as J
import repro_torch.core.sim as P
from repro_torch.core.sim import serving as p_serving

# tests/test_serving.py::_cfg: 2 CCs, 6 requests, st phases
BASE = dict(n_ccs=2, link_bw_frac=0.5, n_requests=6, prefill_workload="st",
            decode_workload="st", prefill_accesses=128, decode_steps=2, decode_accesses=64)
# one of test_serving.py::test_request_conservation_at_drain's own draws that
# JAX's scheduler fails: request 4's decode starts 8620 cycles early
EARLY = dict(offered_load=149.0, serving_router="disagg_prefill")
EARLY_SCHEME, EARLY_SEED = "daemon", 29

# (load, router, scheme, seed): every router and scheme at a light, a middle
# and the heaviest load of the property test's range; (60, disagg_prefill,
# cacheline, 13) and (149, disagg_prefill, daemon, 29) hold a queued phase
# that JAX starts early, every other cell none
GRID = list(itertools.product((5.0, 60.0, 149.0), J.SERVING_ROUTERS, ("cacheline", "daemon"),
                              (0, 13, 29)))


def in_order(r) -> bool:
    return r["arrival"] <= r["t_start"] <= r["t_prefill_done"] <= r["t_done"]


def canon(m) -> str:
    return repr(dataclasses.asdict(m))


def test_early_start_jax_out_of_order_port_in_order():
    m_j = J.serve_one(J.SimConfig(**BASE, **EARLY), EARLY_SCHEME, seed=EARLY_SEED)
    m_p = P.serve_one(P.SimConfig(**BASE, **EARLY), EARLY_SCHEME, seed=EARLY_SEED)
    j4, p4 = m_j.requests[4], m_p.requests[4]
    # JAX: the decode phases drained 4394 cycles before the prefill ended
    assert j4["t_done"] < j4["t_prefill_done"]
    assert j4["t_prefill_done"] - j4["t_done"] > 4000
    # the port: the same request in order, its decode queued at the prefill's end
    assert in_order(p4)
    assert p4["t_prefill_done"] == j4["t_prefill_done"]
    assert p4["t_done"] > p4["t_prefill_done"]
    assert all(in_order(r) for r in m_p.requests)
    # the requests before it never waited on a queue and stay JAX's to the bit
    assert m_p.requests[:4] == m_j.requests[:4]


@pytest.mark.parametrize("load,router,scheme,seed", GRID)
def test_request_conservation_at_drain(load, router, scheme, seed, monkeypatch):
    """The port's twin of tests/test_serving.py's drain property over a fixed
    grid: every offered request completes exactly once with a monotone
    lifecycle, no popped phase starts before it was queued, and the cells
    where no queued phase was ready after the popping core's clock equal
    JAX's ``Metrics`` by ``repr``."""
    popped = []  # (core clock, ready cycle) of every phase popped from a queue
    park = p_serving.ServingScheduler._park

    def watched(self, core, t):
        q = self._queues[core.cc]
        if q:
            popped.append((t, q[0][2]))
        return park(self, core, t)

    monkeypatch.setattr(p_serving.ServingScheduler, "_park", watched)
    kw = dict(BASE, offered_load=load, serving_router=router)
    m = P.serve_one(P.SimConfig(**kw), scheme, seed=seed)
    assert m.requests_completed == m.requests_offered == 6
    assert sorted(r["rid"] for r in m.requests) == list(range(6))
    for r in m.requests:
        assert in_order(r), r
        assert r["latency"] > 0
    early = [p for p in popped if p[1] > p[0]]
    m_j = J.serve_one(J.SimConfig(**kw), scheme, seed=seed)
    if not early:
        assert canon(m) == canon(m_j)
    else:
        # the same arrivals and routing; only the shifted phases' times move
        for mine, theirs in zip(m.requests, m_j.requests):
            assert (mine["rid"], mine["arrival"], mine["prefill_cc"], mine["decode_cc"]) == \
                   (theirs["rid"], theirs["arrival"], theirs["prefill_cc"], theirs["decode_cc"])
    assert bool(early) == ((load, router, scheme, seed) in {
        (60.0, "disagg_prefill", "cacheline", 13), (149.0, "disagg_prefill", "daemon", 29)})
