"""The port's DaeMon simulator (``repro_torch.core.sim``) against the JAX
package's (``repro.core.sim``) on the CPU: every ``Metrics`` equal field for
field, with no tolerance (floats compared by ``repr``, which round-trips
every bit), wherever both replay the same trace.

The two differ only at the kernel-stream seams, each pinned by its own test
below: (a) the registered capture catalog, (b) the fig8 / fig9-llm / fig11
kernel streams, (c) ``SimConfig``'s serving-workload defaults and (d) the
kernel-stream entries of ``controller.TUNED_THRESHOLDS``.  Everything else
(config fields, registries, every ``*_spec()``) is compared after mapping
each Hopper stream name onto the Pallas one of the same launch."""
import dataclasses

import pytest

import repro.core.sim as J
import repro_torch.core.sim as P
from repro.core.sim import controller as j_controller
from repro.core.sim import runner as j_runner
from repro_torch.core.sim import controller as p_controller
from repro_torch.core.sim import runner as p_runner

N = 2000
PALLAS = ("fa_prefill", "fa_decode", "mamba_fwd", "bq_quant")
HOPPER = tuple(f"{name}_h100" for name in PALLAS)
TO_PALLAS = dict(zip(HOPPER, PALLAS))


def canon(m) -> str:
    """Every field of a ``Metrics``, floats to the last bit."""
    return repr(dataclasses.asdict(m))


def assert_same(a, b):
    assert canon(a) == canon(b)


def to_pallas(x):
    """``x`` with each Hopper stream name replaced by the Pallas one."""
    if isinstance(x, str):
        return TO_PALLAS.get(x, x)
    if isinstance(x, tuple):
        return tuple(to_pallas(v) for v in x)
    if isinstance(x, list):
        return [to_pallas(v) for v in x]
    if isinstance(x, dict):
        return {to_pallas(k): to_pallas(v) for k, v in x.items()}
    return x


# --------------------------------------------------------------------------
# cells: both simulators on the same synthetic traces
# --------------------------------------------------------------------------


@pytest.mark.parametrize("workload", J.DEFAULT_SUITE)
def test_run_one_every_scheme(workload):
    assert P.DEFAULT_SUITE == J.DEFAULT_SUITE and P.SCHEMES == J.SCHEMES
    for scheme in J.SCHEMES:
        cfg_j, cfg_p = J.SimConfig(link_bw_frac=0.125), P.SimConfig(link_bw_frac=0.125)
        assert_same(J.run_one(workload, scheme, cfg_j, n_accesses=N),
                    P.run_one(workload, scheme, cfg_p, n_accesses=N))


@pytest.mark.parametrize("policy", J.ABLATION_POLICIES + ("daemon_fabfifo", "page_dualq"))
def test_ablation_policies(policy):
    assert P.ABLATION_POLICIES == J.ABLATION_POLICIES
    assert_same(J.run_one("pr", policy, J.SimConfig(link_bw_frac=0.125), n_accesses=N),
                P.run_one("pr", policy, P.SimConfig(link_bw_frac=0.125), n_accesses=N))


@pytest.mark.parametrize("controller", J.CONTROLLERS)
def test_controllers(controller):
    assert P.CONTROLLERS == J.CONTROLLERS
    for workload in ("pr", "st"):
        assert_same(J.run_one(workload, "daemon", J.SimConfig(controller=controller),
                              n_accesses=N),
                    P.run_one(workload, "daemon", P.SimConfig(controller=controller),
                              n_accesses=N))


def test_two_ccs_with_an_uplink():
    kw = dict(n_ccs=2, link_bw_frac=0.25, uplink_bw=2.0)
    for scheme in ("page", "daemon"):
        assert_same(J.run_one("pr+st", scheme, J.SimConfig(**kw), n_accesses=N),
                    P.run_one("pr+st", scheme, P.SimConfig(**kw), n_accesses=N))


@pytest.mark.parametrize("topology", J.TOPOLOGIES)
def test_topologies(topology):
    assert P.TOPOLOGIES == J.TOPOLOGIES
    kw = dict(topology=topology, n_ccs=2, link_bw_frac=0.25, oversub=2.0)
    for scheme in ("page", "daemon", "daemon_fabfifo"):
        assert_same(J.run_one("pr+st", scheme, J.SimConfig(**kw), n_accesses=N),
                    P.run_one("pr+st", scheme, P.SimConfig(**kw), n_accesses=N))


@pytest.mark.parametrize("placement", J.MEM_PLACEMENTS)
def test_finite_memory_pool(placement):
    assert P.MEM_PLACEMENTS == J.MEM_PLACEMENTS
    kw = dict(n_ccs=4, n_mcs=4, link_bw_frac=0.25, mc_interleave=placement,
              mc_capacity_pages=128)
    for scheme in ("page", "daemon"):
        assert_same(J.run_one("dr+st+pr+ml", scheme, J.SimConfig(**kw), n_accesses=N),
                    P.run_one("dr+st+pr+ml", scheme, P.SimConfig(**kw), n_accesses=N))


@pytest.mark.parametrize("router", J.SERVING_ROUTERS)
def test_serving_routers_on_the_graph_tenant(router):
    assert P.SERVING_ROUTERS == J.SERVING_ROUTERS
    assert P.SERVING_TENANTS["graph"] == J.SERVING_TENANTS["graph"] == ("pr", "pr")
    kw = dict(n_ccs=4, link_bw_frac=0.25, serving_router=router, n_requests=8,
              offered_load=16.0, prefill_workload="pr", decode_workload="pr",
              prefill_accesses=256, decode_steps=2, decode_accesses=64)
    for scheme in ("page", "daemon"):
        m_j = J.serve_one(J.SimConfig(**kw), scheme, seed=3)
        m_p = P.serve_one(P.SimConfig(**kw), scheme, seed=3)
        assert len(m_p.requests) == 8 and m_p.requests_offered == 8
        assert m_p.requests == m_j.requests  # the per-request records
        assert_same(m_j, m_p)


@pytest.mark.parametrize("engine", J.ENGINES)
def test_small_sweep_under_each_engine(engine):
    assert P.ENGINES == J.ENGINES
    axes = {"workload": ("pr", "st+ml"), "n_ccs": (1, 2), "link_bw_frac": (0.25, 0.125),
            "scheme": ("page", "daemon")}
    rows_j = J.run_sweep(J.Sweep(name="small", axes=axes, n_accesses=N), workers=1,
                         engine=engine).rows
    rows_p = P.run_sweep(P.Sweep(name="small", axes=axes, n_accesses=N), workers=1,
                         engine=engine).rows
    python = rows_p if engine == "python" else P.run_sweep(
        P.Sweep(name="small", axes=axes, n_accesses=N), workers=1, engine="python").rows
    assert len(rows_p) == len(rows_j) == 16
    for rj, rp, ro in zip(rows_j, rows_p, python):
        assert rp.axes == rj.axes == ro.axes
        assert rp.seed == rj.seed
        assert_same(rj.metrics, rp.metrics)
        assert_same(ro.metrics, rp.metrics)  # the batch engine equals the oracle


def test_paper_claims_equal_jax():
    got = P.paper_claims(n_accesses=N, workers=1)
    want = J.paper_claims(n_accesses=N, workers=1)
    assert repr(got) == repr(want)
    assert got["perf_speedup_geomean"] == 2.7856173398905937
    assert got["access_cost_reduction_geomean"] == 2.516835629099918


def test_paper_claims_at_the_example_size():
    """At 20000 accesses a cell, the size of the simulate example and of
    ``chip_smoke.py``'s sim phase: the floats JAX's ``paper_claims`` gives at
    that size on the CPU."""
    got = P.paper_claims(n_accesses=20_000, workers=1)
    assert got["perf_speedup_geomean"] == 2.6246578959820193
    assert got["access_cost_reduction_geomean"] == 2.572550262016999


# --------------------------------------------------------------------------
# declarations: config, registries, sweep specs (seams mapped)
# --------------------------------------------------------------------------


def test_public_names_equal_jax():
    assert P.__all__ == J.__all__
    for mod in ("config", "controller", "engine", "engine_batch", "fabric", "memside",
                "policy", "runner", "serving", "sweep", "trace"):
        j = __import__(f"repro.core.sim.{mod}", fromlist=["x"])
        p = __import__(f"repro_torch.core.sim.{mod}", fromlist=["x"])
        assert sorted(n for n in vars(p) if not n.startswith("__")) == \
            sorted(n for n in vars(j) if not n.startswith("__")), mod


def test_simconfig_fields_and_defaults():
    j, p = J.SimConfig(), P.SimConfig()
    assert [f.name for f in dataclasses.fields(P.SimConfig)] == \
        [f.name for f in dataclasses.fields(J.SimConfig)]
    assert [f.type for f in dataclasses.fields(P.SimConfig)] == \
        [f.type for f in dataclasses.fields(J.SimConfig)]
    assert to_pallas(dataclasses.asdict(p)) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(P.Metrics)] == \
        [f.name for f in dataclasses.fields(J.Metrics)]
    assert dataclasses.asdict(P.Metrics()) == dataclasses.asdict(J.Metrics())


def test_seam_c_serving_workload_defaults():
    j, p = J.SimConfig(), P.SimConfig()
    assert (p.prefill_workload, p.decode_workload) == ("fa_prefill_h100", "fa_decode_h100")
    assert (j.prefill_workload, j.decode_workload) == ("fa_prefill", "fa_decode")


def test_registries_equal_jax():
    assert P.available_policies() == J.available_policies()
    for name in J.available_policies():
        assert dataclasses.asdict(P.get_policy(name)) == dataclasses.asdict(J.get_policy(name))
    assert P.available_controllers() == J.available_controllers()
    for name in J.available_controllers():
        cj, cp = J.get_controller(name), P.get_controller(name)
        assert (cp.name, cp.description) == (cj.name, cj.description)
        assert cp(P.SimConfig(), "pr").thresholds() == cj(J.SimConfig(), "pr").thresholds()
    assert P.available_placements() == J.available_placements()
    assert P.LEGACY_PLACEMENTS == J.LEGACY_PLACEMENTS
    for name in J.available_placements():
        pj, pp = J.get_placement(name), P.get_placement(name)
        assert (pp.name, pp.description) == (pj.name, pj.description)
    assert P.available_topologies() == J.available_topologies()
    for name in J.available_topologies():
        assert P.topology_description(name) == J.topology_description(name)
    assert P.available_routers() == J.available_routers()
    for name in J.available_routers():
        rj, rp = J.get_router(name), P.get_router(name)
        assert (rp.name, rp.handoff, rp.description) == (rj.name, rj.handoff, rj.description)


def test_seam_a_workload_registry():
    synthetic = tuple(w for w in J.available_workloads() if w not in PALLAS)
    assert P.available_workloads() == synthetic + HOPPER
    assert not set(PALLAS) & set(P.available_workloads())
    for name in synthetic:
        assert P.compressibility_of(name) == J.compressibility_of(name)
        assert P.get_workload(name).description == J.get_workload(name).description


def test_seam_b_kernel_streams():
    assert p_runner.KERNEL_WORKLOADS == HOPPER
    assert j_runner.KERNEL_WORKLOADS == PALLAS
    assert to_pallas(P.SERVING_TENANTS) == J.SERVING_TENANTS
    assert P.SERVING_TENANTS["llm"] == ("fa_prefill_h100", "fa_decode_h100")
    for name in ("KERNEL_SCHEMES", "KERNEL_BW_FRACS", "ABLATION_WORKLOADS", "UPLINK_WORKLOADS",
                 "UPLINK_FRACS", "DEFAULT_CC_MIXES", "CONTROLLER_SCHEMES", "MEM_CAPACITIES",
                 "MEM_SCHEMES", "SERVING_LOADS", "TOPOLOGY_WORKLOADS", "OVERSUBS",
                 "DEFAULT_WORKLOADS"):
        assert getattr(p_runner, name) == getattr(j_runner, name), name


def test_seam_d_tuned_thresholds():
    assert p_controller.TUNED_THRESHOLDS == {
        k: v for k, v in j_controller.TUNED_THRESHOLDS.items() if k not in PALLAS}
    assert set(PALLAS) <= set(j_controller.TUNED_THRESHOLDS)
    assert not (set(PALLAS) | set(HOPPER)) & set(p_controller.TUNED_THRESHOLDS)
    # a Hopper stream under 'tuned' runs the fixed constants
    tuned = P.get_controller("tuned")(P.SimConfig(), "mamba_fwd_h100").thresholds()
    fixed = P.get_controller("fixed")(P.SimConfig(), "mamba_fwd_h100").thresholds()
    assert tuned == {"page_fast": fixed["page_fast"], "throttle_hi": fixed["throttle_hi"]}


SPECS = sorted(n for n in J.__all__ if n.endswith("_spec"))


def _spec_view(sweep):
    return to_pallas({"name": sweep.name, "axes": dict(sweep.axes),
                      "base": dataclasses.asdict(sweep.base), "n_accesses": sweep.n_accesses,
                      "footprint": sweep.footprint, "base_seed": sweep.base_seed,
                      "derive_seeds": sweep.derive_seeds, "engine": sweep.engine})


@pytest.mark.parametrize("spec", SPECS)
def test_every_spec_declares_jax_grid(spec):
    kwargs = [{"tenant": t} for t in J.SERVING_TENANTS] if spec == "fig9_serving_spec" else [{}]
    for kw in kwargs:
        sj, sp = getattr(J, spec)(**kw), getattr(P, spec)(**kw)
        assert _spec_view(sp) == _spec_view(sj)
        assert len(sp.cells()) == len(sj.cells())
