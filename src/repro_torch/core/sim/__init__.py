"""The DaeMon disaggregated-memory simulator (port of ``repro.core.sim``).

Plain Python, numpy and the standard library, as the original: the same
float expressions, event order and seeds, so every ``Metrics`` equals the
original's field for field wherever both replay the same trace.  The
simulator is host code and takes no device.  The departures are the four
kernel-stream seams, the Pallas captures swapped for the Hopper ones, and
one repair:

  (a) this module registers ``repro_torch.capture``'s catalog
      (``fa_prefill_h100``, ``fa_decode_h100``, ``mamba_fwd_h100``,
      ``bq_quant_h100``) where the original registers the Pallas one;
  (b) ``runner.KERNEL_WORKLOADS`` and ``runner.SERVING_TENANTS["llm"]`` name
      the Hopper streams (fig8, fig9's llm tenant, fig11's kernel grid);
  (c) ``SimConfig.prefill_workload`` / ``decode_workload`` default to
      ``fa_prefill_h100`` / ``fa_decode_h100``;
  (d) ``controller.TUNED_THRESHOLDS`` holds no kernel-stream entries, so
      the Hopper streams run the fixed constants under ``tuned``;
  (e) ``serving.ServingScheduler`` starts a queued phase no earlier than
      the cycle it was queued at; the original can start it at the popping
      core's own, earlier clock, so a decode phase may begin before its
      prefill ended.  Serving cells where no queued phase would start early
      stay equal to the original's.

The tests the modules' docstrings cite hold the original;
``tests/test_torch_sim.py`` and ``tests/test_torch_sim_kernels.py`` hold
this copy equal to it, seams apart;
``tests/test_torch_sim_serving_order.py`` holds (e).
"""
from repro_torch.core.sim.config import SCHEMES, Metrics, SimConfig
from repro_torch.core.sim.engine import LinkSchedule, Simulator, simulate
from repro_torch.core.sim.fabric import (
    Fabric,
    PortSpec,
    TopologySpec,
    available_topologies,
    build_topology,
    get_topology,
    register_topology,
    topology_description,
    unregister_topology,
)
from repro_torch.core.sim.controller import (
    PAGE_FAST,
    Decision,
    MovementController,
    Observation,
    available_controllers,
    get_controller,
    make_controller,
    register_controller,
    resolve_controller,
    unregister_controller,
)
from repro_torch.core.sim.engine_batch import (
    BatchCell,
    BatchResult,
    BatchState,
    covers,
    run_batch,
    uncovered_reason,
)
from repro_torch.core.sim.memside import (
    LEGACY_PLACEMENTS,
    MemsideState,
    PlacementPolicy,
    available_placements,
    get_placement,
    make_memside,
    register_placement,
    unregister_placement,
)
from repro_torch.core.sim.policy import (
    MovementPolicy,
    available_policies,
    get_policy,
    register_policy,
    unregister_policy,
)
from repro_torch.core.sim.runner import (
    ABLATION_POLICIES,
    CONTROLLERS,
    OVERSUBS,
    SERVING_LOADS,
    SERVING_ROUTERS,
    SERVING_TENANTS,
    TOPOLOGIES,
    TOPOLOGY_WORKLOADS,
    fig2,
    fig2_spec,
    fig2_sweep,
    fig4_bottom,
    fig4_bottom_spec,
    fig4_top,
    fig4_top_spec,
    fig5_scalability,
    fig5_scalability_spec,
    fig6_ablation,
    fig6_ablation_spec,
    fig6_geomeans,
    fig7_uplink,
    fig7_uplink_spec,
    fig8_kernels,
    fig8_kernels_spec,
    fig9_serving,
    fig9_serving_spec,
    fig9_tails,
    fig10_oversub_spec,
    fig10_topology,
    fig10_topology_spec,
    fig11_ablation_spec,
    fig11_controllers,
    fig11_geomeans,
    fig11_kernels_spec,
    fig11_uplink_spec,
    MEM_CAPACITIES,
    MEM_PLACEMENTS,
    MEM_SCHEMES,
    fig12_geomeans,
    fig12_memside,
    fig12_memside_spec,
    geomean,
    paper_claims,
    run_one,
    slowdowns,
)
from repro_torch.core.sim.serving import (
    RequestRecord,
    RequestSpec,
    RouterPolicy,
    ServingScheduler,
    available_routers,
    build_requests,
    get_router,
    register_router,
    request_arrivals,
    serve_one,
    unregister_router,
)
from repro_torch.core.sim.sweep import (
    ENGINES,
    CellResult,
    Sweep,
    SweepResult,
    cell_seed,
    default_workers,
    run_sweep,
    scheme_geomean,
    scheme_ratio,
    wall_stats,
    write_bench,
)
from repro_torch.core.sim.trace import (
    DEFAULT_SUITE,
    WORKLOADS,
    WorkloadSpec,
    available_workloads,
    compressibility_of,
    generate,
    get_workload,
    register_trace_file,
    register_workload,
    save_trace,
    unregister_workload,
)

# the captured Hopper-kernel workloads (fa_prefill_h100, fa_decode_h100,
# mamba_fwd_h100, bq_quant_h100 — DESIGN.md §2.8) register at import so
# they work out of the box; capture and the kernel modules' imports stay
# lazy until a trace is first drawn (seam (a))
from repro_torch.capture.workloads import register_captured_kernels as _reg_captured

_reg_captured()

__all__ = [
    "SCHEMES", "Metrics", "SimConfig", "Simulator", "simulate", "LinkSchedule",
    "MovementPolicy", "available_policies", "get_policy", "register_policy",
    "unregister_policy",
    "ABLATION_POLICIES",
    "fig2", "fig2_spec", "fig2_sweep", "fig4_bottom", "fig4_bottom_spec",
    "fig4_top", "fig4_top_spec", "fig5_scalability", "fig5_scalability_spec",
    "fig6_ablation", "fig6_ablation_spec", "fig6_geomeans",
    "fig7_uplink", "fig7_uplink_spec",
    "fig8_kernels", "fig8_kernels_spec",
    "fig9_serving", "fig9_serving_spec", "fig9_tails",
    "fig10_topology", "fig10_topology_spec", "fig10_oversub_spec",
    "fig11_controllers", "fig11_ablation_spec", "fig11_uplink_spec",
    "fig11_kernels_spec", "fig11_geomeans", "CONTROLLERS",
    "fig12_memside", "fig12_memside_spec", "fig12_geomeans",
    "MEM_PLACEMENTS", "MEM_CAPACITIES", "MEM_SCHEMES",
    "LEGACY_PLACEMENTS", "MemsideState", "PlacementPolicy",
    "available_placements", "get_placement", "make_memside",
    "register_placement", "unregister_placement",
    "PAGE_FAST", "Decision", "MovementController", "Observation",
    "available_controllers", "get_controller", "make_controller",
    "register_controller", "resolve_controller", "unregister_controller",
    "SERVING_LOADS", "SERVING_ROUTERS", "SERVING_TENANTS",
    "TOPOLOGIES", "TOPOLOGY_WORKLOADS", "OVERSUBS",
    "Fabric", "PortSpec", "TopologySpec", "available_topologies",
    "build_topology", "get_topology", "register_topology",
    "topology_description", "unregister_topology",
    "RequestRecord", "RequestSpec", "RouterPolicy", "ServingScheduler",
    "available_routers", "build_requests", "get_router", "register_router",
    "request_arrivals", "serve_one", "unregister_router",
    "geomean", "paper_claims",
    "run_one", "slowdowns",
    "DEFAULT_SUITE", "WORKLOADS", "WorkloadSpec", "available_workloads",
    "compressibility_of", "generate", "get_workload", "register_trace_file",
    "register_workload", "save_trace", "unregister_workload",
    "CellResult", "Sweep", "SweepResult", "cell_seed", "default_workers",
    "run_sweep", "scheme_geomean", "scheme_ratio", "write_bench",
    "BatchCell", "BatchResult", "BatchState", "covers", "run_batch",
    "uncovered_reason",
    "ENGINES", "wall_stats",
]
