"""Pluggable movement controllers (DESIGN.md §2.12): the selection unit,
the issue throttle, and the compression triggers as one replaceable
decision layer.

DaeMon's adaptive granularity selection (paper §3-II), the inflight-buffer
throttle, and the congestion-triggered link compression (§3-III) are all
*decisions over the same observation vector*: line/page inflight-buffer
utilization, the CC->MC uplink backlog, and the recent per-class drain
rates.  This module factors those decisions out of the two engines into a
:class:`MovementController` with a ``@register_controller`` registry, so
the thresholds stop being scattered constants and become a swept axis
(``SimConfig.controller``), a policy component
(``MovementPolicy.controller``), and a serving per-pool override
(``cfg.serving_prefill_controller`` / ``serving_decode_controller``).

Three controllers ship:

``fixed``
    The legacy constants, verbatim — bit-identical to every committed
    golden and gated geomean.  Its :meth:`~MovementController.decide` is
    exactly the inline expressions the engines used to carry.
``adaptive``
    Tracks the coalesce density (the fraction of remote misses that land
    on a page already in flight — the page-density signature of real
    tiled kernel streams) and the per-class arrival gaps in EWMAs, plus
    the live uplink backlog, and backs line racing off in page-dense
    phases where redundant line races only steal the reserved line share
    from the pages that actually carry the data.  Built for the fig8
    kernel traces, where ``fixed`` daemon stays near page.
``tuned``
    Per-workload ``(page_fast, throttle_hi)`` thresholds fitted offline
    by ``benchmarks/fit_controller.py`` sweeping the batch engine;
    unknown workloads fall back to the fixed constants.

Port departure (seam (d)): :data:`TUNED_THRESHOLDS` keeps the synthetic
workloads' entries and drops the four kernel-stream entries the original
fitted on its Pallas captures; no fit exists for the Hopper captures, so
under the table's own rule they run the fixed constants.

Contract with the engines (the bit-parity rule): only the ``observe_*``
hooks may mutate controller state; :meth:`~MovementController.decide` is
pure given that state.  Both engines deliver the same observe sequence
(their event orders are transcribed lockstep), so a controller behaves
identically under the oracle and the batch core even when the two call
``decide`` a different number of times.

This module is a leaf: it imports nothing from the sim package, so
config.py / policy.py / both engines can import it freely.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

# inflight-page utilization below which pages drain fast (paper §3-II/III:
# the selection unit and the compression trigger both key off this).  The
# single source of truth — engine.py re-exports it for the batch engine
# and tests/test_controller.py drift-locks the value.
PAGE_FAST = 0.3


def selection_races_line(lu: float, pu: float) -> bool:
    """Adaptive selection unit (paper §3-II): race a line for a coalesced
    miss only when the page queue is congested (the line is the
    critical-path fast path) and the line buffer has room."""
    return pu > PAGE_FAST and lu < 1.0


class Observation(NamedTuple):
    """What a controller sees at a decision point.

    ``lu``/``pu`` are the line/page inflight-buffer utilizations (pending
    entries / buffer capacity); ``uplink_backlog`` is the CC->MC uplink
    backlog in bytes toward the MC the decision concerns (0.0 when the
    uplink is not modeled or the controller's ``needs_uplink`` is False —
    the engines skip the backlog computation on the hot path for
    controllers that never read it)."""

    t: float
    lu: float
    pu: float
    uplink_backlog: float = 0.0


class Decision(NamedTuple):
    """A controller's answer at a decision point.  Call sites read only
    the fields their site concerns — the unread fields cost nothing."""

    race_line: bool       # coalesced miss: race a line on the critical path?
    issue_line: bool      # triggering miss / retry: issue the line movement?
    issue_page: bool      # triggering miss / retry: issue the page movement?
    compress: bool        # demand page + legacy writeback: engage compression?
    compress_writeback: bool  # uplink writeback: compress before sending?


class MovementController:
    """Base controller: the observe/decide split both engines rely on.

    Subclasses override :meth:`decide` (pure) and any ``observe_*`` hook
    they need (the only methods allowed to mutate state).  ``needs_uplink``
    tells the engines whether to compute ``Observation.uplink_backlog``
    outside the writeback path — leave it False unless ``decide`` reads
    the backlog, it keeps a link-heap scan off the miss hot path."""

    name = "?"
    description = ""
    needs_uplink = False

    def __init__(self, cfg, workload: str = ""):
        self.cfg = cfg
        self.workload = workload

    # -- observation hooks (the only state mutators) --------------------
    def observe_line(self, t: float) -> None:
        """A line movement arrived at the CC at time ``t``."""

    def observe_page(self, t: float) -> None:
        """A page movement arrived at the CC at time ``t``."""

    def observe_miss(self, coalesced: bool) -> None:
        """A remote miss reached the movement unit; ``coalesced`` is True
        when its page was already in flight."""

    # -- the pure decision ----------------------------------------------
    def decide(self, obs: Observation) -> Decision:
        raise NotImplementedError

    def thresholds(self) -> Dict[str, float]:
        """The controller's operating thresholds (``run.py --list``)."""
        return {}


# --------------------------------------------------------------------------
# registry (the policy/workload/topology registry idiom)
# --------------------------------------------------------------------------

_CONTROLLERS: Dict[str, Callable[..., MovementController]] = {}


def register_controller(cls=None, *, name: str = "", overwrite: bool = False):
    """Register a MovementController class (decorator or direct call).
    The registered name is ``cls.name`` unless ``name`` overrides it."""

    def reg(c):
        key = name or c.name
        if not key or key == "?":
            raise ValueError(f"controller {c!r} has no name")
        if key in _CONTROLLERS and not overwrite:
            raise ValueError(f"controller {key!r} already registered "
                             f"(pass overwrite=True to replace)")
        _CONTROLLERS[key] = c
        return c

    return reg(cls) if cls is not None else reg


def unregister_controller(name: str) -> None:
    _CONTROLLERS.pop(name, None)


def get_controller(name: str) -> Callable[..., MovementController]:
    """The registered controller class for ``name``; raises KeyError with
    the known choices (fail-fast for config/sweep/CLI validation)."""
    try:
        return _CONTROLLERS[name]
    except KeyError:
        raise KeyError(f"unknown controller {name!r}; "
                       f"choose from {available_controllers()}") from None


def available_controllers() -> list:
    return sorted(_CONTROLLERS)


def make_controller(name: str, cfg, workload: str = "") -> MovementController:
    """Instantiate one per-CC controller (each CC gets its own state)."""
    return get_controller(name)(cfg, workload)


def resolve_controller(policy, cfg) -> str:
    """The controller name a CC runs: the policy's explicit component
    wins (so serving per-pool overrides beat the sweep axis), then the
    config's, then the legacy ``fixed``."""
    return (getattr(policy, "controller", None)
            or getattr(cfg, "controller", None)
            or "fixed")


# --------------------------------------------------------------------------
# the three shipped controllers
# --------------------------------------------------------------------------


@register_controller
class FixedController(MovementController):
    """The legacy constants, verbatim: ``decide`` reproduces exactly the
    inline expressions the engines carried before the refactor, so every
    committed golden and gated geomean is bit-identical under it."""

    name = "fixed"
    description = ("legacy constants: race above PAGE_FAST, throttle at "
                   "page_throttle_hi, compress on buffer/backlog pressure")

    def decide(self, obs: Observation) -> Decision:
        cfg = self.cfg
        return Decision(
            race_line=selection_races_line(obs.lu, obs.pu),
            issue_line=obs.lu < 1.0,
            issue_page=obs.pu < cfg.page_throttle_hi,
            compress=obs.pu > PAGE_FAST,
            compress_writeback=obs.uplink_backlog > cfg.page_bytes,
        )

    def thresholds(self) -> Dict[str, float]:
        return {"page_fast": PAGE_FAST,
                "throttle_hi": self.cfg.page_throttle_hi}


@register_controller
class AdaptiveController(MovementController):
    """Backs line racing off in page-dense phases.

    State (observe hooks only): an EWMA of the coalesce density — the
    fraction of remote misses whose page is already in flight — and EWMAs
    of the line/page arrival gaps (the per-class drain rates).  Real
    tiled kernel streams coalesce most lines of a page (density near 1)
    while the synthetic suite's sparse sources sit near 0, so the density
    EWMA separates the two regimes.

    Decisions: above ``race_backoff`` density, coalesced misses stop
    racing redundant lines — each race steals the reserved line share
    from the page that already carries the data.  Only the *redundant*
    races back off: a non-coalesced (triggering) miss still issues its
    line, because that line IS the critical path (suppressing it was
    measured strictly worse on every captured kernel).  A deeply
    backlogged uplink (> ``uplink_backoff_pages`` pages of bytes) also
    suppresses racing — every raced line costs a request packet on the
    congested reverse path.  Everything else (throttle, compression)
    stays at the fixed thresholds, so on the synthetic suite — where the
    density never crosses the backoff — ``adaptive`` is
    decision-identical to ``fixed``."""

    name = "adaptive"
    description = ("EWMA coalesce-density + drain-rate tracker; stops "
                   "racing lines in page-dense (tiled-kernel) phases")
    needs_uplink = True

    # EWMA smoothing for the density signal: ~1/alpha misses of memory
    alpha = 0.02
    # smoothing for the per-class arrival-gap (drain-rate) trackers
    gap_alpha = 0.05
    # density above which coalesced misses stop racing lines
    race_backoff = 0.60
    # uplink backlog (in pages) above which racing is suppressed
    uplink_backoff_pages = 4.0

    def __init__(self, cfg, workload: str = ""):
        super().__init__(cfg, workload)
        self.density = 0.0
        self.line_gap = 0.0
        self.page_gap = 0.0
        self._last_line = 0.0
        self._last_page = 0.0

    def observe_line(self, t: float) -> None:
        a = self.gap_alpha
        self.line_gap += a * ((t - self._last_line) - self.line_gap)
        self._last_line = t

    def observe_page(self, t: float) -> None:
        a = self.gap_alpha
        self.page_gap += a * ((t - self._last_page) - self.page_gap)
        self._last_page = t

    def observe_miss(self, coalesced: bool) -> None:
        self.density += self.alpha * ((1.0 if coalesced else 0.0)
                                      - self.density)

    def decide(self, obs: Observation) -> Decision:
        cfg = self.cfg
        dense = self.density > self.race_backoff
        up_hot = obs.uplink_backlog > self.uplink_backoff_pages * cfg.page_bytes
        return Decision(
            race_line=(selection_races_line(obs.lu, obs.pu)
                       and not dense and not up_hot),
            issue_line=obs.lu < 1.0,
            issue_page=obs.pu < cfg.page_throttle_hi,
            compress=obs.pu > PAGE_FAST,
            compress_writeback=obs.uplink_backlog > cfg.page_bytes,
        )

    def thresholds(self) -> Dict[str, float]:
        return {"page_fast": PAGE_FAST,
                "throttle_hi": self.cfg.page_throttle_hi,
                "race_backoff": self.race_backoff,
                "uplink_backoff_pages": self.uplink_backoff_pages,
                "alpha": self.alpha}


# Per-workload (page_fast, throttle_hi) fitted offline by
# benchmarks/fit_controller.py sweeping the batch engine (daemon cycles at
# the congested end of the paper's network range, link_bw_frac=0.125).
# Regenerate with:
#   PYTHONPATH=src python benchmarks/fit_controller.py
# Workloads absent from the table run the fixed constants.
TUNED_THRESHOLDS: Dict[str, tuple] = {
    "pr": (0.40, 0.75),
    "bf": (0.10, 0.90),
    "ts": (0.20, 0.90),
    "nw": (0.10, 0.90),
    "dr": (0.50, 0.90),
    "pf": (0.20, 0.90),
    "st": (0.10, 0.50),
    "ml": (0.30, 0.75),
    "ph": (0.10, 0.65),
    "wh": (0.10, 0.50),
}


@register_controller
class TunedController(MovementController):
    """Per-workload thresholds from :data:`TUNED_THRESHOLDS` substituted
    into the fixed decision formulas; the fit is offline (batch-engine
    sweep in ``benchmarks/fit_controller.py``), the controller itself is
    stateless like ``fixed``."""

    name = "tuned"
    description = ("per-workload (page_fast, throttle_hi) fitted offline "
                   "on the batch engine; fixed constants elsewhere")

    def __init__(self, cfg, workload: str = ""):
        super().__init__(cfg, workload)
        self.page_fast, self.throttle_hi = TUNED_THRESHOLDS.get(
            workload, (PAGE_FAST, cfg.page_throttle_hi))

    def decide(self, obs: Observation) -> Decision:
        return Decision(
            race_line=obs.pu > self.page_fast and obs.lu < 1.0,
            issue_line=obs.lu < 1.0,
            issue_page=obs.pu < self.throttle_hi,
            compress=obs.pu > self.page_fast,
            compress_writeback=obs.uplink_backlog > self.cfg.page_bytes,
        )

    def thresholds(self) -> Dict[str, float]:
        return {"page_fast": self.page_fast,
                "throttle_hi": self.throttle_hi}
