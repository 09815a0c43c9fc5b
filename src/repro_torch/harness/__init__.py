"""Trace-driven load & chaos harness; the port of ``repro.harness``.

Replayable workload traces (``trace``), an open-loop wall-clock replayer
(``replay``), scripted mid-replay fault injection (``chaos``), persisted
per-scenario SLO scorecards (``scorecard``), simulated services (``sim``)
and the replay of a real replicated engine fleet (``engine_replay``).
The trace schema is the JAX package's, byte for byte.
"""
from repro_torch.harness.chaos import (ChaosAction, ChaosInjector,
                                       ChaosRecord)
from repro_torch.harness.engine_replay import (fleet_scorecard,
                                               fleet_submit_fn, fleet_trace,
                                               make_engine_item,
                                               make_forked_engine_item,
                                               run_fleet_replay,
                                               session_tokens)
from repro_torch.harness.replay import (ReplayReport, RequestOutcome,
                                        TraceReplayer, default_make_item,
                                        specs_for_trace)
from repro_torch.harness.scorecard import (build_scorecard, jain_index,
                                           load_scorecards, write_scorecards)
from repro_torch.harness.sim import SimExecutor, sim_builder
from repro_torch.harness.trace import (GENERATORS, Trace, TraceEvent,
                                       diurnal_chat, forked_chat, iot_burst,
                                       longdoc_batch)

__all__ = [
    "ChaosAction", "ChaosInjector", "ChaosRecord", "ReplayReport",
    "RequestOutcome", "TraceReplayer", "default_make_item",
    "specs_for_trace", "build_scorecard", "jain_index", "load_scorecards",
    "write_scorecards", "SimExecutor", "sim_builder", "GENERATORS",
    "Trace", "TraceEvent", "diurnal_chat", "forked_chat", "iot_burst",
    "longdoc_batch", "make_forked_engine_item",
    "fleet_scorecard", "fleet_submit_fn", "fleet_trace",
    "make_engine_item", "run_fleet_replay", "session_tokens",
]
