"""Structured telemetry of the port: spans, counters and gauges
(``events``), the analytic communication ledger (``ledger``),
``torch.profiler`` capture windows and algorithm-health gauges
(``profiler``), and ``python -m repro_torch.obs.report run.jsonl``, which
folds a run's JSONL into a summary (``report``).

Everything here is host-side and opt-in: a run that constructs no sink
launches nothing extra, and its trajectory is bit for bit that of a run
without telemetry.
"""
from repro_torch.obs.events import (  # noqa: F401
    EVENT_TYPES,
    NULL,
    TELEMETRY_VERSION,
    JsonlSink,
    MemorySink,
    StderrSink,
    Telemetry,
)
from repro_torch.obs.ledger import (  # noqa: F401
    LEDGER_VERSION,
    CommLedger,
    RoundComm,
    ledger_for_state,
    links_per_gossip,
    round_comm,
)
from repro_torch.obs.profiler import (  # noqa: F401
    Profiler,
    health_gauges,
)
