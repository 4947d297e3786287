"""Structured telemetry of the port: spans, counters and gauges
(``events``), and the analytic communication ledger (``ledger``).

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
