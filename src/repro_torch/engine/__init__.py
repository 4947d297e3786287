"""Chunked multi-round execution engine of the port.

``engine`` — chunk programs (CUDA graphs on the card), the chunk driver
and its checkpoint and telemetry hooks; ``sampler`` — per-round batch and
noise samplers; ``diagnostics`` — metric functions.
"""
from repro_torch.engine.diagnostics import quadratic_metrics_fn  # noqa: F401
from repro_torch.engine.engine import (  # noqa: F401
    ChunkRunner,
    checkpoint_hook,
    chunk_program,
    make_chunk_builder,
    records_from_buffer,
    row_to_record,
    run,
    split_sampled,
    telemetry_hook,
)
from repro_torch.engine.sampler import (  # noqa: F401
    make_fixed_batch_sampler,
    with_topology,
)
