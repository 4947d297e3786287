"""Chunked multi-round execution engine of the port.

``engine`` — chunk programs (CUDA graphs on the card), the chunk driver
and its checkpoint and telemetry hooks; ``sampler`` — per-round batch and
noise samplers; ``diagnostics`` — metric functions.
"""
from repro_torch.engine.diagnostics import (  # noqa: F401
    dro_metrics_fn,
    quadratic_metrics_fn,
)
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
    flatten_clients,
    held_out_eval_batch,
    make_dro_sampler,
    make_fixed_batch_sampler,
    slice_clients,
    stream_seed,
    with_topology,
)
