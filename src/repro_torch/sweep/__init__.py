"""Experiment sweeps of the port: whole hyperparameter grids, a static cell
at a time.

``grid``    — GridSpec with static vs batchable axes, static-cell partition.
``batched`` — trajectory chunks: one trajectory, or a cell of them in one
              chunk (one CUDA graph on the card), with the early-stop freeze.
``run``     — cell/point drivers, ``run_sweep``, the
              ``repro_torch.sweep.run`` CLI.
``defs``    — the paper-figure sweep definitions.
``store``   — ``results/sweeps_torch/<name>.json`` with provenance.
"""
from repro_torch.sweep.batched import (  # noqa: F401
    Trajectories,
    make_batched_chunk_builder,
    make_churn_traj_sampler,
    make_quadratic_traj_sampler,
    make_trajectory_chunk_builder,
    trajectory_chunk_program,
    tree_index,
    tree_stack,
)
from repro_torch.sweep.grid import (  # noqa: F401
    Axis,
    Cell,
    GridSpec,
    batch_axis,
    config_hash,
    point_key,
    static_axis,
)
# repro_torch.sweep.run (drivers + CLI) and repro_torch.sweep.defs are not
# imported here: ``python -m repro_torch.sweep.run`` would re-execute an
# already-imported module.
