"""What the ranks of the serving-mesh tests run (``dist.launch.run_world``
imports this module in each spawned rank, so it imports torch and the
port only, never JAX).

``serve_cases``: on a world of 4, the serving meshes ``(1, 2)`` and
``(2, 1)`` over ranks 0–1, ``(2, 2)`` over all four and ``(1, 1)`` over
rank 0; for each case of a ``torch.save`` file (a port config, the
reference's parameters as numpy or a seed, prompts, forced tokens and the
meshes to run on), ``launch.serve.generate_on_mesh`` of the rank's shard
on each of its meshes, the prefill's residual split over ``model`` by
sequence, and on each of its ``whole_meshes`` with the residual whole
(``seq_parallel=False``); each rank returns its rows' logits, its prefill
caches, the tokens it fed, the collectives' counts, the kernel launches
and the residual's length (positions) into and out of every block, by
mode; then the serving legs of ``launch.smoke`` on the same world
(``smoke_archs``).
"""
import contextlib

import torch

from repro_torch.dist import tensor_parallel as tp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_lib
from repro_torch.models import interop
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as t_tf

MESHES = {(1, 2): [0, 1], (2, 1): [0, 1], (2, 2): [0, 1, 2, 3], (1, 1): [0]}


def _params(case):
    cfg = case["cfg"]
    if case.get("params") is not None:
        model = interop.params_from_reference(case["params"], cfg,
                                              device="cpu",
                                              dtype=case["dtype"])
    else:
        model = model_lib.init_params(cfg, seed=case["seed"], device="cpu",
                                      dtype=case["dtype"])
    return model_lib.param_dict(model)


@contextlib.contextmanager
def residual_lengths():
    """Yields {mode: [(positions in, positions out) of each block call]}:
    ``transformer.block_forward`` spied on."""
    seen = {}
    inner = t_tf.block_forward

    def spy(kind, params, x, *args, **kw):
        out = inner(kind, params, x, *args, **kw)
        seen.setdefault(kw["mode"], []).append((x.shape[1],
                                                out[0].shape[1]))
        return out

    t_tf.block_forward = spy
    try:
        yield seen
    finally:
        t_tf.block_forward = inner


def serve_cases(rank, world, path, smoke_archs=()):
    from repro_torch.launch import smoke

    cases = torch.load(path, weights_only=False)
    meshes = {shape: mesh_lib.serve_mesh(*shape, ranks=ranks)
              for shape, ranks in MESHES.items()}
    out = []
    for case in cases:
        params = _params(case)
        runs = ([(shape, True) for shape in case["meshes"]]
                + [(shape, False) for shape in case.get("whole_meshes", ())])
        for shape, seq in runs:
            mesh = meshes[shape]
            if mesh is None:
                continue
            m, r = mesh.model_axis.size, mesh.model_axis.rank
            shard = tp.shard_params(params, tp.plan(case["cfg"], m), r)
            with residual_lengths() as lengths:
                res = serve_lib.generate_on_mesh(
                    mesh, case["cfg"], shard, case["prompt"],
                    case["gen_tokens"], forced=case.get("forced"),
                    prefix=case.get("prefix"), compute_dtype=case["dtype"],
                    seq_parallel=seq)
            out.append({"case": case["name"], "mesh": shape, "rank": rank,
                        "layout": "seq" if seq else "whole",
                        "batch_rank": mesh.batch_axis.rank,
                        "model_rank": mesh.model_axis.rank,
                        "rows": (res.rows.start, res.rows.stop),
                        "logits": res.logits, "tokens": res.tokens,
                        "caches": res.prefill_caches,
                        "collectives": res.collectives,
                        "launches": res.launches,
                        "residual": lengths,
                        "same_tokens": res.same_tokens})
    out.append({"case": "smoke", "mesh": None, "rank": rank,
                "legs": smoke._serve_legs(rank, world, smoke_archs)})
    return out
