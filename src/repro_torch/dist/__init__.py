"""Distribution subsystem of the port (``repro.dist``'s counterpart).

``repro_torch.dist`` is the glue between the algorithm layer
(``repro_torch.core``: tensor trees with a leading clients dim) and the
processes of a ``torch.distributed`` world:

1. **Where does each parameter live?**  ``sharding`` maps parameter trees
   to ``torch.distributed.tensor`` placements on the decentralized mesh
   ``(clients, fsdp, model)``: the leading clients dim on the ``clients``
   axis, each client's weights over its own ``(fsdp, model)`` ranks.
2. **Where do activations live?**  ``context`` is a thread-local stack of
   tagged constraint functions that the model stack consults
   (:func:`apply` / :func:`apply_residual`); the step builders of
   ``repro_torch.launch.steps`` install the layout with
   :func:`residual_constraint`.
3. **What crosses ranks?**  ``collectives`` is the port's side of what
   GSPMD inserts for the reference: the gossips of a round over a
   clients-sharded state, the all-reduced means of the metrics, the
   serving mesh's sums over ``model`` and its all-gather of vocab-sharded
   logits, and their counters.  ``launch`` starts a world (``run_world``)
   or joins torchrun's.
4. **How is a model split over ``model`` to serve it, and a client's
   weights over its ``(fsdp, model)`` block to train it?**
   ``tensor_parallel`` is the executed plan beside
   ``serve_params_shardings``' and ``params_shardings``' specs: query and
   KV heads, SSM heads, LRU channels, d_ff and the vocabulary over the
   ``model`` ranks (Megatron's layout), a rank's shard and the context
   slots that run its collectives, with the residual's sequence split
   over ``model`` between a block's column- and row-parallel pieces
   (``SeqSplit``: a prefill, and training under
   ``residual_mode="batch_seq"``); in training (``ClientShard``) each
   model piece split once more over ``fsdp`` in ZeRO-3 pieces, gathered
   where the forward reads them (``collectives.fsdp_gather`` and the
   other autograd Functions of the block).

``compat`` builds the meshes: a ``DeviceMesh`` over a world, or an
abstract mesh of named sizes for spec work.  The serving mesh
(``launch.mesh.ServeMesh``) and the training mesh's three axes
(``launch.mesh.TrainAxes``) execute; the sweep-cell leg of the
reference's smoke run is not ported yet.
"""
from repro_torch.dist.compat import abstract_mesh, make_mesh, mesh_of
from repro_torch.dist.context import (
    apply,
    apply_residual,
    current_slots,
    residual_constraint,
)
from repro_torch.dist.sharding import (
    CLIENTS,
    FSDP,
    MODEL,
    leading_dims_constraint,
    params_shardings,
    residual_axes,
    serve_params_shardings,
)

__all__ = [
    "CLIENTS",
    "FSDP",
    "MODEL",
    "abstract_mesh",
    "apply",
    "apply_residual",
    "current_slots",
    "leading_dims_constraint",
    "make_mesh",
    "mesh_of",
    "params_shardings",
    "residual_axes",
    "residual_constraint",
    "serve_params_shardings",
]
