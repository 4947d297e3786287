"""Serving entry point: batched prefill, then decode (port of
``repro.launch.serve`` and the single-device body of
``repro.launch.steps.build_prefill_step`` / ``build_decode_step``).

One prefill step runs ``forward(mode="prefill", caches=init_cache(B,
prompt_len + gen_tokens), last_only=True)`` over the whole batch of prompts,
through the model's kernels (flash attention and the RG-LRU scan for
recurrentgemma-9b, the SSD scan for mamba2-1.3b); then ``gen_tokens``
decode steps each sample a token (``torch.multinomial``) and feed it back.
The decode step is ``serving.decode.DecodeStep``: on the card one CUDA
graph, captured once a call (its model, batch and cache length fixed) and
replayed every step; ``capture=False`` runs it eagerly.  Weights are bf16
on the card, drawn from a seeded ``torch.Generator``, as are the prompts.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --device cpu --reduced --prompt-len 40 --tokens 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --local --device cpu

A prefill fills a KV cache exactly only when the cache's length divides the
prompt length (the cache keeps the last ``length`` keys, and decode's ring
writes position p at slot p % length); other prompt lengths are refused.
Layers without a KV cache (``rglru``, ``ssm``) take any prompt length.  So
a model whose layers attend globally (qwen2-0.5b, granite-moe-1b-a400m,
musicgen-medium, …: a cache as long as prompt and new tokens together) is
served here as a prefill server, ``--tokens 0``; it generates after its
prompt through the continuous-batching engine
(``repro_torch.serving.ServingEngine``) or ``--local``, both of which
prefill token by token through the decode step.  ``--local`` is the
reference's single-device demo (``serve_local``): the arch's reduced
config, the prompt token by token, then sampled decode steps
(``generate_stepwise``, which ``launch.serve_example`` runs too).  An audio
model's prompts are (B, P, C) codebook streams, and each decode step
samples every codebook: (B, 1, C) (reference ``launch/serve.py:31,49``).
``--mesh DATAxMODEL`` serves on the world's serving mesh
(``launch.mesh.serve_mesh``), under torchrun or ``dist.launch.run_world``
(without them, a world of one rank: ``--mesh 1x1``): the batch rows split
over ``data``, the weights over ``model`` (``dist.tensor_parallel``: every
block kind, attention by heads, ``ssm`` by SSM heads, ``rglru`` by LRU
channels; a prefill's residual split over ``model`` by sequence, a
decode step's whole), through ``launch.steps.build_prefill_step`` and
``build_decode_step`` (:func:`generate_on_mesh`, the decode steps eager: a
gloo collective cannot be captured).  Every rank draws the weights and
prompts from the seed, the weights piece by piece, keeping only its shard
(``tp.init_shard``); rank 0 prints prefill s, decode ms a token,
tokens/s, the communication s and bytes by collective (a prefill's
sequence gathers and reduce-scatters as ``seq_gather`` and
``seq_scatter``, its last position's ``broadcast``) and the peak memory
of a rank::

  PYTHONPATH=src torchrun --standalone --nproc-per-node=2 \\
      -m repro_torch.launch.serve --mesh 1x2 --device cpu --reduced \\
      --arch qwen2-0.5b --prompt-len 16 --tokens 4
  PYTHONPATH=src torchrun --standalone --nproc-per-node=2 \\
      -m repro_torch.launch.serve --mesh 1x2 --device cpu --reduced \\
      --arch recurrentgemma-9b --prompt-len 64 --tokens 4

``--shape SHAPE`` runs :func:`serve_production` instead: the bytes of the
arguments a rank holds on the production mesh (data 16 × model 16, or pod
2 × data 16 × model 16 with ``--multi-pod``), from the reference's specs.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import torch
from torch.distributed.tensor import Placement

from repro_torch.configs import registry
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import tree as tree_lib
from repro_torch.dist import collectives
from repro_torch.dist import sharding as sh
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as model_lib
from repro_torch.serving.decode import DecodeStep, gumbel_noise


@dataclasses.dataclass
class ServeResult:
    model: model_lib.Model
    prompt: torch.Tensor          # (B, prompt_len[, C])
    tokens: torch.Tensor          # (B, gen_tokens[, C]), the sampled tokens
    logits: torch.Tensor          # (B, gen_tokens + 1[, C], V): the
    #                               prefill's last position, then each
    #                               decode step's
    prefill_caches: List[Dict[str, torch.Tensor]]
    prefill_s: float
    decode_s: float
    capture_s: float                      # the decode step's capture
    launches: Dict[str, Dict[str, int]]   # kernel launches: prefill, decode


def check_prompt(cfg: ModelConfig, prompt_len: int, total: int) -> None:
    """Refuse a prompt length that some KV cache's length does not divide:
    the prefill keeps the last ``length`` keys (reference
    ``models/transformer.py:166-171``), which lands position p at decode's
    ring slot p % length only then."""
    for kind in sorted(set(cfg.blocks())):
        length = model_lib.cache_length(kind, cfg, total)
        if length is not None and prompt_len % length:
            raise ValueError(
                f"prompt length {prompt_len}: the {kind!r} layers' KV cache "
                f"holds {length} positions for {total} tokens, and a prefill "
                f"fills it exactly only when that length divides the prompt "
                f"length")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample(logits, temperature: float, generator) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) tokens, or (B, 1, C, V) -> (B, 1, C), a
    token of each codebook; temperature 0 is greedy."""
    last = logits[:, -1].to(torch.float32)        # (B, V) or (B, C, V)
    if temperature <= 0:
        return last.argmax(-1)[:, None]
    probs = torch.softmax(last / temperature, dim=-1)
    tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                            generator=generator)
    return tok.reshape(last.shape[:-1])[:, None]


@torch.no_grad()
def generate(model: model_lib.Model, prompt: torch.Tensor, gen_tokens: int, *,
             temperature: float = 1.0, generator=None,
             compute_dtype=torch.bfloat16, capture=None) -> ServeResult:
    """Prefill ``prompt`` (B, P), or (B, P, C) with codebooks, in one
    step, then ``gen_tokens`` decode steps through a ``DecodeStep`` on
    copies of the prefill's caches (``capture`` None: a CUDA graph on the
    card)."""
    cfg = model.cfg
    b, prompt_len = prompt.shape[:2]
    total = prompt_len + gen_tokens
    check_prompt(cfg, prompt_len, total)
    device = prompt.device
    caches = model_lib.init_cache(cfg, b, total, dtype=compute_dtype,
                                  device=device)
    start = ops.launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    logits, caches, _ = model_lib.forward(
        model, {"tokens": prompt}, mode="prefill", compute_dtype=compute_dtype,
        caches=caches, last_only=True)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    after_prefill = ops.launch_counts()
    prefill_caches = caches
    steps, toks = [logits], []
    step = None
    if gen_tokens:
        step = DecodeStep(model, [{k: v.clone() for k, v in c.items()}
                                  for c in caches], b,
                          compute_dtype=compute_dtype, capture=capture)
    t0 = time.perf_counter()
    for i in range(gen_tokens):
        tok = sample(logits, temperature, generator)
        toks.append(tok)
        step.tokens.copy_(tok)
        step.pos.fill_(prompt_len + i)
        step()
        logits = step.logits.clone()
        steps.append(logits)
    _sync(device)
    decode_s = time.perf_counter() - t0
    end = ops.launch_counts()
    launches = {
        "prefill": {k: after_prefill[k] - start[k] for k in start},
        "decode": {k: end[k] - after_prefill[k] for k in start}}
    tokens = (torch.cat(toks, dim=1) if toks
              else prompt.new_zeros((b, 0, *prompt.shape[2:])))
    return ServeResult(model=model, prompt=prompt, tokens=tokens,
                       logits=torch.cat(steps, dim=1),
                       prefill_caches=prefill_caches, prefill_s=prefill_s,
                       decode_s=decode_s,
                       capture_s=step.capture_s if step else 0.0,
                       launches=launches)


def serve(arch: str, *, batch: int = 4, prompt_len: int = 4096,
          gen_tokens: int = 32, temperature: float = 1.0, device="cuda",
          seed: int = 0, reduced: bool = False) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens on a model of
    ``arch`` (its reduced CPU-test variant if ``reduced``) with fresh bf16
    weights, computing in bf16, and generate ``gen_tokens`` tokens each."""
    cfg = registry.get_model_config(arch)
    if reduced:
        cfg = registry.reduced(cfg)
    check_prompt(cfg, prompt_len, prompt_len + gen_tokens)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = model_lib.init_params(cfg, generator=gen, device=device,
                                  dtype=torch.bfloat16)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len, *cb),
                           generator=gen, device=device)
    res = generate(model, prompt, gen_tokens, temperature=temperature,
                   generator=gen)
    print(f"[serve] {cfg.name}: prefill {prompt_len} tok x {batch} seq "
          f"in {res.prefill_s:.3f} s", flush=True)
    if gen_tokens:
        print(f"[serve] decoded {gen_tokens} tok/seq in {res.decode_s:.3f} s: "
              f"{1e3 * res.decode_s / gen_tokens:.2f} ms/token, "
              f"{gen_tokens * batch / res.decode_s:.1f} tok/s aggregate",
              flush=True)
    return res


# ---------------------------------------------------------------------------
# the serving mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshServeResult:
    rows: slice                   # this rank's rows of the batch
    logits: torch.Tensor          # (b, T + 1[, C], V) of those rows: the
    #                               prefill's last position, then each
    #                               decode step's, every vocabulary column
    tokens: torch.Tensor          # (b, T[, C]) fed to the decode steps
    prefill_caches: List[Dict[str, torch.Tensor]]   # the rank's rows and
    #                               piece (KV heads, SSM heads and their
    #                               conv channels, LRU channels), at the
    #                               prompt's length: tp.gather_caches
    #                               joins the model ranks' pieces
    prefill_s: float
    decode_s: float
    launches: Dict[str, Dict[str, int]]   # kernel launches: prefill, decode
    collectives: dict             # ``collectives.collective_counts()``
    same_tokens: bool             # the model ranks fed the same tokens


@torch.no_grad()
def generate_on_mesh(mesh, cfg: ModelConfig, shard: Dict[str, torch.Tensor],
                     prompt: torch.Tensor, gen_tokens: int, *,
                     temperature: float = 1.0, generator=None, forced=None,
                     prefix=None, compute_dtype=torch.bfloat16,
                     seq_parallel: bool = True) -> MeshServeResult:
    """:func:`generate` on a serving mesh, on this rank: ``shard`` the
    rank's piece of the model's parameters (``tp.init_shard``, or
    ``tp.shard_params`` of a ``param_dict``), ``prompt`` (B, P[, C]) cut
    to its rows; one prefill step
    (``steps.build_prefill_step``, caches of the prompt's length, then
    grown), then ``gen_tokens`` eager decode steps
    (``steps.build_decode_step``) at (rows,) positions, each fed the token
    sampled from the step before (:func:`sample` with ``generator``; every
    rank of a model group holds the same logits and generator, so samples
    the same) or, with ``forced`` (B, T[, C]), that token (teacher
    forcing).  ``prefix`` (B, P', d): a vision-language model's prefix
    embeddings, run before the prompt in the prefill.  The prefill splits
    the residual's sequence over ``model`` (``seq_parallel=False``: whole
    on every model rank, as the decode steps keep it).  The collective
    counts are zeroed first; the tokens are compared over the model axis
    after the decode (the ``check`` phase)."""
    b, prompt_len = prompt.shape[:2]
    total = prompt_len + gen_tokens
    check_prompt(cfg, prompt_len, prompt_len)
    pre = steps_lib.build_prefill_step(
        cfg, InputShape("serve_prefill", prompt_len, b, "prefill"), mesh,
        compute_dtype=compute_dtype, seq_parallel=seq_parallel)
    dec = steps_lib.build_decode_step(
        cfg, InputShape("serve_decode", total, b, "decode"), mesh,
        compute_dtype=compute_dtype)
    rows = pre.rows
    nb = rows.stop - rows.start
    device = prompt.device
    caches = model_lib.init_cache(pre.cfg, nb, prompt_len,
                                  dtype=compute_dtype, device=device)
    collectives.zero_collective_counts()
    start = ops.launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    batch = {"tokens": prompt[rows]}
    if prefix is not None:
        batch["prefix"] = prefix[rows]
    logits, caches = pre(shard, batch, caches)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    after_prefill = ops.launch_counts()
    prefill_caches = caches
    caches = model_lib.grow_caches(pre.cfg, caches, total)
    outs, toks = [logits], []
    t0 = time.perf_counter()
    for i in range(gen_tokens):
        tok = (forced[rows, i:i + 1] if forced is not None
               else sample(logits, temperature, generator))
        toks.append(tok)
        pos = torch.full((nb,), prompt_len + i, dtype=torch.long,
                         device=device)
        logits, caches = dec(shard, caches, tok, pos)
        outs.append(logits)
    _sync(device)
    decode_s = time.perf_counter() - t0
    end = ops.launch_counts()
    tokens = (torch.cat(toks, dim=1) if toks
              else prompt.new_zeros((nb, 0, *prompt.shape[2:])))
    same = True
    if tokens.numel():
        with collectives.phase("check"):
            every = collectives.all_gather_rows(tokens[None],
                                                mesh.model_axis)
        same = bool((every == tokens[None]).all())
    return MeshServeResult(
        rows=rows, logits=torch.cat(outs, dim=1), tokens=tokens,
        prefill_caches=prefill_caches, prefill_s=prefill_s,
        decode_s=decode_s,
        launches={"prefill": {k: after_prefill[k] - start[k] for k in start},
                  "decode": {k: end[k] - after_prefill[k] for k in start}},
        collectives=collectives.collective_counts(), same_tokens=same)


def peak_memory_gb(device) -> float:
    """The rank's peak memory: the CUDA allocator's on the card, the
    process's resident set on the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device) / 1e9
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _comm_line(counts: dict, phase: str) -> str:
    kinds = counts.get(phase, {})
    secs = sum(v["seconds"] for v in kinds.values())
    parts = ", ".join(f"{k} {v['calls']} calls {v['bytes']} B"
                      for k, v in sorted(kinds.items()))
    return f"{phase} {secs:.3f} s ({parts or 'none'})"


def serve_on_world(arch: str, data: int, model: int, *, batch: int = 4,
                   prompt_len: int = 4096, gen_tokens: int = 32,
                   temperature: float = 1.0, device="cuda", seed: int = 0,
                   reduced: bool = False, backend: Optional[str] = None
                   ) -> MeshServeResult:
    """``--mesh DATAxMODEL``: joins torchrun's world (or starts one of one
    rank), makes the ``(data, model)`` serving mesh over it, draws the
    rank's shard of the weights (bf16; ``tp.init_shard``, the draws of
    ``init_params``) and the prompts from ``seed`` on every rank and runs
    :func:`generate_on_mesh`; rank 0 prints the report."""
    import torch.distributed as dist

    from repro_torch.dist import launch as dist_launch
    from repro_torch.launch import mesh as mesh_lib

    backend = backend or dist_launch.default_backend(device)
    dev = dist_launch.init_from_env(backend, device)
    try:
        mesh = mesh_lib.serve_mesh(data, model)
        cfg = registry.get_model_config(arch)
        if reduced:
            cfg = registry.reduced(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        shard = tp.init_shard(cfg, model, mesh.model_axis.rank,
                              generator=gen, device=dev,
                              dtype=torch.bfloat16)
        cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len, *cb),
                               generator=gen, device=dev)
        res = generate_on_mesh(mesh, cfg, shard, prompt, gen_tokens,
                               temperature=temperature, generator=gen)
        if not res.same_tokens:
            raise RuntimeError("the ranks of a model group sampled "
                               "different tokens")
        if dist.get_rank() == 0:
            where = (f"{cfg.name} on (data {data}, model {model}) over "
                     f"{backend}")
            print(f"[serve] {where}: prefill {prompt_len} tok x {batch} seq "
                  f"in {res.prefill_s:.3f} s", flush=True)
            if gen_tokens:
                print(f"[serve] decoded {gen_tokens} tok/seq in "
                      f"{res.decode_s:.3f} s (eager): "
                      f"{1e3 * res.decode_s / gen_tokens:.2f} ms/token, "
                      f"{gen_tokens * batch / res.decode_s:.1f} tok/s "
                      "aggregate", flush=True)
            c = res.collectives
            print(f"[serve] communication a rank: {_comm_line(c, 'prefill')}"
                  f"; {_comm_line(c, 'decode')}; staged "
                  f"{c['staged_bytes']} B", flush=True)
            print(f"[serve] peak memory a rank: "
                  f"{peak_memory_gb(dev):.3f} GB", flush=True)
        return res
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the production mesh, from the reference's specs
# ---------------------------------------------------------------------------

def _placement_leaves(node, out: list) -> list:
    """The placement tuples of a tree of them, in ``tree_lib``'s leaf
    order (dict keys sorted)."""
    if isinstance(node, dict):
        for k in sorted(node):
            _placement_leaves(node[k], out)
    elif isinstance(node, (list, tuple)) and not (
            node and all(isinstance(p, Placement) for p in node)):
        for v in node:
            _placement_leaves(v, out)
    else:
        out.append(node)
    return out


def _bytes_a_rank(tree, shards, mesh) -> int:
    """Σ over leaves of a leaf's bytes over the product of the sizes of
    the mesh axes that shard it (each divides its dim)."""
    sizes = [mesh.shape[a] for a in mesh.axis_names]
    leaves = tree_lib.leaves(tree)
    specs = _placement_leaves(shards, [])
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves, {len(specs)} placements")
    total = 0
    for t, pl in zip(leaves, specs):
        div = 1
        for size, p in zip(sizes, pl):
            if p.is_shard():
                div *= size
        total += t.numel() * t.element_size() // div
    return total


def serve_production(arch: str, shape_name: str,
                     multi_pod: bool = False) -> dict:
    """The bytes of the arguments a rank holds when the reference's
    serving steps run ``arch`` at ``SHAPES[shape_name]`` on the production
    mesh (reference :56): the bf16 parameters under
    ``serve_params_shardings``, the caches under ``_cache_shardings`` and
    the inputs (int32 tokens, f32 prefix; the batch dim over the batch
    axes where they divide it), counted from the ported specs, with
    ``long_context_variant`` for long_500k.  XLA's temporaries and outputs
    have no counterpart here: the count is of the arguments only."""
    from repro_torch.launch import mesh as mesh_lib

    cfg = registry.get_model_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        raise ValueError(f"{shape_name} is a training shape")
    if shape.name == "long_500k":
        cfg = steps_lib.long_context_variant(cfg)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    batch_axis = steps_lib._serve_batch_axes(mesh)[0]
    b, s = shape.global_batch, shape.seq_len
    params = steps_lib._bf16_params(steps_lib.params_sds(cfg))
    caches = steps_lib.cache_sds(cfg, b, s)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    tok_len = s if shape.kind == "prefill" else 1
    inputs = {"tokens": torch.empty((b, tok_len, *cb), dtype=torch.int32,
                                    device="meta")}
    if shape.kind == "prefill" and cfg.num_prefix_tokens:
        inputs["prefix"] = torch.empty((b, cfg.num_prefix_tokens,
                                        cfg.d_model), device="meta")
    if shape.kind != "prefill":
        inputs["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    in_shards = _input_placements(inputs, mesh, batch_axis)
    out = {"arch": arch, "shape": shape_name,
           "mesh": dict(zip(mesh.axis_names, mesh.axis_sizes)),
           "params_bytes": _bytes_a_rank(
               params, sh.serve_params_shardings(params, mesh), mesh),
           "caches_bytes": _bytes_a_rank(
               caches, steps_lib._cache_shardings(caches, mesh, batch_axis),
               mesh),
           "inputs_bytes": _bytes_a_rank(inputs, in_shards, mesh)}
    out["arguments_bytes"] = (out["params_bytes"] + out["caches_bytes"]
                              + out["inputs_bytes"])
    print(f"[serve] {arch} x {shape_name} on {out['mesh']}: arguments a "
          f"rank {out['arguments_bytes'] / 2**30:.3f} GiB (params "
          f"{out['params_bytes'] / 2**30:.3f}, caches "
          f"{out['caches_bytes'] / 2**30:.3f}, inputs "
          f"{out['inputs_bytes'] / 2**30:.6f}); arguments only: XLA's "
          "temporaries and outputs have no counterpart here", flush=True)
    return out


def _input_placements(inputs, mesh, batch_axis):
    """The inputs' placements: the batch dim over ``batch_axis`` where it
    divides it (reference :285-288), a scalar replicated."""
    return {k: sh.placements(
        ([steps_lib._maybe(batch_axis, t.shape[0], mesh)]
         + [None] * (t.dim() - 1)) if t.dim() else [], mesh)
        for k, t in inputs.items()}


@dataclasses.dataclass
class StepwiseResult:
    logits: torch.Tensor          # (B, P + T[, C], V): each step's, the
    #                               prompt's P steps, then the T decode steps
    tokens: torch.Tensor          # (B, T[, C]), the sampled tokens
    prefill_s: float
    decode_s: float
    capture_s: float


@torch.no_grad()
def generate_stepwise(model: model_lib.Model, prompt: torch.Tensor,
                      gen_tokens: int, *, temperature: float = 1.0,
                      generator=None, noise=None,
                      compute_dtype=torch.bfloat16,
                      capture=None) -> StepwiseResult:
    """The reference's local serve loop (``repro/launch/serve.py:23-53``,
    ``examples/serve.py``): ``prompt`` (B, P[, C]) token by token through
    a ``DecodeStep`` (for exactness across cache kinds), then
    ``gen_tokens`` steps, each fed the token sampled from the step before
    (``serving.decode.sample``: Gumbel noise from ``noise(shape)`` if
    given, else from ``generator``, drawn once a sample, in the
    reference's order)."""
    b, prompt_len = prompt.shape[:2]
    device = prompt.device
    caches = model_lib.init_cache(model.cfg, b, prompt_len + gen_tokens,
                                  dtype=compute_dtype, device=device)
    step = DecodeStep(model, caches, b, compute_dtype=compute_dtype,
                      capture=capture, sample=True)
    step.temps.fill_(temperature)
    shape = tuple(step.noise.shape)

    def draw():
        step.noise.copy_(noise(shape) if noise else
                         gumbel_noise(shape, generator, device))

    logits, toks = [], []
    _sync(device)
    t0 = time.perf_counter()
    for t in range(prompt_len):
        step.tokens.copy_(prompt[:, t:t + 1])
        step.pos.fill_(t)
        if t == prompt_len - 1 and gen_tokens:
            draw()
        step()
        logits.append(step.logits.clone())
    _sync(device)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(gen_tokens):
        tok = step.sampled[:, None].clone()
        toks.append(tok)
        step.tokens.copy_(tok)
        step.pos.fill_(prompt_len + i)
        if i < gen_tokens - 1:
            draw()
        step()
        logits.append(step.logits.clone())
    _sync(device)
    decode_s = time.perf_counter() - t0
    tokens = (torch.cat(toks, dim=1) if toks
              else prompt.new_zeros((b, 0, *prompt.shape[2:])))
    return StepwiseResult(logits=torch.cat(logits, dim=1), tokens=tokens,
                          prefill_s=prefill_s, decode_s=decode_s,
                          capture_s=step.capture_s)


def reduced_model_and_prompts(arch: str, batch: int, prompt_len: int, *,
                              device, seed: int = 0):
    """The local demos' inputs: the arch's reduced config with fresh f32
    weights (the reference's ``init_params``; bf16 compute and caches
    follow, as its ``decode_step``) and random prompts (B, P[, C]), both
    from one seeded generator, which is returned for the sampling."""
    cfg = registry.reduced(registry.get_model_config(arch))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = model_lib.init_params(cfg, generator=gen, device=device)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len, *cb),
                           generator=gen, device=device)
    return model, prompt, gen


def serve_local(arch: str, batch: int, prompt_len: int, gen_tokens: int,
                temperature: float, *, device="cuda", seed: int = 0,
                capture=None) -> StepwiseResult:
    """The reference's ``--local`` demo: :func:`generate_stepwise` on
    :func:`reduced_model_and_prompts`."""
    model, prompt, gen = reduced_model_and_prompts(
        arch, batch, prompt_len, device=device, seed=seed)
    res = generate_stepwise(model, prompt, gen_tokens,
                            temperature=temperature, generator=gen,
                            capture=capture)
    print(f"[serve] prefill {prompt_len} tok x {batch} seq: "
          f"{res.prefill_s:.2f}s", flush=True)
    print(f"[serve] decoded {gen_tokens} tok/seq in {res.decode_s:.2f}s "
          f"({gen_tokens * batch / res.decode_s:.1f} tok/s aggregate)",
          flush=True)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(registry.ARCHS),
                    help="served in full (prefill, then decode): "
                         "recurrentgemma-9b (the default), mamba2-1.3b; "
                         "served as prefill servers (--tokens 0), their "
                         "layers attending globally: qwen2-0.5b, "
                         "granite-moe-1b-a400m, musicgen-medium and the "
                         "other attention-only archs, which generate "
                         "through the continuous-batching engine "
                         "(repro_torch.serving.ServingEngine) or --local "
                         "(whose default is qwen2-0.5b)")
    ap.add_argument("--local", action="store_true",
                    help="the reference's single-device demo: the reduced "
                         "config, the prompt token by token through the "
                         "decode step, then sampled decode steps")
    ap.add_argument("--batch", type=int, default=None,
                    help="prompts in the batch (default 4; 2 with --local; "
                         "mamba2-1.3b is served at 8 on the card)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="tokens a prompt (default 4096, on the card for "
                         "both; 16 with --local)")
    ap.add_argument("--tokens", type=int, default=None,
                    help="new tokens a prompt, one decode step each "
                         "(default 32; 16 with --local)")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced CPU-test variant")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve on the world's (data, model) serving mesh "
                         "(torchrun, or a world of one rank: 1x1), the "
                         "other flags' defaults the full-width serve's")
    ap.add_argument("--dist-backend", default=None,
                    help="with --mesh: nccl (default on the card) or gloo "
                         "(default on the CPU)")
    ap.add_argument("--shape", default=None,
                    choices=[k for k, v in SHAPES.items()
                             if v.kind != "train"],
                    help="report the arguments' bytes a rank on the "
                         "production mesh at this shape (serve_production; "
                         "default arch qwen2-0.5b)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --shape: the (pod 2, data 16, model 16) mesh")
    args = ap.parse_args(argv)
    if args.shape:
        serve_production(args.arch or "qwen2-0.5b", args.shape,
                         args.multi_pod)
        return
    # the reference's --local defaults, or the full-width serve's
    defaults = (("qwen2-0.5b", 2, 16, 16) if args.local
                else ("recurrentgemma-9b", 4, 4096, 32))
    arch, batch, prompt_len, tokens = (
        d if v is None else v for v, d in zip(
            (args.arch, args.batch, args.prompt_len, args.tokens), defaults))
    if args.local:
        serve_local(arch, batch, prompt_len, tokens, args.temperature,
                    device=args.device, seed=args.seed)
        return
    if args.mesh:
        data, model = (int(x) for x in args.mesh.lower().split("x"))
        serve_on_world(arch, data, model, batch=batch, prompt_len=prompt_len,
                       gen_tokens=tokens, temperature=args.temperature,
                       device=args.device, seed=args.seed,
                       reduced=args.reduced, backend=args.dist_backend)
        return
    res = serve(arch, batch=batch, prompt_len=prompt_len,
                gen_tokens=tokens, temperature=args.temperature,
                device=args.device, seed=args.seed, reduced=args.reduced)
    print(f"[serve] tokens[0]: {res.tokens[0].tolist()}")


if __name__ == "__main__":
    main()
