"""The two routes of kernels B2, B5, B6, B7 and B8, and the C entry points'
signatures.

B5 (``csrc/flash_attention.cu``), B6 (``csrc/cross_entropy.cu``) and B7
(``csrc/ssd_scan.cu``) each have a tensor-core kernel and a CUDA-core
kernel; B2 (``csrc/fused_round.cu``) a kernel that holds each client's G in
a thread-block cluster and one that restreams it per block; B8
(``csrc/rglru_scan.cu``) a chunked single-pass scan and the walk of one
thread a channel.  Which one a call takes is a pure function of dtype,
shape, strides and alignment (``flash_attention.route``,
``cross_entropy.route``, ``ssd_scan.route``, ``fused_round.route``,
``rglru_scan.route``); it is held here on the CPU, where no kernel runs.
The shapes the main paths run must take the new route: the served
attention shape, the evaluated cross-entropy shape, the served SSD shapes,
the main path's and the quickstart's round geometries, and B8's served,
32k and serving-mesh shapes.  The ctypes signatures of
``_build.SIGNATURES`` are held against the ``extern "C"`` functions of the
sources, which only nvcc compiles.
"""
import _torch_threads  # noqa: F401
import re

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import _build
from repro_torch.kernels import cross_entropy as t_ce
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import fused_round as t_fr
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import rglru_scan as t_rg
from repro_torch.kernels import ssd_scan as t_ssd

BF16, F32 = torch.bfloat16, torch.float32
# the shapes the main paths run: recurrentgemma-9b's prefill of 4 × 4096
# tokens (attn_local, window 2048) and mamba2-1.3b's evaluation of 4 × 4096
# tokens a client against its tied 50280 × 2048 head
SERVED_ATTN = (4, 4096, 16, 1, 256)
EVAL_CE = (4 * 4096, 2048, 50280)
# mamba2-1.3b's SSD scan: (B, S) of the serve prefill, of evaluation and of
# prefill_32k at batch 1, × (H, P, N)
SERVED_SSD = [(8, 4096), (4, 4096), (1, 32768)]
MAMBA_SSD = (64, 64, 128)


def _meta(shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _attn_strides(b, s, h, kv, d, dtype=BF16):
    q, k = _meta((b, s, h, d), dtype), _meta((b, s, kv, d), dtype)
    return (q.stride(), k.stride(), k.stride())


def _ce_strides(n, d, v, *, tied=True, dtype=BF16):
    hidden = _meta((n, d), dtype)
    w = _meta((v, d), dtype) if tied else _meta((d, v), dtype).T
    return hidden.stride(), w.stride()


# ---------------------------------------------------------------------------
# B6: the cross-entropy's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied", [True, False])
def test_evaluate_shape_takes_the_tensor_core_route(tied):
    cfg = registry.get_model_config("mamba2-1.3b")
    n, d, v = EVAL_CE
    assert (d, v) == (cfg.d_model, cfg.vocab_size)
    hs, ws = _ce_strides(n, d, v, tied=tied)
    assert t_ce.route(BF16, hs, ws, True) == "tensor_core"


@pytest.mark.parametrize("n,d,v,tied", [
    (1, 16, 1, True), (130, 2048, 1000, True), (257, 256, 50280, False),
    (1, 2048, 50280, False), (100, 64, 1000, False), (80, 256, 512, True)])
def test_bf16_aligned_rows_take_the_tensor_core_route(n, d, v, tied):
    hs, ws = _ce_strides(n, d, v, tied=tied)
    assert t_ce.route(BF16, hs, ws, True) == "tensor_core"


@pytest.mark.parametrize("why,dtype,n,d,v,tied,aligned", [
    ("f32 tied", F32, 130, 2048, 1000, True, True),
    ("f32 untied", F32, 130, 2048, 1000, False, True),
    ("d = 33", BF16, 5, 33, 7, True, True),
    ("d = 33 untied", BF16, 5, 33, 1000, False, True),
    ("V = 7 untied: head rows of 14 bytes", BF16, 5, 64, 7, False, True),
    ("misaligned base", BF16, 130, 256, 1000, True, False),
    ("misaligned base, evaluate shape", BF16, *EVAL_CE, True, False),
])
def test_what_tma_cannot_read_takes_the_cuda_core_route(why, dtype, n, d, v,
                                                        tied, aligned):
    hs, ws = _ce_strides(n, d, v, tied=tied, dtype=dtype)
    assert t_ce.route(dtype, hs, ws, aligned) == "cuda_core", why


@pytest.mark.parametrize("hs,ws", [
    ((2048, 2), (2048, 1)),      # hidden's last dimension not contiguous
    ((2052, 1), (2048, 1)),      # hidden rows 4104 bytes apart
    ((2048, 1), (4100, 1)),      # head rows 8200 bytes apart (tied)
    ((2048, 1), (1, 50284)),     # head rows 100568 bytes apart (untied)
    ((2048, 1), (2, 4096)),      # neither head stride 1
])
def test_strides_off_16_byte_chunks_take_the_cuda_core_route(hs, ws):
    assert t_ce.route(BF16, hs, ws, True) == "cuda_core"


# ---------------------------------------------------------------------------
# B5: the attention's route
# ---------------------------------------------------------------------------

def test_served_attention_shape_takes_the_tensor_core_route():
    cfg = registry.get_model_config("recurrentgemma-9b")
    b, s, h, kv, d = SERVED_ATTN
    assert (h, kv, d) == (cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim)
    assert t_fa.route(BF16, d, _attn_strides(*SERVED_ATTN), True) == (
        "tensor_core")
    assert t_fa.route(BF16, d, _attn_strides(1, 32768, h, kv, d), True) == (
        "tensor_core")


@pytest.mark.parametrize("arch", sorted(
    a for a in registry.ARCHS
    if registry.get_model_config(a).num_heads))
def test_every_attention_config_takes_the_tensor_core_route(arch):
    """Every head_dim of ``repro_torch/configs`` is one the tensor-core
    kernel takes (≤ 256, a multiple of 8)."""
    cfg = registry.get_model_config(arch)
    d = cfg.resolved_head_dim
    strides = _attn_strides(1, 100, cfg.num_heads, cfg.num_kv_heads, d)
    assert t_fa.route(BF16, d, strides, True) == "tensor_core"


@pytest.mark.parametrize("d", [32, 64, 80, 128, 256])
def test_bf16_whole_chunk_rows_take_the_tensor_core_route(d):
    assert t_fa.route(BF16, d, _attn_strides(2, 70, 4, 2, d), True) == (
        "tensor_core")


@pytest.mark.parametrize("why,dtype,d,aligned", [
    ("f32", F32, 256, True),
    ("f32, D = 64", F32, 64, True),
    ("D = 33", BF16, 33, True),
    ("D = 36: rows of 72 bytes", BF16, 36, True),
    ("misaligned base", BF16, 64, False),
    ("misaligned base, served shape", BF16, 256, False),
    ("D past 256", BF16, 264, True),
])
def test_attention_the_tensor_cores_cannot_take_goes_to_cuda_cores(
        why, dtype, d, aligned):
    strides = _attn_strides(2, 70, 4, 1, d, dtype)
    assert t_fa.route(dtype, d, strides, aligned) == "cuda_core", why


def test_attention_stride_off_16_byte_chunks_takes_the_cuda_core_route():
    q, k = (8 * 16 * 64, 16 * 64, 64, 1), (8 * 64, 64, 64, 1)
    assert t_fa.route(BF16, 64, (q, k, k), True) == "tensor_core"
    assert t_fa.route(BF16, 64, (q, (8 * 68, 68, 68, 1), k), True) == (
        "cuda_core")
    assert t_fa.route(BF16, 64, (q, k, (8 * 64, 64, 64, 2)), True) == (
        "cuda_core")


# ---------------------------------------------------------------------------
# B7: the SSD scan's route, and its segments
# ---------------------------------------------------------------------------

def _ssd_strides(b, s, h, p, n):
    x, bc = _meta((b, s, h, p), F32), _meta((b, s, n), F32)
    return (x.stride(), bc.stride(), bc.stride())


@pytest.mark.parametrize("b,s", SERVED_SSD)
def test_served_ssd_shapes_take_the_tensor_core_route(b, s):
    cfg = registry.get_model_config("mamba2-1.3b")
    h, p, n = MAMBA_SSD
    assert (p, n) == (cfg.ssm.d_head, cfg.ssm.d_state)
    assert h == cfg.ssm.expand * cfg.d_model // p
    assert t_ssd.route(p, n, _ssd_strides(b, s, h, p, n), True) == (
        "tensor_core")


def test_the_models_strided_b_and_c_take_the_tensor_core_route():
    """In f32 compute the block hands the scan B and C as slices of the
    (B, S, d_in + 2N) convolution output: rows 4352 floats apart."""
    h, p, n = MAMBA_SSD
    x = _meta((2, 100, h, p), F32)
    conv = _meta((2, 100, h * p + 2 * n), F32)
    bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    assert t_ssd.route(p, n, (x.stride(), bm.stride(), cm.stride()),
                       True) == "tensor_core"


@pytest.mark.parametrize("p,n", [(32, 16), (64, 128), (8, 8), (4, 4),
                                 (36, 12)])
def test_whole_16_byte_rows_take_the_tensor_core_route(p, n):
    assert t_ssd.route(p, n, _ssd_strides(2, 37, 3, p, n), True) == (
        "tensor_core")


@pytest.mark.parametrize("why,p,n,strides,aligned", [
    ("P = 33", 33, 16, None, True),
    ("N = 6", 32, 6, None, True),
    ("misaligned base", 64, 128, None, False),
    ("B and C rows 259 floats apart", 64, 128,
     ((100 * 4 * 64, 4 * 64, 64, 1), (100 * 259, 259, 1),
      (100 * 259, 259, 1)), True),
    ("xdt heads 66 floats apart", 64, 128,
     ((100 * 4 * 66, 4 * 66, 66, 1), (100 * 128, 128, 1),
      (100 * 128, 128, 1)), True),
])
def test_ssd_rows_cp_async_cannot_stage_take_the_cuda_core_route(
        why, p, n, strides, aligned):
    strides = strides or _ssd_strides(2, 100, 4, p, n)
    assert t_ssd.route(p, n, strides, aligned) == "cuda_core", why


@pytest.mark.parametrize("b,s,want", [(8, 4096, 1), (4, 4096, 1),
                                      (1, 32768, 4), (2, 4096, 2),
                                      (1, 100, 2), (1, 64, 1)])
def test_segments_fill_the_card_only_when_the_batch_does_not(b, s, want):
    """One segment when B·H blocks fill the card's slots (the serve and
    evaluate shapes), more at batch 1 (prefill_32k: 4 × 128 chunks)."""
    h = MAMBA_SSD[0]
    nc = -(-s // 64)
    n_seg, per = t_ssd.segments(b, h, nc)
    assert n_seg == want
    assert (n_seg - 1) * per < nc <= n_seg * per


# ---------------------------------------------------------------------------
# B8: the RG-LRU scan's route
# ---------------------------------------------------------------------------

# every (B, S, W) at which chip_smoke.py runs B8, with the route the rule
# gives it: the kernels phase's grid (ragged S and W, one chunk and more),
# recurrentgemma-9b's served prefill (4 × 4096 tokens over its 4096 LRU
# channels) and its single-process prefill on the serving mesh (1 × 4096),
# prefill_32k's length, a (1, 2) mesh's model rank (2048 channels), the
# full-width train layer ((n = 2)·4 rows of 128 tokens) and its narrow twin
B8_SHAPES = {
    (1, 1, 1): "walk", (2, 17, 5): "walk", (2, 33, 257): "walk",
    (3, 300, 130): "chunked", (1, 1000, 4096): "chunked",
    (2, 129, 5): "chunked", (1, 257, 33): "chunked",
    (4, 4096, 4096): "chunked", (1, 4096, 4096): "chunked",
    (1, 32768, 4096): "chunked", (1, 4096, 2048): "chunked",
    (8, 128, 4096): "walk", (8, 128, 256): "walk",
}


@pytest.mark.parametrize("shape", sorted(B8_SHAPES))
def test_b8_shapes_take_the_rules_route(shape):
    assert t_rg.route(*shape) == B8_SHAPES[shape]


def test_b8_served_shapes_are_recurrentgemmas():
    cfg = registry.get_model_config("recurrentgemma-9b")
    w = cfg.rglru.lru_width
    assert (4, 4096, w) in B8_SHAPES and (1, 32768, w) in B8_SHAPES
    assert (1, 4096, w // 2) in B8_SHAPES
    assert t_ops.ROUTED["rglru_scan"] == t_rg.route(4, 4096, w)


@pytest.mark.parametrize("s,want", [(0, "walk"), (1, "walk"),
                                    (t_rg.CHUNK, "walk"),
                                    (t_rg.CHUNK + 1, "chunked"),
                                    (2 * t_rg.CHUNK, "chunked")])
def test_b8_takes_the_chunked_route_from_two_chunks(s, want):
    assert t_rg.route(2, s, 64) == want
    assert t_rg.route(0, s, 64) == t_rg.route(2, s, 0) == "walk"


@pytest.mark.parametrize("shape", sorted(B8_SHAPES))
def test_b8_walk_can_always_be_forced(shape):
    chosen = t_rg.route(*shape)
    assert _build.forced_route(chosen, "walk", universal="walk") == "walk"
    assert _build.forced_route(chosen, None, universal="walk") == chosen
    if chosen == "walk":
        with pytest.raises(ValueError, match="cannot take"):
            _build.forced_route(chosen, "chunked", universal="walk")


# ---------------------------------------------------------------------------
# B2: the whole round's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dz,cs", [(15, 1), (512, 8), (150, 4), (384, 8),
                                   (64, 1), (65, 2)])
def test_the_round_geometries_take_the_cluster_route(dz, cs):
    """dz = 15 is the quickstart's, 512 the main path's (dx 384 + dy 128),
    150 the JAX package's kernel test's."""
    assert t_fr.route(dz) == "cluster"
    assert t_fr.cluster_size(dz) == cs


@pytest.mark.parametrize("dz", [1, 2, 63, 127, 128, 129, 256, 257, 500, 511])
def test_the_cluster_is_the_smallest_that_holds_g(dz):
    cs = t_fr.cluster_size(dz)
    assert cs in t_fr.CLUSTER_SIZES
    assert -(-dz // cs) <= t_fr.ROWS_PER_BLOCK
    assert all(-(-dz // c) > t_fr.ROWS_PER_BLOCK
               for c in t_fr.CLUSTER_SIZES if c < cs)


@pytest.mark.parametrize("dz", [513, 640, 1024])
def test_a_slice_no_cluster_holds_takes_the_block_route(dz):
    assert t_fr.cluster_size(dz) == 0
    assert t_fr.route(dz) == "block"


def test_the_block_route_can_always_be_forced():
    for dz in (15, 512, 1024):
        chosen = t_fr.route(dz)
        assert _build.forced_route(chosen, "block", universal="block") == (
            "block")
    with pytest.raises(ValueError, match="cannot take"):
        _build.forced_route("block", "cluster", universal="block")


# ---------------------------------------------------------------------------
# forcing a route, and the counts by route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chosen", ["tensor_core", "cuda_core"])
def test_the_cuda_core_route_can_always_be_forced(chosen):
    assert _build.forced_route(chosen, None) == chosen
    assert _build.forced_route(chosen, "cuda_core") == "cuda_core"


def test_the_tensor_core_route_cannot_be_forced_on_what_it_cannot_take():
    assert _build.forced_route("tensor_core", "tensor_core") == "tensor_core"
    with pytest.raises(ValueError, match="cannot take"):
        _build.forced_route("cuda_core", "tensor_core")
    with pytest.raises(ValueError, match="cannot take"):
        _build.forced_route("cuda_core", "fastest")


def test_route_counts_start_at_zero_and_cpu_dispatch_counts_nothing():
    t_ops.zero_launch_counts()
    zero = {"tensor_core": 0, "cuda_core": 0}
    want = {"flash_attention": zero, "fused_cross_entropy": zero,
            "ce_partials": zero,
            "ssd_scan": zero, "rglru_scan": {"walk": 0, "chunked": 0},
            "fused_round": {"cluster": 0, "block": 0},
            "fused_gossip": {"unrolled": 0, "tiled": 0},
            "sparse_gossip": {"stripe": 0, "row_block": 0}}
    assert t_ops.route_counts() == want
    assert t_ops.backward_launch_counts() == {"rglru_scan": 0}
    q = torch.zeros((1, 4, 2, 8), dtype=BF16)
    t_ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    a = torch.full((2, 2 * t_rg.CHUNK + 1, 3), 0.5, requires_grad=True)
    t_ops.rglru_scan(a, a).sum().backward()
    h, w = torch.zeros((4, 8), dtype=BF16), torch.zeros((10, 8), dtype=BF16)
    t_ops.fused_cross_entropy(h, w, torch.zeros((4,), dtype=torch.long))
    t_ops.vocab_parallel_cross_entropy(
        h, w, torch.zeros((4,), dtype=torch.long), lambda m, l, z: (m, l, z))
    x = torch.zeros((1, 5, 2, 4))
    t_ops.ssd_scan(x, torch.zeros((1, 5, 2)), torch.zeros((1, 5, 4)),
                   torch.zeros((1, 5, 4)), chunk=4)
    n, dz, k = 2, 3, 2
    z = torch.zeros((n, dz))
    t_ops.fused_round(torch.eye(n), z, z, z, torch.zeros((n, dz, dz)),
                      torch.zeros((k, n, dz)), z, z, z, z + 1)
    assert t_ops.route_counts() == want
    assert t_ops.backward_launch_counts() == {"rglru_scan": 0}
    assert set(t_ops.ROUTED) <= set(t_ops.KERNELS)
    for name, new in t_ops.ROUTED.items():
        assert new in t_ops.KERNELS[name].routes


def test_zeroing_resets_the_counts_by_route():
    t_fa.flash_attention_bshd.routes["tensor_core"] += 3
    t_ce.fused_ce_nd.routes["cuda_core"] += 2
    t_ssd.ssd_scan_bshp.routes["tensor_core"] += 1
    t_fr.fused_round_nd.routes["cluster"] += 4
    t_rg.rglru_scan_bsw.routes["chunked"] += 2
    t_rg.rglru_scan_bsw.backward_launches += 2
    t_ops.zero_launch_counts()
    assert all(v == 0 for by in t_ops.route_counts().values()
               for v in by.values())
    assert t_ops.backward_launch_counts() == {"rglru_scan": 0}


def test_backward_launches_ride_a_captures_counts():
    """B8's backward launches inside ``uncounted`` (a CUDA graph's capture)
    do not count, and come back with each ``add_launch_counts`` (a replay),
    beside its forward launches by route."""
    t_ops.zero_launch_counts()
    with t_ops.uncounted() as delta:
        t_rg.rglru_scan_bsw.launches += 2
        t_rg.rglru_scan_bsw.routes["chunked"] += 2
        t_rg.rglru_scan_bsw.backward_launches += 2
    assert t_ops.backward_launch_counts() == {"rglru_scan": 0}
    assert t_ops.launch_counts()["rglru_scan"] == 0
    assert delta == {"rglru_scan": (2, {"walk": 0, "chunked": 2}, {}, 2)}
    t_ops.add_launch_counts(delta)
    t_ops.add_launch_counts(delta)
    assert t_ops.backward_launch_counts() == {"rglru_scan": 4}
    assert t_ops.route_counts()["rglru_scan"] == {"walk": 0, "chunked": 4}
    with t_ops.uncounted() as delta:
        t_rg.rglru_scan_bsw.backward_launches += 1
    assert delta == {"rglru_scan": (0, {"walk": 0, "chunked": 0}, {}, 1)}
    t_ops.zero_launch_counts()


# ---------------------------------------------------------------------------
# the C entry points against their ctypes signatures
# ---------------------------------------------------------------------------

def _extern_c_params(name: str, fn: str):
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern\s+"C"\s+\w+\s+' + re.escape(fn) + r"\s*\(([^)]*)\)",
                  src)
    assert m, f'csrc/{name}.cu has no extern "C" {fn}'
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_extern_c_function(name):
    """Every C entry point of ``csrc/<name>.cu`` — B1's and B4's two each
    (the first port's kernel, and the new route's pair launch)."""
    for fn, argtypes in _build.SIGNATURES[name].items():
        params = _extern_c_params(name, fn)
        assert len(params) == len(argtypes), (name, fn, params)
        # pointers and the stream are c_void_p; integers c_int or c_longlong
        for p, t in zip(params, argtypes):
            if "*" in p:
                assert t is _build._P, (name, fn, p)
            elif p.startswith("long long"):
                assert t is _build._L, (name, fn, p)
            elif p.startswith("int"):
                assert t is _build._I, (name, fn, p)
            else:
                assert p.startswith("float"), (name, fn, p)
                assert t is _build._F, (name, fn, p)


def test_every_source_has_a_signature():
    assert set(_build.SIGNATURES) == set(_build.SOURCES)
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
