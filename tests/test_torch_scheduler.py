"""The port's continuous-batching engine (``repro_torch.serving``) against
``repro.serving.ServingEngine``, and what it stands on: per-slot decode
positions, the Gumbel-argmax sampling, the captured tick.

Both engines serve the same requests on the same reduced model (the
reference's ``init_params`` carried across by ``models.interop``): 2
slots, caches of 48 positions, 5 requests (prompts of 3–9 tokens, 2–5
new tokens, from a numpy seed), one of them retired by an EOS token it
reaches and one by the cache's cap.  The reference's draws are caught
each tick by wrapping its engine's ``_step`` (its positions, samples and
new caches), and its samples are fed to the port as its noise (0 at the
sampled token, −inf elsewhere: Gumbel-argmax then picks that token), so
the two schedules stay alike and are held tick by tick.

Tolerances, max |Δ| ≤ tol·(1 + max|reference|): the caches in bf16
compute 3e-2 (``tests/test_torch_serve.py``'s bf16 serve limit: the two
frameworks round bf16 at other places); positions, active counts,
retirements, outputs and tick counts exactly; the port against itself
(positions, a captured tick) bit for bit.
"""
import functools

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as jax_model
from repro.serving import scheduler as jax_sched
from repro_torch.configs import registry
from repro_torch.models import interop
from repro_torch.models import model as t_model
from repro_torch.serving import decode as t_decode
from repro_torch.serving import scheduler as t_sched

ARCHS = ("qwen2-0.5b", "recurrentgemma-9b", "granite-moe-1b-a400m",
         "musicgen-medium", "mamba2-1.3b")
SLOTS, MAX_LEN, N_REQ = 2, 48, 5
EOS_UID, CAP_UID = 2, 0
TOL_BF16 = 3e-2


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jax_registry.reduced(jax_registry.get_model_config(arch))
    tcfg = registry.reduced(registry.get_model_config(arch))
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    model = interop.params_from_reference(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    return jcfg, params, tcfg, model


def _requests(cfg, eos=None):
    """N_REQ requests from a numpy seed; CAP_UID asks for more tokens than
    the cache holds, EOS_UID stops at ``eos`` (a token it samples)."""
    rng = np.random.default_rng(0)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    reqs = []
    for uid in range(N_REQ):
        prompt = rng.integers(0, cfg.vocab_size,
                              (int(rng.integers(3, 10)), *cb)).astype(
                                  np.int32)
        reqs.append(dict(uid=uid, prompt=prompt,
                         max_new_tokens=int(rng.integers(2, 6)),
                         temperature=(1.0, 0.7)[uid % 2]))
    reqs[CAP_UID]["max_new_tokens"] = MAX_LEN
    reqs[EOS_UID]["max_new_tokens"] = 5
    reqs[EOS_UID]["eos_token"] = eos
    return reqs


def _reference_engine(cfg, params, reqs, step=None):
    """The reference engine over ``reqs``, run to its end as ``run`` does,
    its ``_step`` wrapped to catch each tick's positions, samples and new
    caches; ``step``: a compiled step to reuse.  Returns (engine, its
    compiled step, the ticks, the active count of each)."""
    eng = jax_sched.ServingEngine(cfg, params, num_slots=SLOTS,
                                  max_len=MAX_LEN, rng=0)
    compiled = step or eng._step
    ticks = []

    def caught(params, caches, tokens, pos_vec, key, temps):
        sampled, new = compiled(params, caches, tokens, pos_vec, key, temps)
        ticks.append(dict(pos=np.array(pos_vec), sampled=np.array(sampled),
                          caches=jax.tree.map(np.array, new)))
        return sampled, new

    eng._step = caught
    for r in reqs:
        eng.submit(jax_sched.Request(**r))
    active = []
    while True:
        n = eng.tick()
        if not n and not eng.queue:
            break
        active.append(n)
    return eng, compiled, ticks, active


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """A first run finds the EOS request's second token; the second run,
    with that EOS (the same draws until it retires), is the one held."""
    jcfg, params, _, _ = _models(arch)
    first, step, _, _ = _reference_engine(jcfg, params, _requests(jcfg))
    eos = first.done[EOS_UID].output[1]
    eos = eos if jcfg.num_codebooks else int(eos)
    eng, _, ticks, active = _reference_engine(jcfg, params,
                                              _requests(jcfg, eos), step)
    return _requests(jcfg, eos), eng, ticks, active


def _forcing(samples):
    """Noise under which Gumbel-argmax picks ``samples``."""
    def noise(shape):
        out = np.full(shape, -np.inf, np.float32)
        np.put_along_axis(out, next(samples)[..., None].astype(np.int64),
                          0.0, axis=-1)
        return torch.from_numpy(out)
    return noise


def _port_engine(model, reqs, **kw):
    eng = t_sched.ServingEngine(model, num_slots=SLOTS, max_len=MAX_LEN,
                                **kw)
    for r in reqs:
        eng.submit(t_sched.Request(**r))
    return eng


def _rel(got, want):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / (1 + float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_reference_tick_by_tick(arch):
    reqs, ref, ticks, active = _reference_run(arch)
    _, _, tcfg, model = _models(arch)
    eng = _port_engine(model, reqs, noise=_forcing(
        iter(t["sampled"] for t in ticks)))
    worst = 0.0
    for i, (tick, n) in enumerate(zip(ticks, active)):
        assert eng.tick() == n, i
        np.testing.assert_array_equal(eng.step.pos.numpy(), tick["pos"])
        want = interop.caches_from_reference(tick["caches"], tcfg,
                                             device="cpu")
        for got_layer, want_layer in zip(eng.caches, want):
            for name, got in got_layer.items():
                err = _rel(got, want_layer[name].to(torch.float32))
                assert err <= TOL_BF16, (i, name, err)
                worst = max(worst, err)
    assert eng.tick() == 0 and not eng.queue
    assert eng._tick == ref._tick == len(ticks)
    # retirements: the same requests in the same order, the EOS one on its
    # EOS token, the cap one at the cap, the same outputs
    assert list(eng.done) == list(ref.done)
    assert len(eng.done[EOS_UID].output) < reqs[EOS_UID]["max_new_tokens"]
    assert np.all(eng.done[EOS_UID].output[-1] == reqs[EOS_UID]["eos_token"])
    cap = eng.done[CAP_UID]
    assert len(cap.prompt) + len(cap.output) - 1 == MAX_LEN - 1
    for uid, req in ref.done.items():
        assert eng.done[uid].output.shape == req.output.shape
        np.testing.assert_array_equal(eng.done[uid].output, req.output)
    assert worst > 0


@pytest.mark.parametrize("codebooks", [0, 3])
def test_gumbel_argmax_is_jax_categorical(codebooks):
    """The port's sampling with the reference's ``jax.random.gumbel``
    draws gives ``jax.random.categorical``'s tokens, per-slot temperatures
    included."""
    rng = np.random.default_rng(1)
    cb = (codebooks,) if codebooks else ()
    logits = rng.standard_normal((4, *cb, 512)).astype(np.float32) * 3
    temps = np.array([1.0, 0.7, 2.0, 0.3], np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        t_b = temps.reshape((-1,) + (1,) * (logits.ndim - 1))
        want = jax.random.categorical(key, jnp.asarray(logits) / t_b,
                                      axis=-1)
        g = jax.random.gumbel(key, logits.shape, jnp.float32)
        got = t_decode.sample(torch.from_numpy(logits)[:, None],
                              torch.from_numpy(temps),
                              torch.from_numpy(np.array(g)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b"])
def test_per_row_positions_equal_int_positions(arch):
    """``decode_step`` at a (B,) position tensor: row b bit for bit what
    an int-position call at that row's position gives it (the whole batch
    in both, as the CPU's GEMMs round a row by the batch it is in), and
    within 1e-6·(1 + max) of a single-row call.  Positions past the
    window (32) wrap recurrentgemma-9b's ring; past the cache (48) clamp
    qwen2-0.5b's."""
    tcfg = registry.reduced(registry.get_model_config(arch))
    model = t_model.init_params(tcfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    pos = torch.tensor([0, 5, 31, 40, 47, 60])
    b = len(pos)
    caches = [{k: torch.randn(v.shape, generator=gen) for k, v in c.items()}
              for c in t_model.init_cache(tcfg, b, MAX_LEN,
                                          dtype=torch.float32, device="cpu")]
    toks = torch.randint(0, tcfg.vocab_size, (b, 1), generator=gen)
    f32 = dict(compute_dtype=torch.float32)
    with torch.no_grad():
        logits, new = t_model.decode_step(model, caches, toks, pos, **f32)
        for r in range(b):
            one, one_new = t_model.decode_step(model, caches, toks,
                                               int(pos[r]), **f32)
            assert torch.equal(logits[r], one[r]), r
            for c, o in zip(new, one_new):
                for name in c:
                    assert torch.equal(c[name][r], o[name][r]), (r, name)
            row, _ = t_model.decode_step(
                model, [{k: v[r:r + 1] for k, v in c.items()}
                        for c in caches], toks[r:r + 1], int(pos[r]), **f32)
            assert _rel(logits[r], row[0].numpy()) <= 1e-6, r


class FakeGraph:
    """A CUDA graph's protocol on the CPU (as ``tests/test_torch_train.py``):
    capture runs the body and stores nothing, a replay runs it and
    stores."""

    capturing = False

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        self.fn = fn
        self.capturing = True
        try:
            fn()
        finally:
            self.capturing = False

    def replay(self):
        self.fn()

    def write(self, dst, src):
        if not self.capturing:
            dst.copy_(src)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "musicgen-medium"])
def test_captured_tick_equals_the_eager_tick(monkeypatch, arch):
    """The engine through a fake graph against ``capture=False``, from the
    same seed: tokens, caches and logits bit for bit every tick, and the
    capture leaves the buffers as they were."""
    monkeypatch.setattr(t_decode.DecodeStep, "graph_type", FakeGraph)
    _, _, tcfg, model = _models(arch)
    reqs = _requests(tcfg)
    eager = _port_engine(model, reqs, capture=False, seed=3)
    graph = _port_engine(model, reqs, capture=True, seed=3)
    assert eager.step.graph is None and isinstance(graph.step.graph,
                                                   FakeGraph)
    for a, b in zip(eager.caches, graph.caches):
        assert all(not b[k].any() for k in b)
    while True:
        n = eager.tick()
        assert graph.tick() == n
        if not n and not eager.queue:
            break
        for name in ("sampled", "logits", "pos", "tokens"):
            assert torch.equal(getattr(eager.step, name),
                               getattr(graph.step, name)), name
        for a, b in zip(eager.caches, graph.caches):
            for k in a:
                assert torch.equal(a[k], b[k]), k
    assert list(eager.done) == list(graph.done)


def _first_tick_of(cfg, params, model, order, uid):
    """``order`` served through a 1-slot pool by the reference and by the
    port (fed the reference's samples): each one's caches after the first
    tick of request ``uid``."""
    eng = jax_sched.ServingEngine(cfg, params, num_slots=1, max_len=MAX_LEN,
                                  rng=0)
    compiled, seen = eng._step, []

    def caught(*args):
        sampled, new = compiled(*args)
        seen.append((np.array(sampled), jax.tree.map(np.array, new)))
        return sampled, new

    eng._step = caught
    port = t_sched.ServingEngine(
        model, num_slots=1, max_len=MAX_LEN, capture=False,
        noise=_forcing(iter(s for s, _ in seen)))
    for r in order:
        eng.submit(jax_sched.Request(**r))
        port.submit(t_sched.Request(**r))
    while True:
        eng._admit()
        if eng.slots[0].request.uid == uid:
            break
        eng.tick()
        port.tick()
    eng.tick()
    port.tick()
    return (interop.caches_from_reference(seen[-1][1], model.cfg,
                                          device="cpu"), port.caches)


def test_recurrent_state_carries_into_the_next_request():
    """ROADMAP §C quirk 6: admission resets no cache, so on the reduced
    mamba2-1.3b a request served after another in a 1-slot pool starts
    from that request's SSM state, in the reference and in the port
    alike: after its first tick its caches (the convolution's window,
    the SSD state) differ from the same request's in a fresh slot, and
    the port's carried caches are the reference's."""
    jcfg, params, tcfg, model = _models("mamba2-1.3b")
    reqs = _requests(jcfg)
    a, b = dict(reqs[1], max_new_tokens=3), dict(reqs[3], max_new_tokens=3)
    fresh = _first_tick_of(jcfg, params, model, [b], b["uid"])
    second = _first_tick_of(jcfg, params, model, [a, b], b["uid"])
    for pkg in (0, 1):
        diff = max(float((f[k].float() - s[k].float()).abs().max())
                   for f, s in zip(fresh[pkg], second[pkg]) for k in f)
        assert diff > 0.1, (pkg, diff)
    for got, want in zip(second[1], second[0]):
        for name in got:
            assert _rel(got[name], want[name].float()) <= TOL_BF16, name
