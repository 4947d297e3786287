"""The port's twins of ``examples/robust_lm.py``,
``examples/adversarial_training.py`` and ``examples/serve.py``
(``repro_torch.launch.robust_lm``, ``adversarial_training``,
``serve_example``): the ``robust_lm`` twin's ``SMALL`` config and
training settings equal the reference's field for field, and each
training twin runs 2 rounds on the CPU at its smallest size; the serving
twin's every step's logits match the reference's loop on its weights,
prompt and draws within 3e-2·(1 + max) (bf16 compute, as
``tests/test_torch_serve.py``), and it and ``launch.serve --local`` run
on the CPU.
"""
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from unittest import mock

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as jax_model
from repro_torch.configs import registry
from repro_torch.launch import adversarial_training as t_adv
from repro_torch.launch import robust_lm as t_robust
from repro_torch.launch import serve as t_serve
from repro_torch.launch import serve_example as t_serve_example
from repro_torch.models import interop

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Caught(Exception):
    pass


def _reference_namespace(argv):
    """The Namespace ``examples/robust_lm.py`` hands ``train``, caught
    before the run (which writes nothing then)."""
    ref = _example("robust_lm")
    seen = []

    def train(ns):
        seen.append(ns)
        raise _Caught

    with mock.patch.object(ref.train_lib, "train", train), \
            mock.patch.object(sys, "argv", ["robust_lm.py", *argv]), \
            mock.patch.dict(ref.ARCHS), pytest.raises(_Caught):
        ref.main()
    return ref, seen[0]


def test_robust_lm_small_config_equals_the_reference():
    ref = _example("robust_lm")
    assert dataclasses.asdict(t_robust.SMALL) == dataclasses.asdict(
        ref.SMALL)


@pytest.mark.parametrize("argv", [[], ["--full", "--clients", "8",
                                       "--local-steps", "2", "--alpha",
                                       "0.5", "--rounds", "30"]])
def test_robust_lm_train_settings_equal_the_reference(argv):
    """Every setting the reference passes to ``train`` but its output
    paths."""
    _, want = _reference_namespace(argv)
    got = t_robust.train_args(t_robust.parser().parse_args(argv))
    for key, value in vars(want).items():
        if key not in ("out", "checkpoint_dir"):
            assert getattr(got, key) == value, key


def test_robust_lm_runs_two_rounds_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setitem(registry.ARCHS, t_robust.SMALL.name, t_robust.SMALL)
    out = tmp_path / "robust_lm.json"
    t_robust.main(["--device", "cpu", "--clients", "2", "--local-steps",
                   "1", "--rounds", "2", "--out", str(out),
                   "--checkpoint-dir", str(tmp_path / "ckpt")])
    hist = json.loads(out.read_text())["history"]
    assert [r["round"] for r in hist] == [0, 1]
    assert all(math.isfinite(r[k]) for r in hist
               for k in ("f_bar", "mean_loss", "eval_loss"))


def test_adversarial_training_runs_two_rounds_on_cpu(capsys):
    state, hist = t_adv.main(["--device", "cpu", "--clients", "2",
                              "--rounds", "2", "--chunk", "2"])
    assert state.round == 2
    assert [r["round"] for r in hist] == [0, 1]
    for r in hist:
        assert all(math.isfinite(r[k]) for k in ("clean_loss", "adv_loss",
                                                 "y_norm"))
    # y ascends from 0: the perturbation grows
    assert 0 < hist[0]["y_norm"] < hist[1]["y_norm"]
    assert capsys.readouterr().out.count("adversarial loss") == 2


def _reference_serve_loop(cfg, params, batch, prompt_len, tokens,
                          temperature):
    """The loop of ``examples/serve.py`` (its prompt from PRNGKey(0),
    token-by-token prefill, sampled decode), its ``decode_step`` jitted:
    (prompt, every step's logits, the sampled tokens)."""
    key = jax.random.PRNGKey(0)
    prompt = jax.random.randint(key, (batch, prompt_len), 0, cfg.vocab_size)
    caches = jax_model.init_cache(cfg, batch, prompt_len + tokens)
    step = jax.jit(lambda p, c, t, pos: jax_model.decode_step(p, c, t, pos,
                                                              cfg))
    steps, draws = [], []
    for t in range(prompt_len):
        logits, caches = step(params, caches, prompt[:, t:t + 1],
                              jnp.int32(t))
        steps.append(np.array(logits.astype(jnp.float32)))
    for i in range(tokens):
        key, ks = jax.random.split(key)
        tok = jax.random.categorical(
            ks, logits[:, -1].astype(jnp.float32) / temperature, axis=-1)
        draws.append(np.array(tok))
        logits, caches = step(params, caches, tok[:, None],
                              jnp.int32(prompt_len + i))
        steps.append(np.array(logits.astype(jnp.float32)))
    return np.array(prompt), np.concatenate(steps, axis=1), np.stack(draws, 1)


def test_serve_example_logits_match_the_reference_loop():
    """The twin's loop (``launch.serve.generate_stepwise``) at the
    example's defaults (reduced qwen2-0.5b, 2 prompts of 32 tokens, 16
    new, temperature 1): the reference's samples fed to it as its noise
    (0 at the sample, −inf elsewhere), so both decode the same tokens;
    every step's logits held."""
    arch, batch, prompt_len, tokens = "qwen2-0.5b", 2, 32, 16
    cfg = jax_registry.reduced(jax_registry.get_model_config(arch))
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    prompt, want, draws = _reference_serve_loop(cfg, params, batch,
                                                prompt_len, tokens, 1.0)
    model = interop.params_from_reference(
        jax.tree.map(np.asarray, params),
        registry.reduced(registry.get_model_config(arch)), device="cpu")
    samples = iter(draws[:, i] for i in range(tokens))

    def noise(shape):
        out = np.full(shape, -np.inf, np.float32)
        np.put_along_axis(out, next(samples)[:, None].astype(np.int64), 0.0,
                          axis=-1)
        return torch.from_numpy(out)

    res = t_serve.generate_stepwise(model, torch.from_numpy(prompt).long(),
                                    tokens, noise=noise)
    np.testing.assert_array_equal(res.tokens.numpy(), draws)
    got = res.logits.float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / (1 + np.abs(want).max())
    assert 0 < err <= 3e-2, err


@pytest.mark.parametrize("argv,lines", [
    (["--local", "--device", "cpu"],
     ["[serve] prefill 16 tok x 2 seq:", "[serve] decoded 16 tok/seq in"]),
    (["--local", "--device", "cpu", "--arch", "musicgen-medium",
      "--prompt-len", "5", "--tokens", "3"],
     ["[serve] prefill 5 tok x 2 seq:", "[serve] decoded 3 tok/seq in"])])
def test_serve_local_runs_on_cpu(capsys, argv, lines):
    """``launch.serve --local``: the reference's ``serve_local`` lines."""
    t_serve.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert [ln[:len(want)] for ln, want in zip(out, lines)] == lines


def test_serve_example_runs_on_cpu(capsys):
    res = t_serve_example.main(["--device", "cpu", "--arch", "mamba2-1.3b",
                                "--prompt-len", "6", "--tokens", "4"])
    assert res.tokens.shape == (2, 4)
    assert res.logits.shape[:2] == (2, 10)
    assert torch.isfinite(res.logits.float()).all()
    out = capsys.readouterr().out
    assert "prefill 6 tokens" in out and "decoded 4 tokens/seq" in out
