"""The port's twins of ``examples/robust_lm.py`` and
``examples/adversarial_training.py`` (``repro_torch.launch.robust_lm``,
``repro_torch.launch.adversarial_training``): the ``robust_lm`` twin's
``SMALL`` config and training settings equal the reference's field for
field, and each twin runs 2 rounds on the CPU at its smallest size.
"""
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from unittest import mock

import pytest

from repro_torch.configs import registry
from repro_torch.launch import adversarial_training as t_adv
from repro_torch.launch import robust_lm as t_robust

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
