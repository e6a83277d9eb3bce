"""The port stands alone: no JAX, no reference package, no silent CPU.

  * importing every module of ``repro_torch`` pulls in neither ``jax`` nor
    anything of ``repro`` (checked in a fresh interpreter);
  * no source file of the port, nor ``chip_smoke.py``, imports them;
  * entry points default to the card and raise without one unless the
    caller asks for ``device="cpu"``.
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.core.kan_layer import KANSpec, init_kan_layer, init_kan_network
from repro_torch.core.kan_network_deploy import (
    deploy_kan_ffn_stack,
    deploy_kan_network,
    quantize_kan_network,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_import_pulls_in_no_jax_and_no_reference():
    mods = _all_modules()
    for m in ("kernels.kan_spline.pipeline", "kernels.attention.ops",
              "models.model", "serve.engine", "serve.scheduler",
              "launch.serve", "configs.registry", "core.kan_ffn_deploy",
              "core.tmdv", "core.cim", "core.sam", "kernels.cim_mac.ops",
              "kernels.cim_mac.cardcheck", "obs.metrics", "obs.trace",
              "obs.logging", "obs.exposition", "serve.spec",
              "serve.cardcheck", "core.costmodel", "core.neurosim",
              "core.mlp_baseline", "train.optimizer", "tune.space",
              "tune.search", "tune.tiles", "tune.artifact", "data.lm_data",
              "train.train_state", "train.checkpoint", "train.loop",
              "train.cardcheck", "launch.train", "models.cardcheck",
              "examples.quickstart", "examples.knot_e2e",
              "examples.neurosim_search", "examples.tune_deploy",
              "examples.lm_kan_train", "examples.serve_demo"):
        assert f"repro_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_never_import_jax_or_the_reference():
    pat = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)\b"
                     r"|from\s+repro\.)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        hits = pat.findall(path.read_text())
        assert not hits, (path, hits)


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kspec = KANSpec(dims=(3, 2), grid_size=4)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kan_network(gen, kspec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kan_layer(gen, 3, 2, kspec.layer_spec())
    params = init_kan_network(gen, kspec, device="cpu")
    qparams = quantize_kan_network(params, kspec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deploy_kan_network(qparams, kspec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deploy_kan_ffn_stack(qparams, kspec.dims, kspec.layer_spec())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy([{k: v.numpy() for k, v in params[0].items()}])
    dep = deploy_kan_network(qparams, kspec, device="cpu")
    assert dep.device.type == "cpu"


def test_lm_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve as cli
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("qwen2.5-14b").kan_variant()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(gen, cfg)
    params = init_params(gen, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(params, cfg, kan_deploy=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--arch", "qwen2.5-14b", "--requests", "1"])
    eng = ServeEngine(params, cfg, slots=1, max_len=16, device="cpu")
    assert eng.device.type == "cpu"


def test_train_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch,
                                                             tmp_path):
    from repro_torch.configs import smoke_config
    from repro_torch.data.lm_data import DataConfig
    from repro_torch.launch import train as cli
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.train_state import init_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("qwen2.5-14b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainLoop(cfg, dcfg, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--arch", "qwen2.5-14b", "--smoke", "--steps", "1",
                  "--ckpt-dir", str(tmp_path / "b")])
    loop = TrainLoop(cfg, dcfg, str(tmp_path / "c"), device="cpu")
    assert loop.state["params"]["embed"].device.type == "cpu"


@pytest.mark.parametrize("name", ["quickstart", "knot_e2e", "neurosim_search",
                                  "tune_deploy", "lm_kan_train",
                                  "serve_demo"])
def test_example_mains_need_a_card_unless_asked_for_cpu(monkeypatch,
                                                        tmp_path, name):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
    assert list(tmp_path.iterdir()) == []  # raised before writing anything
