"""The port imports without jax, never imports jax or ``repro``, and its
entry points refuse to run on the CPU unless asked to."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_imports_with_jax_absent():
    code = ("import sys, pkgutil\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, prefix='repro_torch.')]\n"
            "for n in names:\n"
            "    __import__(n)\n"
            "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_modules()) > 15


def _forbidden(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Attribute)
              and isinstance(node.value, ast.Name) and node.value.id == "jax"):
            bad.append(f"{path.name}:{node.lineno} jax.{node.attr}")
            continue
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.name}:{node.lineno} import {n}")
    return bad


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    assert _forbidden(path) == []


def _entry_points():
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import neural_market as NM
    from repro_torch.core.cascade import CascadeTier, execute_cascade
    from repro_torch.core.scorer import SCORER_CFG
    from repro_torch.models.classifier import init_classifier
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.builder import assemble_pipeline
    from repro_torch.serving.pipeline import ServingPipeline, TierSpec

    from repro_torch.configs.registry import ARCHS
    from repro_torch.serving.engine import EnginePool, GenerationEngine

    cfg = NM.tier_config("GPT-J")
    gemma = ARCHS["gemma3-1b"].reduced()
    granite = ARCHS["granite-moe-1b-a400m"].reduced()
    mamba = ARCHS["mamba2-1.3b"].reduced()
    tier = CascadeTier("t", lambda q: (np.zeros(len(q), int),
                                       np.zeros(len(q))))
    return {
        "GenerationEngine": lambda: GenerationEngine(
            gemma, init_params(gemma, device="cpu")),
        "EnginePool.get": lambda: EnginePool().get(
            gemma, init_params(gemma, device="cpu")),
        "GenerationEngine[moe]": lambda: GenerationEngine(
            granite, init_params(granite, device="cpu")),
        "GenerationEngine[ssm]": lambda: GenerationEngine(
            mamba, init_params(mamba, device="cpu")),
        "init_params": lambda: init_params(cfg),
        "init_params[moe]": lambda: init_params(granite),
        "init_params[ssm]": lambda: init_params(mamba),
        "init_classifier": lambda: init_classifier(SCORER_CFG, 1),
        "init_marketplace": lambda: NM.init_marketplace(
            "headlines", tiers=NM.tier_subset(["GPT-J"])),
        "params_from_numpy": lambda: params_from_numpy(
            {"embed": {}, "period": {"sub0": {}}}, cfg),
        "assemble_pipeline": lambda: assemble_pipeline(
            NM.init_marketplace("headlines", tiers=NM.tier_subset(["GPT-J"]),
                                device="cpu"),
            init_classifier(SCORER_CFG, 1, device="cpu"), [], [None]),
        "ServingPipeline": lambda: ServingPipeline(
            [TierSpec("t", lambda q: q, NM.TABLE1["GPT-J"])], [],
            lambda q, a: a),
        "execute_cascade": lambda: execute_cascade(
            [tier], [], None, np.zeros((3, 2)), compact="device"),
    }


@pytest.mark.parametrize("name", ["GenerationEngine", "EnginePool.get",
                                  "GenerationEngine[moe]",
                                  "GenerationEngine[ssm]", "init_params",
                                  "init_params[moe]", "init_params[ssm]",
                                  "init_classifier",
                                  "init_marketplace", "params_from_numpy",
                                  "assemble_pipeline", "ServingPipeline",
                                  "execute_cascade"])
def test_entry_point_without_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()
