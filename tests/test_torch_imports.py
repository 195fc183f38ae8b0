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


def _grad_calls(device):
    """name -> call of each float kernel wrapper on small inputs made on
    ``device``, each input requiring grad."""
    from repro_torch.kernels.decode_attention.ops import gqa_decode
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.moe_gmm.ops import gmm
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    g = torch.Generator().manual_seed(0)

    def r(*shape, fn=None):
        t = torch.randn(*shape, generator=g)
        return (t if fn is None else fn(t)).to(device).requires_grad_()

    q, k, v = r(2, 5, 4, 8), r(2, 5, 2, 8), r(2, 5, 2, 8)
    dt = r(1, 6, 2, fn=torch.nn.functional.softplus)
    a = r(2, fn=lambda t: -torch.exp(t))
    ssd_in = (r(1, 6, 2, 4), dt, a, r(1, 6, 3), r(1, 6, 3))
    return {"mha": lambda: mha(q, k, v),
            "gqa_decode": lambda: gqa_decode(r(2, 1, 4, 8), k, v, 4),
            "gmm": lambda: gmm(r(2, 3, 4), r(2, 4, 5)),
            "ssd_scan": lambda: ssd_scan(*ssd_in, chunk=4)}


@pytest.mark.parametrize("mode", ["grad", "no_grad", "no_requires_grad",
                                  "integer"])
def test_refuse_grad(mode):
    from repro_torch.kernels._grad import refuse_grad
    x = torch.ones(3, requires_grad=mode != "no_requires_grad")
    if mode == "integer":
        x = torch.ones(3, dtype=torch.int32)
    if mode == "grad":
        with pytest.raises(RuntimeError, match="k: its CUDA kernel has no "
                                               "backward"):
            refuse_grad("k", torch.zeros(2), x)
    elif mode == "no_grad":
        with torch.no_grad():
            refuse_grad("k", x)
    else:
        refuse_grad("k", x)


@pytest.mark.parametrize("name", ["mha", "gqa_decode", "gmm", "ssd_scan"])
def test_cpu_wrappers_still_differentiate(name):
    """On the CPU a wrapper runs its plain version, which autograd
    differentiates: the output carries a grad_fn and backward runs."""
    out = _grad_calls("cpu")[name]()
    assert out.grad_fn is not None
    out.float().square().sum().backward()


@pytest.mark.parametrize("name", ["mha", "gqa_decode", "gmm", "ssd_scan"])
def test_cuda_wrappers_refuse_grad_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the guard sits in the CUDA branch")
    call = _grad_calls("cuda")[name]
    with pytest.raises(RuntimeError, match=f"{name}: its CUDA kernel"):
        call()
    with torch.no_grad():
        assert call().grad_fn is None
