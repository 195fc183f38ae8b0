"""Neural LLM marketplace: encoder classifiers of different capacity as
the "APIs" (``repro/core/neural_market.py``).

Training the tiers (``train_marketplace``) is a later slice. Until then
a marketplace comes from converted reference params or from
``init_marketplace``'s seeded weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cost import TABLE1, ApiCost
from repro_torch.data import synthetic
from repro_torch.models.classifier import (classifier_logits, encoder_config,
                                           init_classifier)

# tier name -> (encoder size, train steps, Table-1 price analogue)
TIERS = {
    "GPT-J":   dict(n_layers=1, d_model=32, steps=60, price="GPT-J"),
    "J1-L":    dict(n_layers=2, d_model=48, steps=120, price="J1-L"),
    "GPT-C":   dict(n_layers=2, d_model=64, steps=200, price="GPT-C"),
    "ChatGPT": dict(n_layers=3, d_model=96, steps=320, price="ChatGPT"),
    "GPT-3":   dict(n_layers=4, d_model=128, steps=480, price="GPT-3"),
    "GPT-4":   dict(n_layers=4, d_model=160, steps=800, price="GPT-4"),
}


@dataclasses.dataclass
class NeuralAPI:
    name: str
    cfg: object
    params: dict
    price: ApiCost

    def answer(self, tokens: np.ndarray, batch: int = 512) -> np.ndarray:
        """Argmax class per query (int32), in chunks of ``batch``."""
        out = [classifier_logits(self.params, tokens[i:i + batch], self.cfg)
               .argmax(-1).int().cpu().numpy()
               for i in range(0, tokens.shape[0], batch)]
        return np.concatenate(out)

    def query_cost(self, tokens: np.ndarray) -> np.ndarray:
        n_in = (tokens != synthetic.PAD).sum(-1)
        return np.asarray(self.price.query_cost(n_in, np.ones_like(n_in)))


def tier_subset(names) -> dict:
    """A copy of TIERS restricted to ``names`` (order preserved)."""
    out = {}
    for name in names:
        if name not in TIERS:
            raise KeyError(f"unknown tier {name!r}; available: "
                           f"{list(TIERS)}")
        out[name] = dict(TIERS[name])
    return out


def tier_config(name: str, seq_len: int = 64):
    """The encoder config of tier ``name``, as ``train_marketplace``
    builds it in the reference."""
    spec = TIERS[name]
    return encoder_config(f"api-{name}", n_layers=spec["n_layers"],
                          d_model=spec["d_model"],
                          n_heads=max(2, spec["d_model"] // 32),
                          d_ff=2 * spec["d_model"], max_seq=seq_len + 4)


def init_marketplace(task: str, *, tiers: dict | None = None,
                     seq_len: int = 64, seed: int = 0,
                     device="cuda") -> list[NeuralAPI]:
    """Untrained tiers with seeded weights (tier i from ``seed + i``),
    the stand-in for ``train_marketplace`` until training is ported."""
    n_classes = synthetic.N_CLASSES[task]
    apis = []
    for i, (name, spec) in enumerate((tiers or TIERS).items()):
        cfg = tier_config(name, seq_len)
        params = init_classifier(cfg, n_classes, seed=seed + i, device=device)
        apis.append(NeuralAPI(name, cfg, params, TABLE1[spec["price"]]))
    return apis
