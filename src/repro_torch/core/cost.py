"""The paper's 3-term LLM API cost model (Table 1, §2).

c_i(p) = c2 * ||f_i(p)|| + c1 * ||p|| + c0
       = output-token cost + input-token cost + fixed per-request cost.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ApiCost:
    """Prices in USD. input/output rates are per 10M tokens (Table 1)."""

    per_10m_input: float
    per_10m_output: float
    per_request: float = 0.0

    @property
    def c1(self) -> float:          # per input token
        return self.per_10m_input / 1e7

    @property
    def c2(self) -> float:          # per output token
        return self.per_10m_output / 1e7

    @property
    def c0(self) -> float:
        return self.per_request

    def query_cost(self, n_in, n_out) -> np.ndarray:
        """Vectorized: n_in/n_out may be arrays of token counts.

        float32 arithmetic, one rounding per operation in the same order
        as the reference (``repro/core/cost.py``), so the charged cost
        matches it bit for bit.
        """
        f32 = np.float32
        return (f32(self.c2) * np.asarray(n_out, f32)
                + f32(self.c1) * np.asarray(n_in, f32) + f32(self.c0))


# Table 1 — retrieved March 2023 (USD per 10M tokens; per-request fixed fee).
TABLE1: dict[str, ApiCost] = {
    "GPT-C":     ApiCost(2.0, 2.0, 0.0),        # OpenAI GPT-Curie (6.7B)
    "ChatGPT":   ApiCost(2.0, 2.0, 0.0),
    "GPT-3":     ApiCost(20.0, 20.0, 0.0),      # 175B
    "GPT-4":     ApiCost(30.0, 60.0, 0.0),
    "J1-L":      ApiCost(0.0, 30.0, 0.0003),    # AI21 J1-Large (7.5B)
    "J1-G":      ApiCost(0.0, 80.0, 0.0008),    # J1-Grande (17B)
    "J1-J":      ApiCost(0.0, 250.0, 0.005),    # J1-Jumbo (178B)
    "Cohere":    ApiCost(10.0, 10.0, 0.0),      # Xlarge (52B)
    "FF-QA":     ApiCost(5.8, 5.8, 0.0),        # ForeFrontAI QA (16B)
    "GPT-J":     ApiCost(0.2, 5.0, 0.0),        # Textsynth (6B)
    "FAIRSEQ":   ApiCost(0.6, 15.0, 0.0),       # Textsynth (13B)
    "GPT-Neox":  ApiCost(1.4, 35.0, 0.0),       # Textsynth (20B)
}
