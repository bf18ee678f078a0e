"""BCEdge utility objective (paper Eqs. 1, 3, 4); a copy of the
reference's ``repro.core.utility`` (numpy only).

Eq. 1: the i-th scheduling time slot is the batch SLO budget divided by the
number of concurrent instances::

    t_i = (Σ_{j=1..b} SLO_j) / m_c

Eq. 3: the throughput/latency trade-off utility::

    U = log( T(b, m_c) / ( L(b, m_c) / t_i ) )

L / t_i ∈ (0, 1] when the batch meets its slot budget, so U rewards high
throughput and penalises latency *relative to the SLO budget*. (Eq. 4
writes "min U" but the text, reward definition r_t = U and all
experiments maximise it; it is maximised here too.)
"""
from __future__ import annotations

import numpy as np


def scheduling_slot(slo_sum_s: float, m_c: int) -> float:
    """Eq. 1. ``slo_sum_s`` = Σ SLO over the batch, in seconds."""
    return slo_sum_s / max(m_c, 1)


def utility(throughput_rps: float, latency_s: float, slo_sum_s: float,
            m_c: int, eps: float = 1e-6) -> float:
    """Eq. 3. Higher is better."""
    slot = scheduling_slot(slo_sum_s, m_c)
    norm_latency = latency_s / max(slot, eps)
    return float(np.log(max(throughput_rps, eps) / max(norm_latency, eps)))


def normalized_utility(u: float, u_max: float) -> float:
    return u / u_max if u_max > 0 else 0.0
