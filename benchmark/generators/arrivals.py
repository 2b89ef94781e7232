"""The general traffic generator of serving mixes: a mix's data file -> the
requests of one run.

Prompt and output lengths are the quantiles (i + 0.5) / n of their clipped
log-normal laws, and the gaps between arrivals the same quantiles of the
exponential law of a Poisson process at the mix's rate, scaled to fill the
window. Their order is drawn once, from the mix's `schedule_seed`, so that
every run offers the same lengths at the same due times: a tail over one
window's requests then repeats from run to run. The run's seed draws the
token ids alone.

A mix names its generator by `generator` (this module's name by default);
a mix whose traffic needs new code adds a module of its own beside this
one, with the same requests() signature.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()


def _quantiles(n: int) -> list:
    return [(i + 0.5) / n for i in range(n)]


def lognormal_lengths(law: dict, n: int) -> list:
    """n lengths at the quantiles of a log-normal with the law's median
    and sigma, rounded and clipped to [min, max]."""
    return [int(min(max(round(law["median"] * math.exp(
        law["sigma"] * _NORMAL.inv_cdf(u))), law["min"]), law["max"]))
        for u in _quantiles(n)]


def exponential_gaps(n: int) -> list:
    """n gaps of unit mean at the quantiles of the exponential law."""
    return [-math.log(1.0 - u) for u in _quantiles(n)]


def requests(mix: dict, seed: int, seconds: float, vocab: int,
             rate: float = 0.0) -> list:
    """[{"due": s, "prompt": [ids], "max_new": n}] sorted by due, for a
    window of `seconds` at the mix's rate (or `rate`)."""
    rate = rate or mix["rate_per_s"]
    n = max(1, round(rate * seconds))
    order = np.random.default_rng(mix["schedule_seed"])
    prompts = order.permutation(lognormal_lengths(mix["prompt"], n))
    outputs = order.permutation(lognormal_lengths(mix["output"], n))
    gaps = order.permutation(exponential_gaps(n))
    # arrivals in [0, seconds): the first at 0, the window holding them all
    dues = (np.cumsum(gaps) - gaps[0]) * seconds / float(sum(gaps))
    ids = np.random.default_rng(seed)
    return [{"due": float(due),
             "prompt": ids.integers(0, vocab, int(p)).tolist(),
             "max_new": int(o)}
            for due, p, o in zip(dues, prompts, outputs)]
