"""Requests and synthetic workloads — the port's own copy of
``repro.serving.workload`` (paper §7.1): IO sequences under fixed,
variable (ramp) and patterned (burst, diurnal) request-rate profiles.
Prompt lengths may be fixed, sampled from a range, or drawn from a custom
sampler.  A seed gives the reference's requests: arrivals, lengths and
prompt tokens come from the same ``numpy`` generator calls in the same
order."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

# fixed length | inclusive (lo, hi) range | rng -> length sampler
PromptLen = Union[int, tuple, Callable[[np.random.Generator], int]]


def _prompt_sampler(prompt_len: PromptLen) -> Callable[
        [np.random.Generator], int]:
    if callable(prompt_len):
        return prompt_len
    if isinstance(prompt_len, tuple):
        lo, hi = prompt_len
        return lambda rng: int(rng.integers(lo, hi + 1))
    return lambda rng: int(prompt_len)


@dataclasses.dataclass
class Request:
    rid: int
    arrival_s: float
    prompt_len: int
    output_len: int
    prompt: Optional[np.ndarray] = None      # token ids (engine runs)
    priority: int = 0                        # paged KV: preemption order

    # filled by the engine
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    token_times: Optional[List[float]] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot(self) -> Optional[float]:
        if self.finish_s is None or self.first_token_s is None \
                or self.output_len <= 1:
            return None
        return (self.finish_s - self.first_token_s) / (self.output_len - 1)


def make_workload(*, duration_s: float, rps_fn: Callable[[float], float],
                  prompt_len: PromptLen = 2000, output_range=(500, 750),
                  seed: int = 0, vocab_size: int = 0,
                  dt: float = 0.05) -> List[Request]:
    """Poisson arrivals with the time-varying rate ``rps_fn(t)``, drawn
    every ``dt`` seconds.  ``prompt_len`` is a fixed int, an inclusive
    ``(lo, hi)`` range or a ``rng -> int`` sampler; ``vocab_size`` > 0
    draws the prompt tokens too."""
    rng = np.random.default_rng(seed)
    sample_prompt = _prompt_sampler(prompt_len)
    reqs: List[Request] = []
    t, rid = 0.0, 0
    while t < duration_s:
        lam = max(rps_fn(t), 0.0) * dt
        n = rng.poisson(lam)
        for _ in range(n):
            out = int(rng.integers(output_range[0], output_range[1] + 1))
            S = sample_prompt(rng)
            prompt = (rng.integers(0, vocab_size, S)
                      if vocab_size else None)
            reqs.append(Request(rid, t + rng.uniform(0, dt), S, out,
                                prompt=prompt))
            rid += 1
        t += dt
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


def shared_prefix_workload(schedule, *, prefix_len: int,
                           suffix_range=(4, 16), num_prefixes: int = 1,
                           output_range=(10, 24), vocab_size: int = 256,
                           seed: int = 0, rid0: int = 0) -> List[Request]:
    """Prompts that share long common prefixes (the paged pool's
    copy-on-write path).  ``schedule`` is ``[(t_arrival, n_requests),
    ...]``; request ``rid`` joins group ``rid % num_prefixes``, whose
    prompts are one fixed prefix plus the first ``k`` tokens of one fixed
    continuation (``k`` drawn from ``suffix_range``), so a group's prompts
    are prefixes of each other."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab_size, prefix_len)
                for _ in range(num_prefixes)]
    streams = [rng.integers(0, vocab_size, suffix_range[1])
               for _ in range(num_prefixes)]
    reqs: List[Request] = []
    rid = rid0
    for t_arr, n in schedule:
        for _ in range(n):
            g = rid % num_prefixes
            k = int(rng.integers(suffix_range[0], suffix_range[1] + 1))
            prompt = np.concatenate([prefixes[g],
                                     streams[g][:k]]).astype(np.int64)
            out = int(rng.integers(output_range[0], output_range[1] + 1))
            reqs.append(Request(rid, float(t_arr), len(prompt), out,
                                prompt=prompt))
            rid += 1
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


def merge_arrivals(pending: List[Request], consumed: int,
                   new: List[Request]) -> List[Request]:
    """Merge ``new`` requests into the undelivered tail of ``pending``
    (``consumed`` = index of the first undelivered request), in arrival
    order; the caller resets its cursor to 0 (``ClusterDriver.run``)."""
    return sorted(pending[consumed:] + list(new), key=lambda r: r.arrival_s)


def scripted_burst(schedule, *, prompt_len: int = 16,
                   output_range=(10, 24), vocab_size: int = 256,
                   seed: int = 0, rid0: int = 0) -> List[Request]:
    """Requests from an explicit arrival schedule ``[(t_arrival,
    n_requests), ...]``: random prompt tokens and an output length from
    ``output_range`` each (the calm -> burst -> calm shapes of the
    closed-loop tests)."""
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    rid = rid0
    for t_arr, n in schedule:
        for _ in range(n):
            out = int(rng.integers(output_range[0], output_range[1] + 1))
            reqs.append(Request(rid, float(t_arr), prompt_len, out,
                                prompt=rng.integers(0, vocab_size,
                                                    prompt_len)))
            rid += 1
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


# rate profiles
def fixed_rate(rps: float):
    return lambda t: rps


def ramp(rps0: float, rps1: float, duration: float):
    return lambda t: rps0 + (rps1 - rps0) * min(t / duration, 1.0)


def step_up(rps0: float, rps1: float, at: float):
    return lambda t: rps0 if t < at else rps1


def burst(base: float, peak: float, start: float, width: float):
    return lambda t: peak if start <= t < start + width else base


def diurnal(base: float, peak: float, period_s: float,
            phase_frac: float = 0.0):
    """Sinusoidal demand: ``base`` rps at the trough, ``peak`` at the
    crest, one cycle per ``period_s``; ``phase_frac`` shifts the cycle by
    a fraction of a period (0: trough at t = 0, crest at ``period_s/2``)."""
    amp = (peak - base) * 0.5
    return lambda t: base + amp * (1.0 - np.cos(
        2.0 * np.pi * (t / period_s + phase_frac)))


def diurnal_crest(period_s: float, phase_frac: float = 0.0) -> float:
    """Time of the first crest of ``diurnal(..., phase_frac)`` in [0, T)."""
    return ((0.5 - phase_frac) % 1.0) * period_s


def fleet_workload(model_names: Sequence[str], *, duration_s: float,
                   base_rps: float, peak_rps: float, period_s: float,
                   burst_rps: float = 0.0, burst_width_s: float = 0.0,
                   prompt_len: PromptLen = 2000, output_range=(500, 750),
                   seed: int = 0, dt: float = 0.05
                   ) -> Dict[str, List[Request]]:
    """One arrival stream per model: model ``i`` of N rides ``diurnal(
    base_rps, peak_rps, period_s, phase_frac=i/N)`` (staggered peaks),
    plus a burst of ``burst_rps`` for ``burst_width_s`` seconds at its own
    crest when both are set; model ``i`` draws from seed ``seed + i``."""
    out: Dict[str, List[Request]] = {}
    n = max(len(model_names), 1)
    for i, name in enumerate(model_names):
        phase = i / n
        rate = diurnal(base_rps, peak_rps, period_s, phase_frac=phase)
        if burst_rps and burst_width_s:
            spike = burst(0.0, burst_rps,
                          diurnal_crest(period_s, phase), burst_width_s)
            rate = (lambda t, f=rate, b=spike: f(t) + b(t))
        out[name] = make_workload(duration_s=duration_s, rps_fn=rate,
                                  prompt_len=prompt_len,
                                  output_range=output_range,
                                  seed=seed + i, dt=dt)
    return out
