"""What decides ``correct`` for a served model.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed and holding the longest, runs
through the configuration's float32 reference: one pass over each prompt
followed by its served tokens.  At each position that produced a served
token, the gap is how far the reference's logit of that token lies below
the reference's best, in units of the standard deviation of the
reference's logits there (so it reads alike at every width and
vocabulary).  The numbers compared are the statistics of those gaps that the cell's
``limits/<cell>.json`` names (``STATISTICS``): the widest gap by default,
the mean gap where routing near-ties make the widest swing (PERF.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gpu_bench.bench.traffic import rng_for

__all__ = ["Served", "sample", "gaps", "Check", "STATISTICS"]

_STREAM_SAMPLE = 4
# a limit file's key -> the statistic of the sample's normalised gaps it limits
STATISTICS = {"logit_gap": np.max, "logit_gap_mean": np.mean}


@dataclass(frozen=True)
class Served:
    """A finished request as the benchmark saw it."""

    prompt: np.ndarray        # token ids
    tokens: tuple             # served tokens, the first from the prefill


@dataclass(frozen=True)
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def sample(served: list[Served], n: int, seed: int) -> list[Served]:
    """``n`` of ``served`` drawn from the seed, always with the longest
    (prompt and output together)."""
    if len(served) <= n:
        return list(served)
    longest = max(range(len(served)), key=lambda i: len(served[i].prompt) + len(served[i].tokens))
    rest = [i for i in range(len(served)) if i != longest]
    pick = rng_for(seed, _STREAM_SAMPLE).choice(len(rest), size=n - 1, replace=False)
    return [served[longest], *(served[rest[i]] for i in sorted(pick))]


def gaps(reference, model: dict, redraw, chosen: list[Served], device, *,
         control: bool = False) -> dict[str, np.ndarray]:
    """The normalised gap at every served token of ``chosen`` (``program``),
    the reference's least routing margin there (``margin``) and, with
    ``control``, the gap of the token the float8 control puts first there
    (``control``)."""
    seqs, reads = [], []
    for r in chosen:
        toks = np.asarray(r.tokens, np.int64)
        seqs.append(torch.from_numpy(np.concatenate([r.prompt, toks[:-1]])).to(device))
        reads.append(torch.from_numpy(toks).to(device))
    rows = reference.score(model, redraw, seqs, reads, control=control)
    out = {"program": np.concatenate([((r["best"] - r["read"]) / r["std"]).cpu().numpy()
                                      for r in rows]),
           "margin": np.concatenate([r["margin"].cpu().numpy() for r in rows])}
    if control:
        out["control"] = np.concatenate([(r["control_gap"] / r["std"]).cpu().numpy()
                                         for r in rows])
    return out
