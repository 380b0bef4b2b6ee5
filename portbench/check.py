"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed, a sample of the requests finished in it, drawn
from the seed and always holding the one that served the most tokens, is run
through ``reference.mistral`` over its prompt and served tokens.  For each
served token the gap is the reference's best logit at that position less the
served token's logit: a greedy server that is right serves the reference's
best up to rounding, so the gap stays near zero; a wrong token, a lost
batch row or a stale cache lies far below the best.  The widest gap over the
sample is compared with the configuration's limit.

The control (``gaps(..., control=True)``) is the same reference computed
with float8 weights, in the program's place: the gap of the token it puts
first at each of the same positions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import mistral


@dataclasses.dataclass
class Served:
    rid: int
    prompt: np.ndarray          # [S] int32
    first: int                  # the prefill's greedy token, fed, not emitted
    tokens: np.ndarray          # [T] int32, what the program served
    max_new_tokens: int


def sample(done: Sequence[Served], seed: int, min_tokens: int,
           max_requests: int) -> List[Served]:
    """Requests to compare: the one with the most served tokens, then
    others in an order drawn from ``seed``, until ``min_tokens`` served
    tokens or ``max_requests`` requests."""
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: (len(done[i].tokens), -done[i].rid))
    picked = [longest]
    n = len(done[longest].tokens)
    for i in np.random.default_rng([int(seed), 1]).permutation(len(done)):
        if n >= min_tokens or len(picked) >= max_requests:
            break
        if int(i) != longest:
            picked.append(int(i))
            n += len(done[int(i)].tokens)
    return [done[i] for i in picked]


def gaps(m: Dict[str, object], params: Dict[str, object], req: Served,
         device: torch.device, control: bool = False) -> Dict[str, float]:
    """Widest gap of ``req``'s served tokens (``served``) and, with
    ``control``, of the float8 reference's first choices (``control``)."""
    prompt = torch.as_tensor(req.prompt, device=device).long()
    served = torch.as_tensor(np.concatenate([[req.first], req.tokens]),
                             device=device).long()
    seq = torch.cat([prompt, served[:-1]])
    pos = range(len(prompt) - 1, len(seq))
    ref = mistral.logits_at(m, params, seq, pos)
    best = ref.max(dim=-1).values
    rows = torch.arange(len(served), device=device)
    out = {"served": float((best - ref[rows, served]).max())}
    if control:
        low = mistral.logits_at(m, params, seq, pos, quant="fp8")
        out["control"] = float((best - ref[rows, low.argmax(-1)]).max())
    return out


def compare(m: Dict[str, object], params: Dict[str, object],
            picked: Sequence[Served], device: torch.device,
            control: bool = False) -> Dict[str, object]:
    """The numbers compared over ``picked``: the widest gap, the count of
    requests that served another number of tokens than asked, and the
    count of served tokens outside the vocabulary."""
    widest = {"served": 0.0, "control": 0.0}
    short = sum(len(r.tokens) != r.max_new_tokens for r in picked)
    vocab = int(m["vocab_size"])
    outside = sum(int(((t < 0) | (t >= vocab)).sum()) for t in
                  (np.concatenate([[r.first], r.tokens]) for r in picked))
    for r in picked:
        toks = np.concatenate([[r.first], r.tokens])
        if ((toks < 0) | (toks >= vocab)).any():
            continue
        g = gaps(m, params, r, device, control)
        for k, v in g.items():
            widest[k] = max(widest[k], v)
    out = {"max_logit_gap": widest["served"], "wrong_length": short,
           "token_outside_vocab": outside,
           "compared_tokens": int(sum(len(r.tokens) for r in picked)),
           "compared_requests": len(picked)}
    if control:
        out["control_logit_gap"] = widest["control"]
    return out


def verdict(numbers: Dict[str, object], limit: float,
            finished: int) -> List[tuple]:
    """(name, value, limit, ok) of each number compared."""
    return [
        ("finished_in_window", finished, 1, finished >= 1),
        ("max_logit_gap", numbers["max_logit_gap"], limit,
         numbers["max_logit_gap"] <= limit),
        ("wrong_length", numbers["wrong_length"], 0,
         numbers["wrong_length"] == 0),
        ("token_outside_vocab", numbers["token_outside_vocab"], 0,
         numbers["token_outside_vocab"] == 0),
    ]


def as_control(numbers: Dict[str, object]) -> Dict[str, object]:
    """The numbers of a run with the control in the program's place: its
    widest gap is compared where the program's would be."""
    return dict(numbers, max_logit_gap=numbers["control_logit_gap"])


def line(rows: Sequence[tuple]) -> Dict[str, Dict[str, float]]:
    return {name: {"value": value, "limit": lim}
            for name, value, lim, _ in rows}


def text(rows: Sequence[tuple]) -> str:
    return "\n".join(f"{name} {value} limit {lim} {'ok' if ok else 'FAIL'}"
                     for name, value, lim, ok in rows)


def ok(rows: Sequence[tuple]) -> bool:
    return all(r[3] for r in rows)
