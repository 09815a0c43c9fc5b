"""Whether what the timed path served is right.

A sample of the window's finished requests, drawn from the seed with the
one that served the most tokens always in it, until it holds at least
``check_requests`` requests and ``check_tokens`` served tokens.  The plain reference runs once over each
prompt and its served tokens (all but the last as input), and each served
token is judged by how far its reference logit lies below the
reference's best at its position; the widest such gap is compared with
the cell's limit.  The control (``precision="fp8"``) is judged the same
way by the token it puts first at each of those positions.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def sample(finished: Sequence[Tuple[np.ndarray, List[int]]], seed: int,
           tokens: int, requests: int) -> List[Tuple[np.ndarray, List[int]]]:
    """``finished``: (prompt, generated) pairs in the order they were
    sent."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: len(finished[i][1]))
    rest = [i for i in np.random.default_rng(int(seed)).permutation(
        len(finished)) if i != longest]
    out, n = [finished[longest]], len(finished[longest][1])
    for i in rest:
        if n >= tokens and len(out) >= requests:
            break
        out.append(finished[i])
        n += len(finished[i][1])
    return out


def _seqs(picked, device):
    import torch
    seqs, served = [], []
    for prompt, gen in picked:
        full = np.concatenate([prompt, np.asarray(gen[:-1], np.int64)])
        seqs.append((torch.as_tensor(full, device=device), len(prompt) - 1))
        served.append(torch.as_tensor(np.asarray(gen, np.int64),
                                      device=device))
    return seqs, served


def widest_gap(ref, weights, model: dict, picked, device,
               control: bool = False) -> float:
    """The widest gap over the sample: of the served tokens, or with
    ``control`` of the tokens the fp8 reference puts first."""
    import torch
    seqs, served = _seqs(picked, device)
    want = ref.logits(weights, model, seqs, "float32")
    if control:
        low = ref.logits(weights, model, seqs, "fp8")
        served = [lo.argmax(-1) for lo in low]
    gaps = [ref.served_gap(w, s) for w, s in zip(want, served)]
    return float(torch.cat(gaps).max())
