"""The plain reference's reading of served requests.

For each request, one teacher-forced forward of the reference over its
prompt and its served tokens gives the logits at every position that chose
a served token.  The number compared, ``gap``, is the widest gap between
the logit the program gave a served token and the reference's best logit
at that position: a greedy server serves the best token with the logit the
reference gives it, up to rounding.  A wrong token, or a right one with a
wrong logit, opens it.

A request whose routing holds a near-tie that can reach a served token's
logit (a row whose k-th router logit lies less than ``NEAR_TIE`` above the
next, in the reference: any row of a MoE layer before the last, whose
output feeds the later layers' keys and values, or a row of the last at a
position that chose a served token) is left out of ``gap`` and counted,
with its tokens: rounding may send that row to the other expert on either
side, and from there the request's logits differ by far more than
rounding.
``NEAR_TIE`` is twice the widest gap between the program's router logits
and the reference's that sound runs read on an NVIDIA H100 (1.02e-4 over
every routed row of 135 requests on 15 seeds, ``bench/calibrate.py
--router``): the most a margin can move.

The control reads the same positions with the reference in a lower
precision put in the program's place: ``control_gap``, the same gap of the
token that the lower precision puts first, with the logit it gives it.
With ``witness`` each request set aside is read again by the reference
with its near-ties routed the other way (``flip_gap``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from bench.reference.model import Decoder

NEAR_TIE = 2e-4


def _positions_logits(model: Decoder, prompt, served):
    """Logits (n, V) at the n positions that chose the n served tokens."""
    seq = torch.cat([prompt, served[:-1]])[None]
    logits = model.logits(seq)[0]
    start = prompt.numel() - 1
    return logits[start:start + served.numel()]


def _narrowest(margins, first_served: int) -> float:
    """The narrowest routing margin that can move a served token's logit:
    every row of the MoE layers before the last, and the last layer's rows
    from the first position that chose a served token on."""
    if not margins:
        return float("inf")
    return min([float(m.min()) for m in margins[:-1]]
               + [float(margins[-1][first_served:].min())])


def token_gaps(cfg: dict, weights: Dict,
               requests: Iterable[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]],
               control: str = "", witness: bool = False,
               want: Optional[int] = None, longest: bool = False) -> Dict:
    """``requests``: (prompt (P,) int64, served (n,) int64, the program's
    logits of the served tokens (n,)), on one device, read in their order;
    with ``longest``, by length (prompt and served) first, the longest
    first, until one has been compared (not set aside), and then the rest
    in their order; with ``want``, only until that many have been
    compared.  Also reports the index of each request read, in the order
    read (``read``), of each set aside (``set_aside``), and for each read
    (P, n, its gap, its narrowest routing margin)."""
    requests = list(requests)
    ref = Decoder(cfg, weights, "f32")
    low = Decoder(cfg, weights, control) if control else None
    flip = Decoder(cfg, weights, "f32", flip_below=NEAR_TIE) if witness \
        else None
    out = {"gap": 0.0, "tokens": 0, "compared": 0, "near_ties": 0,
           "near_tie_tokens": 0, "requests": [], "read": [],
           "set_aside": []}
    if low is not None:
        out["control_gap"] = 0.0

    def order():
        by_length = sorted(range(len(requests)), key=lambda i: (
            -requests[i][0].numel() - requests[i][1].numel(), i))
        for i in by_length if longest else ():
            if out["compared"]:
                break
            yield i
        yield from (i for i in range(len(requests)) if i not in out["read"])

    with torch.no_grad():
        for i in order():
            prompt, served, got = requests[i]
            out["read"].append(i)
            best = _positions_logits(ref, prompt, served).max(dim=-1).values
            margin = _narrowest(ref.margins, prompt.numel() - 1)
            gap = float((best - got.float()).abs().max())
            row = [prompt.numel(), served.numel(), gap, margin]
            out["requests"].append(row)
            if margin < NEAR_TIE:
                out["set_aside"].append(i)
                out["near_ties"] += 1
                out["near_tie_tokens"] += served.numel()
                if flip is not None:
                    other = _positions_logits(flip, prompt, served)
                    row.append(float((other.max(dim=-1).values
                                      - got.float()).abs().max()))
                continue
            out["gap"] = max(out["gap"], gap)
            out["tokens"] += served.numel()
            out["compared"] += 1
            if low is not None:
                first = _positions_logits(low, prompt, served).max(dim=-1)
                out["control_gap"] = max(out["control_gap"], float(
                    (best - first.values).abs().max()))
            if out["compared"] == want:
                break
    return out
