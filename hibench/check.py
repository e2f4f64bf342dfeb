"""How ``correct`` is decided: the served tokens and the gate's decisions
of a sample of the window's requests, held to the plain reference.

For each sampled request the reference runs once over the request's
padded prompt and the tokens the program served, and reads the logits at
every position that produced a served token:

* ``gap_s``: the widest gap by which an S-tier token's logit lies below
  the reference S tier's best logit at that position (logit units);
* ``gap_l``: the same for the L tier's tokens of the escalated requests;
* ``gap_mean``: the mean of those gaps over every checked token of both
  tiers;
* ``conf_err``: the largest difference between the program's mean gate
  confidence (``max_prob``) and the reference's over the same positions;
* ``conf_rms``: the root mean square of those differences over the
  sampled requests, relative to the reference's confidence;
* ``conf_med``: the median over the sampled requests of that relative
  difference's size;
* ``flips``: escalation decisions (``conf < theta``) that differ from the
  reference's where the reference's confidence lies farther from theta
  than the cell's ``flip_margin``.

The cell's ``limits`` name the numbers compared; the others are reported
beside them.

The control (``readings(..., tf32_control=True)``) puts the reference in
the program's place in TF32 and reads, at each of the same positions, the
gap of the token that TF32 ranks first.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from hibench.reference import decoder
from hibench.reference.dims import Dims


def pad_to_bucket(n: int, buckets) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens is longer than every bucket")


def sample(reqs: List[dict], seed: int, spec: dict) -> List[dict]:
    """Requests to check, drawn from ``seed``: the one with the most served
    tokens, at least ``min_escalated`` escalated and ``min_local`` local
    ones, and more until ``min_served_tokens`` tokens are covered."""
    if not reqs:
        return []
    order = list(np.random.default_rng([seed, 0xC4EC]).permutation(len(reqs)))
    longest = max(range(len(reqs)), key=lambda i: len(reqs[i]["tokens"]))
    order.remove(longest)
    picked = [longest]

    def served(i):
        r = reqs[i]
        return len(r["s_tokens"]) + (len(r["tokens"]) if r["offloaded"] else 0)

    for want, n in ((True, spec["min_escalated"]), (False, spec["min_local"])):
        have = sum(bool(reqs[i]["offloaded"]) == want for i in picked)
        for i in [i for i in order if bool(reqs[i]["offloaded"]) == want]:
            if have >= n:
                break
            picked.append(i)
            order.remove(i)
            have += 1
    while order and sum(map(served, picked)) < spec["min_served_tokens"]:
        picked.append(order.pop(0))
    return [reqs[i] for i in picked]


def _sequence(req: dict, tokens: np.ndarray, device) -> torch.Tensor:
    """The padded prompt and every served token but the last."""
    seq = np.zeros(req["bucket"] + len(tokens) - 1, np.int64)
    seq[:len(req["prompt"])] = req["prompt"]
    seq[req["bucket"]:] = tokens[:-1]
    return torch.as_tensor(seq, device=device)


def _gaps(lg: torch.Tensor, tokens: np.ndarray) -> np.ndarray:
    """Per position, the best logit less the served token's."""
    t = torch.as_tensor(np.asarray(tokens, np.int64), device=lg.device)
    return (lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]).cpu().numpy()


def readings(reqs: List[dict], l_params: Dict, s_params: Dict, l_dims: Dims,
             s_dims: Dims, theta: float, flip_margin: float,
             tf32_control: bool = False,
             details: List = None) -> Dict[str, float]:
    """The compared numbers over the sampled requests (see the module
    docstring).  With ``tf32_control`` the TF32 reference stands in for the
    program: its first-ranked token and its confidence at each position
    replace the served ones.  ``details``, where given, receives (request
    id, relative confidence difference) per sampled request."""
    dev = l_params["embed"].device
    out = {"gap_s": 0.0, "gap_l": float("nan"), "conf_err": 0.0,
           "conf_rms": 0.0, "flips": 0}
    rel, gaps = [], []
    for r in reqs:
        tiers = [("s", s_params, s_dims, np.asarray(r["s_tokens"]))]
        if r["offloaded"]:
            tiers.append(("l", l_params, l_dims, np.asarray(r["tokens"])))
        for tier, params, dm, toks in tiers:
            seq = _sequence(r, toks, dev)
            lg = decoder.logits(params, dm, seq, r["bucket"] - 1)
            conf, offloaded = r["confidence"], bool(r["offloaded"])
            if tf32_control:
                lt = decoder.logits(params, dm, seq, r["bucket"] - 1,
                                    tf32=True)
                toks = lt.argmax(-1).cpu().numpy()
                conf = float(torch.softmax(lt, -1).max(-1).values.mean())
                offloaded = conf < theta
                del lt
            key = "gap_" + tier
            g = _gaps(lg, toks)
            gaps.append(g)
            gap = float(g.max())
            out[key] = gap if out[key] != out[key] else max(out[key], gap)
            if tier == "s":
                ref = float(torch.softmax(lg, -1).max(-1).values.mean())
                out["conf_err"] = max(out["conf_err"], abs(ref - conf))
                rel.append((conf - ref) / ref)
                if details is not None:
                    details.append((r["id"], rel[-1]))
                if abs(ref - theta) > flip_margin and \
                        (ref < theta) != offloaded:
                    out["flips"] += 1
            del lg
    if rel:
        out["conf_rms"] = float(np.sqrt(np.mean(np.square(rel))))
        out["conf_med"] = float(np.median(np.abs(rel)))
    out["gap_mean"] = float(np.concatenate(gaps).mean()) if gaps else \
        float("nan")
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number at or under its limit (a missing or NaN
    reading fails)."""
    return all(name in values and values[name] == values[name]
               and values[name] <= lim for name, lim in limits.items())
