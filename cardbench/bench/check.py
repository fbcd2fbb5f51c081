"""What decides ``correct``: the served tokens held to the plain reference.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed and always holding the longest,
is run through the reference (``cardbench/reference/``) once each, over
the prompt and the served tokens.  At every served position the gap is
the reference's best logit minus its logit of the token served there; the
number compared is the widest gap over the sample.  Greedy serving at the
configuration's precision serves a token within rounding of the best;
a token altered, computed over a wrong context, or in a lower precision
lies further below it.

The other numbers compared: every offered request finished, with exactly
its budget of tokens.
"""
from __future__ import annotations

import importlib.util
from typing import Dict, List

import numpy as np
import torch

from bench.cells import HERE


def reference(conf: dict):
    """The configuration's plain reference module."""
    path = HERE / "reference" / f"{conf['reference']}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_reference_{conf['reference']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample(run, n: int) -> List[int]:
    """``n`` finished requests drawn from the seed, the longest first."""
    done = sorted(run.completions)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(run.completions[r].tokens), -r))
    rest = [r for r in done if r != longest]
    rng = np.random.default_rng([int(run.seed), 0xC4EC])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def _sequence(run, rid: int, device):
    a = run.arrivals[rid]
    served = np.asarray(run.completions[rid].tokens, np.int64)
    toks = np.concatenate([a.prompt.astype(np.int64), served[:-1]])
    return (torch.as_tensor(toks, device=device),
            torch.as_tensor(served, device=device), len(a.prompt) - 1)


def gaps(run, rids: List[int], device, control: bool = False) -> List[float]:
    """Per sampled request, the widest gap of the served tokens (or, with
    ``control``, of the tokens the fp8 reference puts first at the same
    positions) below the reference's best logit."""
    ref = reference(run.cell.conf)
    out = []
    for rid in rids:
        toks, served, first = _sequence(run, rid, device)
        lg = ref.logits(run.cell.conf, run.params, toks, first)
        if control:
            low = ref.logits(run.cell.conf, run.params, toks, first,
                             precision="fp8")
            served = low.argmax(-1)
            del low
        best = lg.max(-1).values
        out.append(float((best - lg.gather(1, served[:, None])[:, 0]).max()))
        del lg
    return out


def checks(run, device, log=print) -> Dict[str, Dict[str, float]]:
    """Every number compared, with its limit: ``finished`` has to reach
    its limit, ``logit_gap`` must not pass its own."""
    mix = run.cell.mix
    n = len(run.arrivals)
    finished = sum(1 for a in run.arrivals
                   if a.rid in run.completions
                   and len(run.completions[a.rid].tokens) == a.max_new_tokens)
    rids = sample(run, int(mix["check"]["requests"]))
    per = gaps(run, rids, device)
    log(f"check: requests {rids}, "
        f"{sum(len(run.completions[r].tokens) for r in rids)} served tokens "
        f"compared, widest gap each {per}")
    return {"finished": {"value": finished, "limit": n},
            "logit_gap": {"value": max(per, default=float("inf")),
                          "limit": float(mix["check"]["logit_gap"])}}


def passed(result: Dict[str, Dict[str, float]]) -> bool:
    return (result["finished"]["value"] == result["finished"]["limit"]
            and result["logit_gap"]["value"] <= result["logit_gap"]["limit"])
