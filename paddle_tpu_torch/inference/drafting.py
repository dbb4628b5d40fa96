"""Per-scenario speculative drafters for the serving engine.

reference: paddle_tpu/inference/drafting.py — `_lookup` (:68),
`backoff_drafter` (:91), `suffix_drafter` (:115), `scenario_drafter`
(:170), `scenario_draft_depth` (:185) and `SCENARIO_DRAFT_STATS`.

The engine's built-in drafter (serving._ngram_draft) is one flat
prompt-lookup: a single n-gram length for every workload. This module
feeds a scenario label into the engine's pluggable ``drafter=`` hook: each
scenario maps to an ordered n-gram BACKOFF ladder (longest first; lanes
that fail a longer lookup retry the shorter one before the repeat-token
fallback), or to the longest-suffix lookup.

Every drafter here is ``fn(hist, lens, toks, depth) -> [B, depth]`` int64
over the device-resident history buffer `hist` ([B, hmax]: each lane's
prompt and committed tokens, the step token at hist[b, lens[b]]). The
reference's per-lane `vmap` becomes batched index arithmetic: gathers
along the history axis for every lane at once, with no Python loop over
lanes and no host synchronisation, so the drafters run inside the
engine's captured CUDA graphs. The committed stream does not depend on
the drafter: only how many drafts survive verification does.
"""

from __future__ import annotations

import torch

__all__ = ["SCENARIO_DRAFT_STATS", "backoff_drafter", "suffix_drafter",
           "scenario_drafter", "scenario_draft_depth"]

# scenario label -> n-gram statistics for the drafter: "ngrams" is the
# backoff ladder (tried longest first per lane), "suffix" selects the
# longest-suffix drafter with its (max_suffix, min_match), and "depth" is
# the draft depth a harness configures the engine with. The reference
# measured these on its own harness model (reference drafting.py:43-60).
SCENARIO_DRAFT_STATS = {
    "chat": {"ngrams": (3, 2), "depth": 2},
    "long_document": {"ngrams": (2,), "depth": 2},
    "offline_batch": {"ngrams": (3, 2), "depth": 2},
    "structured_output": {"ngrams": (2,), "depth": 2},
    "shared_prefix": {"suffix": (3, 2), "depth": 2},
}

# scenarios without a row fall back to this ladder
_DEFAULT_STATS = {"ngrams": (3, 2), "depth": 2}


def _shifted(hist, back):
    """hist[b, clip(c - back, 0, hmax - 1)] for every candidate c: the
    history shifted right by `back`, its first entries repeating
    hist[:, 0] as the reference's clipped index does."""
    if back == 0:
        return hist
    return torch.cat([hist[:, :1].expand(-1, back), hist[:, :-back]],
                     dim=1)


def _at(hist, idx):
    """hist[b, clip(idx[b, ...], 0, hmax - 1)] per lane."""
    return torch.gather(hist, 1, idx.clamp(0, hist.shape[1] - 1))


def _continuation(hist, j, depth, toks, found):
    """The `depth` tokens after candidate j[b] where `found`, else the step
    token repeated."""
    steps = torch.arange(depth, device=hist.device)[None, :]
    cont = _at(hist, j[:, None] + 1 + steps)
    return torch.where(found[:, None], cont, toks[:, None].expand_as(cont))


def _lookup(hist, lens, toks, depth, ngram):
    """One prompt-lookup rung: the `depth` tokens that followed the most
    recent earlier occurrence of the trailing `ngram`-token suffix, and the
    per-lane matched mask (for a backoff ladder). Candidates must leave the
    whole continuation in the past (cand + depth < n): positions >= n hold
    the previous step's rejected-draft leftovers."""
    hist = hist.long()
    lens = lens.long()
    hmax = hist.shape[1]
    cand = torch.arange(hmax, device=hist.device)[None, :]
    n = lens[:, None]
    ok = (cand >= ngram - 1) & (cand + depth < n)
    for back in range(ngram):
        ok = ok & (_shifted(hist, back) == _at(hist, n - back))
    j = torch.where(ok, cand, -1).amax(dim=1)
    found = j >= 0
    return _continuation(hist, j, depth, toks.long(), found), found


def backoff_drafter(ngrams):
    """A drafter that tries each n-gram length in order and keeps, per
    lane, the first rung that matched (unmatched lanes end at the
    repeat-step-token fallback the last rung produces)."""
    ladder = tuple(int(n) for n in ngrams)
    if not ladder or any(n < 1 for n in ladder):
        raise ValueError(f"n-gram ladder must be ints >= 1, got {ngrams!r}")

    def drafter(hist, lens, toks, depth):
        out = have = None
        for n in ladder:
            drafts, matched = _lookup(hist, lens, toks, depth, n)
            if out is None:
                out, have = drafts, matched
            else:
                out = torch.where(have[:, None], out, drafts)
                have = have | matched
        return out

    drafter.label = "backoff:" + ",".join(str(n) for n in ladder)
    return drafter


def suffix_drafter(max_suffix=3, min_match=2):
    """A suffix-automaton-style lookup: each lane finds the earlier
    position whose context shares the LONGEST suffix (up to `max_suffix`
    tokens, at least `min_match`) with the current one and proposes the
    tokens that followed it; ties prefer the most recent occurrence. The
    reference measured max_suffix 3 as its best cap (reference :124-131)."""
    M = int(max_suffix)
    lo = int(min_match)
    if not (1 <= lo <= M):
        raise ValueError(
            f"need 1 <= min_match <= max_suffix, got ({max_suffix!r}, "
            f"{min_match!r})")

    def drafter(hist, lens, toks, depth):
        hist = hist.long()
        lens = lens.long()
        hmax = hist.shape[1]
        cand = torch.arange(hmax, device=hist.device)[None, :]
        n = lens[:, None]
        ok = cand + depth < n
        run = ok
        length = torch.zeros_like(hist)
        for back in range(M):
            run = (run & (cand - back >= 0)
                   & (_shifted(hist, back) == _at(hist, n - back)))
            length = length + run.long()
        valid = ok & (length >= lo)
        # maximize (match length, recency): length majorizes, the
        # candidate index breaks ties toward the latest occurrence
        score = torch.where(valid, length * hmax + cand, -1)
        best, j = score.max(dim=1)
        # argmax of an all -1 row is 0 in the reference; any j reads the
        # same fallback when nothing matched
        return _continuation(hist, j, depth, toks.long(), best >= 0)

    drafter.label = f"suffix:{M},{lo}"
    return drafter


def scenario_drafter(scenario):
    """The drafter for a scenario label (a Scenario object or its name;
    unknown labels get the default ladder). The callable carries a
    ``label`` attribute naming it."""
    name = getattr(scenario, "name", scenario)
    stats = SCENARIO_DRAFT_STATS.get(str(name), _DEFAULT_STATS)
    if "suffix" in stats:
        fn = suffix_drafter(*stats["suffix"])
    else:
        fn = backoff_drafter(stats["ngrams"])
    fn.label = f"scenario:{name}:" + fn.label
    return fn


def scenario_draft_depth(scenario) -> int:
    """The draft depth for a scenario label."""
    name = getattr(scenario, "name", scenario)
    return int(SCENARIO_DRAFT_STATS.get(str(name), _DEFAULT_STATS)["depth"])
