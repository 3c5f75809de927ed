"""Self-speculative drafting: prompt-lookup (n-gram) draft proposal.

No second model: the drafter proposes a continuation by finding an
earlier occurrence of the sequence's own trailing n-gram and continuing
the pattern that followed it.  That is the prompt-lookup decoding trick
(and the self-drafting half of lookahead decoding): generation that
copies or paraphrases its context - retrieval answers, code completion,
structured output, or simply a model that has settled into a repeating
pattern - is predicted perfectly, while history with no repetition
simply yields no draft (and the request decodes normally that tick).

Pure host-side policy: tiny integer scans over token lists the host
already owns, no device work.  The engine verifies whatever is proposed
through the batched chunk kernel (serve/serve_step.py
make_spec_verify_step); a bad draft costs only its share of the tick's
token budget, never correctness - acceptance compares every draft token
against the token the target model itself samples at that position
(serve/sampling.py speculative_accept).
"""
from __future__ import annotations

from typing import List, Sequence


def ngram_draft(history: Sequence[int], max_draft: int,
                max_ngram: int) -> List[int]:
    """Propose up to `max_draft` tokens continuing `history` by suffix-
    shift prediction: for n = max_ngram down to 1, find the MOST RECENT
    earlier occurrence of the trailing n-gram; its distance p from the
    suffix is the local period, and the draft continues the pattern
    cyclically - token[t] = token[t - p] - for the full max_draft.
    Longer n-grams are preferred (a longer match is stronger evidence the
    pattern will continue) and the most recent occurrence wins (smallest
    shift = the freshest local pattern), so a sequence that has settled
    into a constant run or a period-p cycle is predicted perfectly for
    the whole draft, not just to the end of recorded history.  The match
    window may overlap the suffix itself (p < n is fine - that IS a
    short-period cycle).  Returns [] when history never repeats (the
    caller decodes that request normally this tick)."""
    h = list(history)
    L = len(h)
    if max_draft <= 0 or L < 2:
        return []
    for n in range(min(max_ngram, L - 1), 0, -1):
        suffix = h[L - n:]
        for i in range(L - n - 1, -1, -1):
            if h[i:i + n] == suffix:
                p = L - n - i
                out: List[int] = []
                for j in range(max_draft):
                    t = L + j - p
                    out.append(h[t] if t < L else out[t - L])
                return out
    return []
