"""Host milliseconds of routing per request: the engine wrapper's
``embed``, ``score_emb``, ``score_texts`` (featurizer, router_xattn, the
cost head) and ``choose`` (R2) spans, over the requests scored."""

ROUTING = ("embed", "score_emb", "score_texts", "choose")


def read(ctx):
    spans = [s for s in ctx["spans"] if s["name"] in ROUTING]
    n = sum(s["n"] for s in spans if s["name"] in ("score_emb", "score_texts"))
    if not n:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in spans) / n
