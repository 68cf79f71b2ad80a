"""Host milliseconds of the featurizer per request: the program's
``featurize`` spans (``embed_texts`` inside the engine's ``embed`` and
``score_texts``) done by the window's end, over the texts they embedded."""
from portbench.host_spans import done


def read(ctx):
    spans = done(ctx, "featurize")
    n = sum(s["n"] for s in spans)
    return 1e3 * sum(s["t1"] - s["t0"] for s in spans) / n if n else None
