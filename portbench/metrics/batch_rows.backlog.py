"""Mean requests per ``generate_member`` call (the engine wrapper's spans)
completed in the window."""


def read(ctx):
    n = [s["n"] for s in ctx["spans"]
         if s["name"] == "generate_member" and s["t1"] <= ctx["window_end_s"]]
    return sum(n) / len(n) if n else None
