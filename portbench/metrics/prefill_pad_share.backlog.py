"""Share (%) of the prefill positions that are left padding: 1 - the real
prompt tokens over the positions (rows times the batch's padded width),
summed over the program's ``generate`` calls done by the window's end
(``RoutedEngine.generate_member``'s counts)."""
from portbench.host_spans import done


def read(ctx):
    calls = done(ctx, "generate")
    positions = sum(s["prefill_positions"] for s in calls)
    if not positions:
        return None
    return 100.0 * (1.0 - sum(s["prefill_tokens"] for s in calls) / positions)
