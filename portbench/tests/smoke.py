"""Cells cut to a size the CPU runs in seconds, for the tests: the port's
smoke configs (the cell's own router file), small batches and short
prompts. Only the sizes change; the code path is the cell's."""
from __future__ import annotations

import copy

from portbench.common import cell_spec


def smoke_cell(name: str) -> dict:
    cell = copy.deepcopy(cell_spec(name))
    mix = cell["traffic"]
    if cell["kind"] == "serving":
        cell.update(trace_slice_s=1.0)
        cell["scheduler"].update(score_batch=8, max_batch=4, max_wait_s=0.02)
        cell["check"].update(per_member=2, route_sample=16)
        mix.update(corpus=64, records=64, outstanding=12)
        mix["prompt_len"].update(min=4, max=24)
        mix["max_new"].update(short=2, other=4)
        mix["rate_per_s"] = 12.0
        # Seeded weights from the smoke configs route every request to the
        # same member at the cell's lambda; any lambda serves the tests.
    else:
        mix.update(batch=2, seq_len=64, min_len=16, min_step_s=0.05)
    return cell
