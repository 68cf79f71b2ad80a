"""The plain reference against the port at smoke size on the CPU: served
logits (prefill, then decode through the cache) of left-padded batches,
the capacity rule, the routing scores; and the comparison fails a lower
precision."""
import math

import numpy as np
import pytest
import torch

from portbench import checks, serving
from portbench.common import cell_spec
from portbench.members import describe, port_config
from portbench.reference import model as ref_model
from portbench.weights import make_params

MEMBERS = ["qwen3-0.6b", "granite-moe-1b-a400m", "granite-3-8b"]


def _member(name, seed=11):
    from repro_torch.models import lm as lm_mod
    cfg = port_config(name, smoke=True)
    return cfg, describe(cfg), make_params(lm_mod.abstract_params(cfg), seed, "cpu")


def _port_logits(cfg, params, prompts, fed):
    """The port's prefill and decode logits of left-padded ``prompts``
    with the tokens ``fed`` (B, n) fed back: (B, n + 1, vocab)."""
    from repro_torch.models import lm as lm_mod
    from repro_torch.serving.engine import pad_prompts, prompt_pad_mask
    tokens, mask = pad_prompts(prompts, cfg), prompt_pad_mask(prompts, cfg)
    b, s = tokens.shape
    with torch.no_grad():
        caches = lm_mod.init_caches(cfg, b, s + fed.shape[1] + 1, "cpu")
        logits, caches = lm_mod.apply_lm_prefill(cfg, params, tokens, caches, attn_mask=mask)
        out = [logits[:, -1]]
        for i in range(fed.shape[1]):
            logits, caches = lm_mod.apply_lm_decode(cfg, params, fed[:, i:i + 1], caches, s + i)
            out.append(logits[:, -1])
    return torch.stack(out, 1)[..., : cfg.vocab_size]


@pytest.mark.parametrize("name", MEMBERS)
def test_served_logits_agree_with_the_port(name):
    cfg, entry, params = _member(name)
    rng = np.random.default_rng(3)
    # Long enough prompts that the MoE's capacity binds in prefill.
    prompts = [rng.integers(0, entry["vocab_size"], size=n).astype(np.int32) for n in (9, 40)]
    fed = torch.as_tensor(rng.integers(0, entry["vocab_size"], size=(2, 5)))
    port = _port_logits(cfg, params, prompts, fed)
    for row, p in enumerate(prompts):
        seq = torch.as_tensor(np.concatenate([p, fed[row].numpy()]))
        ref = ref_model.served_logits(entry, params, seq, len(p))[len(p) - 1:]
        scale = ref.abs().max()
        assert torch.allclose(port[row], ref, atol=2e-5 * float(scale), rtol=0), name


def test_capacity_rule_is_the_ports():
    from repro_torch.models import moe as moe_mod
    cfg = port_config("granite-moe-1b-a400m")
    entry = describe(cfg)
    for n in (8, 31, 100, 511, 512):
        assert ref_model.capacity(entry, n, n) == moe_mod._capacity(n, cfg)
    # A group of n real tokens in a width of 512 (training's groups).
    f = cfg.capacity_factor * cfg.top_k / cfg.n_experts
    for n in (1, 100, 512):
        want = min(max(cfg.top_k, min(math.ceil(f * n), n)), moe_mod._capacity(512, cfg))
        assert ref_model.capacity(entry, n, 512) == want


def _routing_run(seed=5):
    from portbench.tests.smoke import smoke_cell
    cell = smoke_cell("pool3.steady")
    st = serving.Setup(cell, seed, "cpu", smoke=True)
    texts = ["mmlu history capital treaty simple", "mbpp python loop debug hard",
             "rag passage archive please summarize", "gsm8k fraction modulo expert"]
    s, c = st.wrapped.score_texts(texts)
    st.wrapped.choose(s, c)
    rows = serving.route_sample(st.wrapped, 16, seed)
    return st, rows


def test_routing_scores_agree_with_the_port():
    st, rows = _routing_run()
    gaps = checks.routing_gaps(st.router, rows, "cpu")
    assert gaps["route_s_gap"] < 1e-5 and gaps["route_c_gap"] < 1e-5
    assert gaps["route_choice_misses"] == 0


def test_lower_precision_fails_the_comparison():
    """The control: the reference in bfloat16 in the program's place fails
    one of the cell's numbers, on the tokens and on the routing."""
    limits = cell_spec("pool3.steady")["limits"]
    st, rows = _routing_run()
    route = checks.routing_gaps(st.router, rows, "cpu", control="bf16")
    assert any(route[k] > limits[k] for k in route), (route, limits)
    cfg, entry, params = _member("granite-3-8b")
    rng = np.random.default_rng(9)
    sample = [{"member": 0, "prompt": rng.integers(0, entry["vocab_size"], size=24),
               "output": rng.integers(0, entry["vocab_size"], size=24)} for _ in range(4)]
    ctrl = checks.served_gaps([entry], lambda i: params, sample, "cpu", control="bf16")
    assert any(ctrl[k] > limits[k] for k in ctrl), (ctrl, limits)


def test_training_control_fails_the_comparison():
    """The control of the training cell: the first three steps computed in
    bfloat16 in the program's place fail one of the cell's numbers; the
    reference against itself reads 0."""
    from portbench import training
    from portbench.tests.smoke import smoke_cell
    cell = smoke_cell("granite-moe-1b-a400m.train")
    st = training.Setup(cell, 21, 1.0, "cpu", smoke=True)
    args = (st.entry, st.shapes, 21, st.batches[:3], st.adam, "cpu")
    ref = training.reference_steps(*args)
    assert all(v == 0.0 for v in checks.training_gaps(ref, ref).values())
    ctrl = checks.training_gaps(training.reference_steps(*args, prec="bf16"), ref)
    limits = cell["limits"]
    assert any(ctrl[k] > limits[k] for k in limits), (ctrl, limits)
