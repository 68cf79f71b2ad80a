"""The configuration file's models against the port's configs: set-up
refuses to run when a width the file states differs from what
``repro_torch.configs.get_config`` builds."""
from __future__ import annotations

from typing import Dict

# Keys of a member entry that the port's ArchConfig carries, under the
# same names, and that the reference reads.
ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
             "vocab_size", "qk_norm", "rope_theta", "norm_eps", "n_experts", "top_k",
             "d_ff_expert", "capacity_factor", "router_aux_coef")


def describe(cfg) -> Dict:
    """The member entry of a port config (widths resolved as it resolves
    them)."""
    out = {k: getattr(cfg, k) for k in ARCH_KEYS}
    out["head_dim"] = cfg.resolved_head_dim
    if cfg.n_experts:
        out["d_ff_expert"] = cfg.resolved_d_ff_expert
    return out


def port_config(name: str, smoke: bool = False):
    from repro_torch.configs import get_config, get_smoke_config
    return get_smoke_config(name) if smoke else get_config(name)


def check_member(entry: Dict, cfg) -> None:
    got = describe(cfg)
    bad = {k: (entry.get(k), got[k]) for k in ARCH_KEYS
           if (entry.get(k) or 0) != (got[k] or 0)}
    if bad:
        raise SystemExit(f"portbench: {entry['name']}: the config file and the port "
                         f"disagree on {bad} (file, port)")
