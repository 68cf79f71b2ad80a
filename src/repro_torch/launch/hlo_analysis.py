"""What one traced step costs a device: FLOPs, peak bytes, collectives.

The counterpart of ``repro.launch.hlo_analysis``, kept under its name so a
reader finds it; there is no HLO here. The reference reads XLA's compiled
executable: ``cost_analysis()`` for FLOPs, ``memory_analysis()`` for the
peak, and the optimized HLO text for collectives. The port runs the step
itself (on meta tensors in the dry-run) under :class:`StepCounter`, a
dispatch mode that sees the ops each device runs:

  * An op on DTensors is passed on (``NotImplemented``), so DTensor turns
    it into the local ops and collectives of one rank, which the mode
    then sees: every count is per device, as the reference's post-SPMD
    counts are. DTensor works out each new op's output shape by running
    it on global-shaped fake tensors; those ops pass uncounted.
  * FLOPs: ``torch.utils.flop_counter``'s registry, the table
    ``FlopCounterMode`` uses, which counts matmul-class ops (mm, bmm,
    addmm, baddbmm, convolutions, attention kernels). XLA's count also
    takes elementwise ops, reductions and transcendentals, so the port's
    figure is lower by those.
  * Peak bytes: every storage the step's ops make is counted live from
    its creation until Python frees it (a weak reference's finalizer),
    on top of the storages live when the step starts (params, optimizer
    state, batch, caches); the peak is the largest sum seen.
  * Collectives: each ``_c10d_functional`` op DTensor issues, with its
    kind, per-device result bytes and group size, turned into bytes per
    device by :func:`collective_bytes_per_device`, the reference's ring
    formulas term for term.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# _c10d_functional op -> the reference's HLO collective kind.
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _group_size(func, args, kwargs) -> int:
    """The collective's group size: its ``group_size`` argument, else the
    size of the process group its ``group_name`` names."""
    schema = func._schema.arguments
    named = dict(zip((a.name for a in schema), args), **kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    return dist.distributed_c10d._resolve_process_group(named["group_name"]).size()


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, live bytes and collectives of the ops one device runs.

    ``hold(tree)`` registers tensors that exist before the step (their
    storages count as live from the start). Read ``flops``,
    ``peak_bytes``, ``start_bytes`` and ``collectives`` after the step.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives: List[Dict] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self.start_bytes = 0
        self._live: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def _track(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage live if it is new; True if it was."""
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self._live:
            return False
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return True

    def hold(self, tree: Any) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.start_bytes = self.live_bytes

    def storages(self, tree: Any) -> Dict[int, int]:
        """{storage id: bytes} of the tensors in ``tree``."""
        out = {}
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = _local(t).untyped_storage()
                out[id(st)] = st.nbytes()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in tree_leaves(out)):
            return out       # DTensor's sharding propagation on global shapes
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace in _NAMESPACES and func.__name__.split(".")[0] in _KINDS:
            self.collectives.append({
                "kind": _KINDS[func.__name__.split(".")[0]],
                "result_bytes": sum(t.nbytes for t in tree_leaves(out)
                                    if isinstance(t, torch.Tensor)),
                "group": _group_size(func, args, kwargs),
            })
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def collective_bytes_per_device(collectives: List[Dict]) -> Tuple[float, Dict]:
    """Bytes each device sends per step + per-kind breakdown (ring formulas):

        all-gather       out_bytes * (g-1)/g
        all-reduce       2 * bytes * (g-1)/g
        reduce-scatter   out_bytes * (g-1)         (out is the scattered shard)
        all-to-all       bytes * (g-1)/g
        collective-permute   bytes
    """
    total = 0.0
    by_kind: Dict[str, float] = {}
    for c in collectives:
        g = max(c["group"], 1)
        b = float(c["result_bytes"])
        if c["kind"] == "collective-permute":
            contrib = b          # point-to-point: no replica_groups attr
        elif g == 1:
            contrib = 0.0
        elif c["kind"] == "all-gather":
            contrib = b * (g - 1) / g
        elif c["kind"] == "all-reduce":
            contrib = 2.0 * b * (g - 1) / g
        elif c["kind"] == "reduce-scatter":
            contrib = b * (g - 1)
        elif c["kind"] == "all-to-all":
            contrib = b * (g - 1) / g
        else:
            contrib = b
        total += contrib
        by_kind[c["kind"]] = by_kind.get(c["kind"], 0.0) + contrib
    return total, by_kind


def summarize(counter: StepCounter, args: Any, outputs: Any) -> Dict:
    """The reference's ``summarize_compiled`` keys, from a counted step:
    ``args`` the step's inputs, ``outputs`` what it returned. Outputs
    whose storage is an input's (the donated params and moments) count
    as aliases. ``bytes_accessed`` has no counterpart and is left out."""
    arg_st = counter.storages(args)
    out_st = counter.storages(outputs)
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    coll_bytes, by_kind = collective_bytes_per_device(counter.collectives)
    return {
        "flops": float(counter.flops),
        "argument_bytes_per_device": int(sum(arg_st.values())),
        "output_bytes_per_device": int(sum(out_st.values())),
        "temp_bytes_per_device": int(counter.peak_bytes - counter.start_bytes),
        "alias_bytes_per_device": int(alias),
        "peak_bytes_per_device": int(counter.peak_bytes),
        "collective_bytes_per_device": coll_bytes,
        "collective_breakdown": by_kind,
        "n_collectives": len(counter.collectives),
    }
