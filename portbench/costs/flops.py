"""The work of one eager step of the program, as the yardstick of
`mfu.*` and of the kernels' bounds a launch.

`count_step` runs the step once under a dispatch mode that counts the
FLOPs of every matrix product by the dtype of its operands (the formulas
of `torch.utils.flop_counter`; elementwise work is left out), while the
program's hand-written kernels, which the mode cannot see, are counted by
their own functions (`k1.py`, `k2.py`, `k3.py`) at the shapes and valid
slots of each call: K1 and K2 in the forward, K3 once for every K2 call
whose inputs take a gradient. A captured step replays the same kernels,
so the counts are those of the traced steps."""

from __future__ import annotations

import contextlib
import importlib
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from portbench.costs import k1, k2, k3

DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.float16: "float16"}

# the program's functions that launch K1 and K2, as (module, name) where
# the model calls them; `counting` wraps them there, and a test checks
# that they exist and that a step calls them
HOOKS = {"k1": ("pharmaforge_tpu_torch.models.edges", "knn_pf_edges"),
         "k2": ("pharmaforge_tpu_torch.models.conv", "fused_message_agg")}


class MatmulFlops(TorchDispatchMode):
    """FLOPs of matrix products by operand dtype; paused while `paused`."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and not self.paused:
            dt = next(a.dtype for a in tree_leaves(args)
                      if isinstance(a, torch.Tensor))
            self.flops[DTYPES.get(dt, str(dt))] += formula(
                *args, **kwargs, out_val=out)
        return out


def k2_args(pre_s, vh_planes, edge, layer_params, *, scalar_size,
            vector_size, rbf_dim, compute_dtype="float32", copies=1):
    """`costs.k2.cost`'s arguments from a `fused_message_agg` call."""
    b, p, _ = pre_s.shape
    g, nd, k = edge.mask.shape
    return dict(b=b, p=p, g=g, nd=nd, k=k, valid=int(edge.mask.sum()),
                copies=copies, s=scalar_size, v=vector_size, r=rbf_dim,
                n_gvps=len(layer_params),
                idx_bytes=edge.idx.element_size(),
                mask_bytes=edge.mask.element_size(),
                geom_bytes=edge.x_dir.element_size()), compute_dtype


@contextlib.contextmanager
def counting():
    """Inside the block, the program's K1 and K2 calls (`HOOKS`) are
    recorded and its matrix products counted: yields {"matmul":
    MatmulFlops, "k1": [(b, f, p, k)], "k2": [(kwargs, dtype,
    with_grad)]}."""
    mode = MatmulFlops()
    seen = {"matmul": mode, "k1": [], "k2": []}
    modules = {k: importlib.import_module(m) for k, (m, _) in HOOKS.items()}
    real = {k: getattr(modules[k], name) for k, (_, name) in HOOKS.items()}

    def knn(pharm_x, pharm_mask, prot_x, prot_mask, k):
        seen["k1"].append((*pharm_mask.shape, prot_mask.shape[1], k))
        mode.paused = True
        try:
            return real["k1"](pharm_x, pharm_mask, prot_x, prot_mask, k)
        finally:
            mode.paused = False

    def k2_call(*args, **kw):
        kwargs, dt = k2_args(*args, **kw)
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in [args[0], *args[1]])
        seen["k2"].append((kwargs, dt, grad))
        mode.paused = True
        try:
            return real["k2"](*args, **kw)
        finally:
            mode.paused = False

    wrapped = {"k1": knn, "k2": k2_call}
    for k, (_, name) in HOOKS.items():
        setattr(modules[k], name, wrapped[k])
    try:
        with mode:
            yield seen
    finally:
        for k, (_, name) in HOOKS.items():
            setattr(modules[k], name, real[k])


def summarize(seen, peaks: dict, bound) -> Tuple[Dict[str, object],
                                                 List[str]]:
    """(work, notes): each kernel's least time a launch (the mean over
    its launches in the step), and the step's FLOPs by dtype with their
    time at each dtype's peak."""
    flops = dict(seen["matmul"].flops)
    work: Dict[str, object] = {}
    notes = []
    for name, calls in (("k1", [(k1.cost(*c), "float32")
                                for c in seen["k1"]]),
                        ("k2", [(k2.cost(table_bytes=2 if dt == "bfloat16"
                                             else 4, **kw)[:2], dt)
                                for kw, dt, _ in seen["k2"]]),
                        ("k3", [(k3.cost(elem=2 if dt == "bfloat16" else 4,
                                         **kw)[:2], "float32")
                                for kw, dt, grad in seen["k2"] if grad])):
        if not calls:
            continue
        times = []
        for (n_bytes, n_ops), dt in calls:
            t, by = bound(n_bytes, n_ops, dt, peaks)
            times.append(t)
            flops[dt] = flops.get(dt, 0.0) + n_ops
            notes.append(f"{name}: {n_bytes} B, {n_ops} ops, least "
                         f"{t:.9f} s by {by} ({dt} peak)")
        work[name] = sum(times) / len(times)
    work["flops"] = flops
    work["peak_s_per_step"] = sum(n / peaks["ops_per_s"][d]
                                  for d, n in flops.items())
    notes.append(f"step FLOPs by dtype: {flops}")
    return work, notes


def count_step(step: Callable[[], object], peaks: dict, bound):
    with counting() as seen:
        step()
    return summarize(seen, peaks, bound)
