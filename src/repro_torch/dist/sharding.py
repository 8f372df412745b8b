"""Sharding plans: mesh axes -> partition specs -> DTensor placements.

Counterpart of ``repro/dist/sharding.py``; the rule tables are the
reference's, unchanged (DESIGN.md §5):

* FSDP over the ``data``-like axes (all mesh axes except ``model``): matmul
  weights shard their *input* dim, the embedding shards its vocab dim.
* TP over ``model``: column-parallel up-projections (``wq``/``w_gate``/...)
  shard the output dim, row-parallel down-projections (``wo``/``w_down``/...)
  shard the input dim; their biases follow the sharded output dim.
* Layers stacked over repeats (everything under ``unit`` or the encoder's
  ``blocks``) carry a leading layer axis that stays unsharded -> leading
  ``None``.
* Norm scales/biases and the (small, f32) MoE router stay replicated.
* MoE experts: expert dim over ``model`` when the expert count divides TP
  (expert parallelism, Llama-4); otherwise experts are replicated and each
  expert's ``d_ff`` shards over ``model`` (tensor-parallel experts, Mixtral).
* Decode caches shard their sequence dim over ``model``.

Every rule drops mesh axes that do not divide the concrete dim (the policy
of ``RunCtx.constrain``), so one rule table serves the whole config zoo.

A spec (:class:`PartitionSpec`, alias ``P``) is a tuple with one entry per
tensor dim: a mesh axis name, a tuple of names, or ``None``, as the
reference's ``jax.sharding.PartitionSpec``.  :func:`named` turns a spec
tree into DTensor placements on a mesh (``Shard(d)`` on each mesh dim that
an entry names, ``Replicate()`` elsewhere) and :func:`distribute` places
tensors by them, where the reference calls ``jax.device_put(x,
named(...))``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or any object with
``mesh_dim_names`` and ``shape`` (one size per name), so the production
meshes can be tabled without their ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import RunCtx
from repro_torch.tree import map_with_path

# rule symbols
F = "fsdp"   # shard over the fsdp (data-like) axes
T = "tp"     # shard over the tensor axis
N = None     # replicate this dim


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of axis names
    (that dim sharded over all of them, the first outermost) or ``None``
    (replicated along that dim)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a stand-in mesh."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Which mesh axes play which role; the one object the rules consume."""
    mesh: Any
    fsdp: Tuple[str, ...]
    tp: Optional[str]

    def axis_size(self, axis: Optional[str]) -> int:
        if axis is None:
            return 1
        return axis_sizes(self.mesh)[axis]

    @property
    def dp_size(self) -> int:
        return math.prod(self.axis_size(a) for a in self.fsdp)

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp)


def make_plan(mesh) -> MeshPlan:
    """FSDP over every non-``model`` axis; TP over ``model`` when present."""
    axes = tuple(mesh.mesh_dim_names)
    tp = "model" if "model" in axes else None
    return MeshPlan(mesh=mesh, fsdp=tuple(a for a in axes if a != tp), tp=tp)


# ---------------------------------------------------------------------------
# spec resolution


def _fsdp_entry(plan: MeshPlan):
    if not plan.fsdp:
        return None
    return plan.fsdp[0] if len(plan.fsdp) == 1 else plan.fsdp


def _resolve(plan: MeshPlan, shape: Tuple[int, ...], template) -> P:
    """Rule template -> spec, dropping axes that do not divide."""
    if template is None or len(template) != len(shape):
        return P(*([None] * len(shape)))
    out = []
    for dim, sym in zip(shape, template):
        if sym == F:
            axes, size = _fsdp_entry(plan), plan.dp_size
        elif sym == T:
            axes, size = plan.tp, plan.tp_size
        else:
            axes, size = None, 1
        out.append(axes if axes is not None and size > 1 and dim % size == 0
                   else None)
    return P(*out)


# ---------------------------------------------------------------------------
# parameter specs

# column-parallel (in, out) weights: input over FSDP, output over TP
_COL2D = {"wq", "wk", "wv", "w_gate", "w_up", "w_rec_in", "w_gate_in",
          "w_a", "w_i", "wi", "wf", "w_ogate", "w_in"}
# row-parallel (in, out) weights: input over TP, output over FSDP
_ROW2D = {"wo", "w_down", "w_out", "lm_head"}
# 1-d vectors following a TP-sharded output dim
_TPVEC = {"bq", "bk", "bv", "b_in", "bi", "bf", "b_a", "b_i", "conv_b",
          "lam"}
# always replicated
_REPLICATED = {"scale", "bias", "router"}


def _param_template(name: str, ndim: int, cfg: ModelConfig,
                    plan: MeshPlan):
    if name in _REPLICATED:
        return None
    if name == "embed":
        return (F, T)
    if name in _COL2D and ndim == 2:
        return (F, T)
    if name in _ROW2D and ndim == 2:
        return (T, F)
    if name in _TPVEC and ndim == 1:
        return (T,)
    if name == "conv_w" and ndim == 2:       # (taps, r)
        return (N, T)
    if name == "r" and ndim == 3:            # sLSTM block-diag recurrence
        return (T, N, N)
    if name in ("we_gate", "we_up", "we_down") and ndim == 3:
        moe = cfg.moe
        expert_parallel = (moe is not None and plan.tp_size > 1
                           and moe.num_experts % plan.tp_size == 0)
        if name == "we_down":                # (E, ff, d)
            return (T, N, F) if expert_parallel else (N, T, F)
        return (T, F, N) if expert_parallel else (N, F, T)  # (E, d, ff)
    return None


def param_specs(params, cfg: ModelConfig, plan: MeshPlan):
    """Spec tree mirroring ``params`` (also fits the optimizer's momentum
    tree, which copies the parameter structure)."""
    def rule(keys, leaf):
        name = keys[-1] if keys else ""
        stacked = "unit" in keys or "blocks" in keys
        shape = tuple(leaf.shape)
        base = shape[1:] if stacked else shape
        spec = _resolve(plan, base, _param_template(name, len(base), cfg,
                                                     plan))
        return P(None, *spec) if stacked else spec

    return map_with_path(rule, params)


# ---------------------------------------------------------------------------
# batch / cache specs


def batch_specs(cfg: ModelConfig, plan: MeshPlan, batch,
                seq_sharded: bool = False):
    """Batch leaves: global batch over FSDP; the sequence dim additionally
    shards over TP in context-parallel mode (``seq_sharded``)."""
    s_sym = T if seq_sharded else N

    def rule(keys, leaf):
        name = keys[-1]
        shape = tuple(leaf.shape)
        if name == "mrope_positions":            # (3, b, s)
            tmpl = (N, F, s_sym)
        elif name in ("audio_feats", "patch_embeds"):  # (b, s', d)
            tmpl = (F, N, N)
        elif len(shape) == 1:                    # sample_weights (b,)
            tmpl = (F,)
        elif len(shape) == 2:                    # tokens/labels/mask (b, s)
            tmpl = (F, s_sym)
        else:
            tmpl = (F,) + (N,) * (len(shape) - 1)
        return _resolve(plan, shape, tmpl)

    return map_with_path(rule, batch)


# cache leaf name + base ndim -> template (see models/decode.py layouts)
_CACHE_RULES = {
    ("k", 4): (F, T, N, N), ("v", 4): (F, T, N, N),
    ("ck", 4): (F, T, N, N), ("cv", 4): (F, T, N, N),
    ("h", 2): (F, T),                       # RG-LRU hidden (b, r)
    ("conv", 3): (F, N, T),                 # conv taps (b, taps, r)
    ("c", 4): (F, T, N, N),                 # mLSTM matrix memory
    ("c", 3): (F, T, N), ("n", 3): (F, T, N), ("h", 3): (F, T, N),
    ("m", 3): (F, T, N),                    # sLSTM states (b, nh, hd)
    ("n", 2): (F, T), ("m", 2): (F, T),     # mLSTM norms (b, nh)
}


def cache_specs(cfg: ModelConfig, plan: MeshPlan, cache):
    """Decode-cache specs: batch over FSDP, sequence/head state over TP."""
    def rule(keys, leaf):
        name = keys[-1] if keys else ""
        stacked = "unit" in keys
        shape = tuple(leaf.shape)
        base = shape[1:] if stacked else shape
        spec = _resolve(plan, base, _CACHE_RULES.get((name, len(base))))
        return P(None, *spec) if stacked else spec

    return map_with_path(rule, cache)


# ---------------------------------------------------------------------------
# run context


def attn_mode_for(cfg: ModelConfig, plan: MeshPlan) -> str:
    """Attention execution mode (``models/transformer.py``):

    * ``local``    — no tensor axis: per-shard attention, nothing to gather;
    * ``megatron`` — heads divide TP: gather sequence, shard heads;
    * ``context``  — heads do NOT divide TP: keep queries sequence-sharded
      and gather the K/V (context parallelism).
    """
    if plan.tp is None or plan.tp_size == 1:
        return "local"
    if cfg.num_heads % plan.tp_size == 0:
        return "megatron"
    return "context"


def make_run_ctx(cfg: ModelConfig, plan: MeshPlan, *,
                 compute_dtype=None, param_dtype=None, remat: bool = True,
                 chunk_q: int = 512, chunk_k: int = 512,
                 loss_chunk: int = 512, device: str = "cuda") -> RunCtx:
    """RunCtx wired to the plan's mesh/axes with the right attention mode;
    bf16 dtypes unless the caller asks for others, as the reference's."""
    mode = attn_mode_for(cfg, plan)
    return RunCtx(
        mesh=plan.mesh,
        tp_axis=plan.tp if plan.tp is not None else "model",
        dp_axes=tuple(plan.fsdp),
        attn_mode=mode,
        chunk_q=chunk_q, chunk_k=chunk_k, remat=remat, loss_chunk=loss_chunk,
        param_dtype=param_dtype if param_dtype is not None else torch.bfloat16,
        compute_dtype=(compute_dtype if compute_dtype is not None
                       else torch.bfloat16),
        seq_sharded=(mode == "context"),
        device=device,
    )


# ---------------------------------------------------------------------------
# placements


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh and the DTensor placements it gives there (one per
    mesh dim)."""
    mesh: Any
    spec: P
    placements: Tuple[Any, ...]


def resolve_axes(mesh, shape, spec_axes) -> P:
    """``RunCtx.constrain``'s rule: keep each entry whose axes' sizes
    multiply to a divisor of its dim; drop the rest, any axis the mesh
    does not have, and (as the rule tables do) axes of size 1, which shard
    nothing."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, spec_axes):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        if not axes or any(a not in sizes for a in axes):
            out.append(None)
            continue
        n = math.prod(sizes[a] for a in axes)
        out.append(ax if n > 1 and dim % n == 0 else None)
    return P(*out)


def placements_of(mesh, spec) -> Tuple[Any, ...]:
    """A spec -> one placement per mesh dim: ``Shard(d)`` where entry d
    names the mesh dim, ``Replicate()`` where none does.

    A tuple entry shards one tensor dim over several mesh dims.  DTensor
    orders them as the mesh does, JAX as the tuple does: the tuple must
    list them in the mesh's order (the rules only make that order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec entry {entry!r} does not follow the "
                             f"mesh's axis order {names}")
        for i in where:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of spec {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


def named(tree, specs, mesh):
    """Spec tree -> tree of :class:`NamedSharding` on ``mesh``.  ``specs``
    mirrors ``tree``'s structure (``tree`` is kept for the reference's
    signature)."""
    del tree
    return map_with_path(
        lambda _, s: NamedSharding(mesh, s, placements_of(mesh, s)), specs)


def distribute(tree, specs, mesh):
    """Place every tensor of ``tree`` on ``mesh`` as a ``DTensor`` with its
    spec's placements (the reference's ``jax.device_put(x, named(...))``).

    Every rank passes the same global tensors (made from one seed) and keeps
    its own shards: nothing is sent.  The mesh's device (CUDA unless the
    mesh was built for the CPU) must exist."""
    from torch.distributed.tensor import distribute_tensor
    dev = resolve_device(mesh.device_type)

    return map_with_path(
        lambda _, x, s: distribute_tensor(x.to(dev), mesh,
                                          placements_of(mesh, s),
                                          src_data_rank=None), tree, specs)
