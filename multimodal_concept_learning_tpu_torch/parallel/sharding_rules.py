"""Parameter sharding rules for N-D meshes (counterpart of
multimodal_concept_learning_tpu/parallel/sharding_rules.py).

The rules are the JAX package's, decided on each parameter's JAX leaf:
its path (``_jax_keys``: the converter's names read backwards) and its
LOGICAL shape (the flax shape: q/k/v kernels [H, heads, hd], o [heads, hd,
H], Dense [in, out]; ``_View``: the reshape and transpose between it and
the port's layout).

- LM embedding + tied head: vocab sharded over ``model``;
- LM MLP: gate/up column-parallel, down row-parallel;
- LM attention: q/k/v head-sharded, o row-parallel;
- ViT MLP: intermediate column-parallel, output row-parallel (ViT
  attention stays replicated);
- int8 ``scale`` replicated; MoE ``experts_*`` sharded on E (expert
  parallelism);
- a dimension that does not divide the axis stays replicated (``_maybe``),
  so a single-KV-head projection is replicated on a 2-way model axis;
- ``fsdp_axis`` additionally shards the largest remaining divisible
  dimension (ties to the larger index); the embedding instead extends its
  vocab shard over ``(model, fsdp)``.

``shard_params(model, mesh, ...)`` turns a built model's parameters (and
its int8 buffers) into this rank's shards IN PLACE: a shard is the port
layout of this rank's block of the logical tensor, so a column-parallel
``nn.Linear.weight`` keeps its local output rows and an o projection its
local input columns.  Each sharded tensor carries a ``ShardInfo``
(``tensor._mcl_shard``); a tensor sharded over the FSDP axis is read
through a parametrization that all-gathers it on use (reduce-scattering
its gradient over the ranks that hold other data), so every module sees
its tensor-parallel shard.  The modules then run JAX's sharded function
with explicit collectives (``parallel/collectives.py``), from the plans
this module attaches: ``_tp`` on each column- or row-parallel projection,
LoRA adapter, vocab-sharded embedding and expert-sharded MoE layer; each
LM attention's head plan; the LM config replaced by one that counts this
rank's heads (so caches and page pools hold the local KV heads).

``mllm_param_spec(name, param, mesh, ...)`` is one tensor's spec and
``param_shardings(model, mesh, ...)`` the name -> spec table (one
entry per logical dimension: None, an axis or a tuple of axes), the names
the port's state dicts use; ``full_state_dict`` gathers every tensor back
to its full shape and ``load_full_state_dict`` slices a full state dict
onto the shards.  The mesh may be a ``DeviceMesh`` or, for the table
alone, an ``{axis: size}`` dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.utils.parametrize as parametrize
from torch import nn

from multimodal_concept_learning_tpu_torch.parallel import collectives as col

# -- logical views ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _View:
    """Between the port layout of a tensor and its JAX logical layout.
    kind: "id", "t" (2-D transpose), "qkv" ([heads*hd, H] <-> [H, heads,
    hd]), "o" ([H, heads*hd] <-> [heads, hd, H]), "heads" ([heads*hd] <->
    [heads, hd]), "patch" ([H, C, p, p] <-> [p*p*C, H])."""

    kind: str = "id"
    heads: int = 0
    patch: int = 0
    channels: int = 0

    def logical_shape(self, shape) -> Tuple[int, ...]:
        k = self.kind
        if k == "t":
            return (shape[1], shape[0])
        if k == "qkv":
            return (shape[1], self.heads, shape[0] // self.heads)
        if k == "o":
            return (self.heads, shape[1] // self.heads, shape[0])
        if k == "heads":
            return (self.heads, shape[0] // self.heads)
        if k == "patch":
            return (shape[1] * shape[2] * shape[3], shape[0])
        return tuple(shape)

    def to_logical(self, t: torch.Tensor, lshape) -> torch.Tensor:
        k = self.kind
        if k == "t":
            return t.t()
        if k in ("qkv", "o"):
            return t.t().reshape(lshape)
        if k == "heads":
            return t.reshape(lshape)
        if k == "patch":
            return t.permute(2, 3, 1, 0).reshape(lshape)
        return t

    def from_logical(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kind
        if k == "t":
            return x.t()
        if k == "qkv":
            return x.reshape(x.shape[0], -1).t()
        if k == "o":
            return x.reshape(-1, x.shape[-1]).t()
        if k == "heads":
            return x.reshape(-1)
        if k == "patch":
            rows = x.shape[0] // (self.patch * self.channels)
            return x.reshape(rows, self.patch, self.channels, x.shape[1]).permute(3, 2, 0, 1)
        return x


# -- the JAX rules (parallel/sharding_rules.py:32-160), on logical shapes -------------


def _maybe(spec_dims, shape, sizes: Dict[str, int], model_axis: str):
    """Replicate the model-sharded dims that do not divide the axis."""
    axis_size = sizes[model_axis]
    return tuple(None if (dim == model_axis and s % axis_size != 0) else dim
                 for dim, s in zip(spec_dims, shape))


def _spec_dims(keys, shape) -> Optional[list]:
    """Axis-role list ("M" for the model axis) for a leaf, or None."""
    if keys and keys[-1] == "scale":
        return None
    if keys and keys[-1].startswith("experts_"):
        return ["M"] + [None] * (len(shape) - 1)
    if "embed_tokens" in keys and "embedding" in keys:
        return ["M", None]
    if any(k in keys for k in ("gate_proj", "up_proj")):
        return [None, "M"]
    if "down_proj" in keys:
        return ["M", None]
    if any(k in keys for k in ("q_proj", "k_proj", "v_proj")):
        return [None, "M", None] if len(shape) == 3 else [None, "M"]
    if "o_proj" in keys:
        return ["M", None, None] if len(shape) == 3 else ["M", None]
    if "intermediate" in keys and keys[-1] == "kernel":
        return [None, "M"]
    if "intermediate" in keys and keys[-1] == "bias":
        return ["M"]
    if "output" in keys and "attention" not in keys and keys[-1] == "kernel" and len(shape) == 2:
        return ["M", None]
    return None


def _apply_fsdp(dims, shape, sizes: Dict[str, int], fsdp_axis: str):
    """Shard the largest still-unsharded divisible dim over ``fsdp_axis``."""
    axis_size = sizes[fsdp_axis]
    if axis_size == 1:
        return list(dims)
    candidates = [(s, i) for i, (d, s) in enumerate(zip(dims, shape))
                  if d is None and s % axis_size == 0 and s >= axis_size]
    if not candidates:
        return list(dims)
    _, idx = max(candidates)
    out = list(dims)
    out[idx] = fsdp_axis
    return out


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` (or of such a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for_leaf(keys: Sequence[str], shape: Sequence[int], mesh, model_axis: str = "model",
                  fsdp_axis: Optional[str] = None) -> Tuple:
    """The JAX ``mllm_param_spec`` of the leaf at ``keys`` with the logical
    ``shape``, one entry per dimension (None for replicated)."""
    sizes = axis_sizes(mesh)
    shape = tuple(shape)
    tp_on = model_axis in sizes and sizes[model_axis] > 1
    fsdp_on = fsdp_axis is not None and fsdp_axis in sizes and sizes[fsdp_axis] > 1
    if not tp_on and not fsdp_on:
        return (None,) * len(shape)
    keys = list(keys)
    dims = _spec_dims(keys, shape) if tp_on else None
    dims = [None] * len(shape) if dims is None else [model_axis if d == "M" else None
                                                      for d in dims]
    spec = _maybe(dims, shape, sizes, model_axis) if tp_on else tuple(dims)
    if fsdp_on and "embed_tokens" in keys and "embedding" in keys:
        vocab, fs = shape[0], sizes[fsdp_axis]
        if tp_on and vocab % (sizes[model_axis] * fs) == 0:
            return ((model_axis, fsdp_axis),) + (None,) * (len(shape) - 1)
        if not tp_on and vocab % fs == 0:
            return (fsdp_axis,) + (None,) * (len(shape) - 1)
        return tuple(spec)
    if fsdp_on:
        spec = _apply_fsdp(list(spec), shape, sizes, fsdp_axis)
    return tuple(spec)


# -- the port's tensors as JAX leaves -----------------------------------------------


def canonical_name(name: str) -> str:
    """A parameter's state-dict name without a parametrization's wrapping."""
    return name.replace(".parametrizations.", ".").replace(".original", "")


_RENAMES = (
    ("embeddings.patch_embeddings.projection.", "patch_embed."),
    ("embeddings.cls_token", "cls_token"),
    ("embeddings.position_embeddings", "position_embeddings"),
    ("attention.attention.", "attention."),
    ("attention.output.dense.", "attention.output."),
    ("intermediate.dense.", "intermediate."),
    ("output.dense.", "output."),
    ("embed_tokens.weight", "embed_tokens.embedding"),
    ("token_embedding.weight", "token_embedding.embedding"),
)
_TABLES = ("embed_tokens", "token_embedding")  # [V, H] embeddings: the JAX layout
_QKV = ("q_proj", "k_proj", "v_proj", "query", "key", "value", "q", "k", "v")


def _jax_keys(name: str, shape) -> Tuple[str, ...]:
    """The JAX leaf path of the port tensor ``name`` (as
    ``checkpoint.state_dict_from_jax`` maps one onto the other): a weight
    of two or more dims is a ``kernel``, the LM's ``layers.{i}`` and the
    towers' ``layer.{i}`` / ``blocks.{i}`` are ``layer_{i}`` /
    ``block_{i}``, the MLP's ``mlp.`` level and HF's ``dense.`` levels
    drop out.  The rules read only the names they test."""
    parts = name.split(".")
    if parts[-1] == "weight" and len(shape) >= 2 and parts[-2] not in _TABLES:
        parts[-1] = "kernel"
    dotted = ".".join(parts)
    for old, new in _RENAMES:
        dotted = dotted.replace(old, new)
    out, toks, i = [], dotted.split("."), 0
    while i < len(toks):
        tok = toks[i]
        if tok in ("layers", "layer", "blocks") and i + 1 < len(toks) and toks[i + 1].isdigit():
            out.append(("block_" if tok == "blocks" else "layer_") + toks[i + 1])
            i += 2
            continue
        if tok == "mlp" or (tok == "model" and i + 1 < len(toks)
                            and toks[i + 1] in ("embed_tokens", "norm", "layers")):
            i += 1
            continue
        out.append(tok)
        i += 1
    return tuple(out)


def _view_of(name: str, shape, heads: int = 0) -> _View:
    """How the port tensor ``name`` of ``shape`` maps onto its JAX logical
    shape; ``heads`` counts the heads of an attention projection (q/k/v
    and o kernels, a tower's q/k/v biases), which the port flattens."""
    parts = name.split(".")
    leaf, owner = parts[-1], (parts[-2] if len(parts) > 1 else "")
    o_proj = owner in ("o_proj", "out") or name.endswith("attention.output.dense.weight")
    if leaf == "weight" and len(shape) == 4:  # the patch embedding [H, C, p, p]
        return _View("patch", patch=shape[3], channels=shape[1])
    if leaf == "weight" and len(shape) == 2 and owner not in _TABLES:
        if owner in _QKV or o_proj:
            if not heads:
                raise ValueError(f"{name}: the head count of an attention projection is needed")
            return _View("qkv" if owner in _QKV else "o", heads=heads)
        return _View("t")  # nn.Linear [out, in] <-> Dense [in, out]
    if leaf == "bias" and owner in _QKV and heads and owner not in ("q_proj", "k_proj",
                                                                      "v_proj"):
        return _View("heads", heads=heads)  # a tower's q/k/v bias [heads, hd]
    return _View("id")


def _head_counts(model: nn.Module) -> Dict[str, int]:
    """{projection module name: its heads} of every attention in ``model``."""
    from multimodal_concept_learning_tpu_torch.models.clip import TextBlock
    from multimodal_concept_learning_tpu_torch.models.lm import LMAttention
    from multimodal_concept_learning_tpu_torch.models.vit import ViTLayer

    out = {}
    for prefix, mod in model.named_modules():
        at = f"{prefix}." if prefix else ""
        if isinstance(mod, LMAttention):
            cfg = mod.full_cfg
            out.update({at + "q_proj": cfg.num_heads, at + "o_proj": cfg.num_heads,
                        at + "k_proj": cfg.num_kv_heads, at + "v_proj": cfg.num_kv_heads})
        elif isinstance(mod, ViTLayer):
            heads = mod.cfg.num_attention_heads
            out.update({f"{at}attention.attention.{n}": heads for n in ("query", "key", "value")})
            out[at + "attention.output.dense"] = heads
        elif isinstance(mod, TextBlock):
            out.update({at + n: mod.heads for n in ("q", "k", "v", "out")})
    return out


def mllm_param_spec(name: str, param, mesh, model_axis: str = "model",
                    fsdp_axis: Optional[str] = None, heads: int = 0) -> Tuple:
    """The JAX ``mllm_param_spec`` of the port tensor ``name`` (an MLLM,
    CLIP or classifier state-dict name) of ``param``'s shape: one entry a
    JAX logical dimension.  ``heads``: the heads of an attention
    projection (``param_shardings`` reads them from the model)."""
    shape = tuple(param.shape)
    view = _view_of(name, shape, heads)
    return spec_for_leaf(_jax_keys(name, shape), view.logical_shape(shape), mesh, model_axis,
                         fsdp_axis)


# -- the layout of a sharded model ----------------------------------------------------


@dataclasses.dataclass
class Layout:
    """A sharded model's mesh: axis sizes, this rank's coordinates, the
    model / FSDP / data axes, and the groups the collectives run over."""

    mesh: object
    sizes: Dict[str, int]
    coords: Dict[str, int]
    model_axis: str
    fsdp_axis: Optional[str]
    data_axes: Tuple[str, ...]

    def group(self, axes) -> col.AxisGroup:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return col.mesh_group(self.mesh, axes)

    @property
    def tp_on(self) -> bool:
        return self.sizes.get(self.model_axis, 1) > 1

    @property
    def fsdp_on(self) -> bool:
        return self.fsdp_axis is not None and self.sizes.get(self.fsdp_axis, 1) > 1

    def data_group(self) -> col.AxisGroup:
        return self.group(self.data_axes) if self.data_axes else col.AxisGroup((), [
            torch.distributed.get_rank()])


def make_layout(mesh, model_axis: str = "model", fsdp_axis: Optional[str] = None) -> Layout:
    """The ``Layout`` of ``mesh`` for this rank (the data axes: every axis
    but ``model_axis``); makes every group the sharded model's collectives
    use (a collective call)."""
    import torch.distributed as dist

    sizes = axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    if fsdp_axis is not None and fsdp_axis == model_axis:
        raise ValueError("fsdp_axis must differ from model_axis")
    data_axes = tuple(a for a in names if a != model_axis)
    coords = {}
    ranks = mesh.mesh.reshape(mesh.shape)
    where = (ranks == dist.get_rank()).nonzero()
    if len(where) != 1:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    for a, c in zip(names, where[0].tolist()):
        coords[a] = c
    layout = Layout(mesh, sizes, coords, model_axis, fsdp_axis, data_axes)
    # every group, made in one order on every rank
    wanted = [(a,) for a in names]
    if layout.data_axes:
        wanted.append(layout.data_axes)
    if fsdp_axis is not None and fsdp_axis in sizes:
        wanted.append(tuple(a for a in layout.data_axes if a != fsdp_axis))
        if model_axis in sizes:
            wanted.append((model_axis, fsdp_axis))
    for axes in wanted:
        if axes:
            layout.group(axes)
    return layout


@dataclasses.dataclass
class ShardInfo:
    """One tensor's sharding: its full JAX ``logical_shape``, ``spec`` (per
    logical dim), ``view``, the logical dim of its FSDP shard
    (``fsdp_dim``), whether that gather's backward sums the ranks'
    gradients (``fsdp_sums``), and the data axes its gradient is still
    summed over (``reduce_axes``: the data axes less those its FSDP
    gather's backward already summed)."""

    logical_shape: Tuple[int, ...]
    spec: Tuple
    view: _View
    layout: Layout
    fsdp_dim: Optional[int] = None
    fsdp_sums: bool = True
    reduce_axes: Tuple[str, ...] = ()

    def shard_axes(self) -> Tuple[str, ...]:
        """Every axis this tensor is split over (model and/or FSDP)."""
        out = []
        for d in self.spec:
            for a in ((d,) if isinstance(d, str) else (d or ())):
                if a not in out:
                    out.append(a)
        return tuple(out)

    def local_logical_shape(self) -> Tuple[int, ...]:
        """The logical shape of this rank's block."""
        out = []
        for s, d in zip(self.logical_shape, self.spec):
            _, n = col.combined_index(self.layout.coords, self.layout.sizes, d) if d else (0, 1)
            out.append(s // n)
        return tuple(out)


def _block(full_logical: torch.Tensor, spec, layout: Layout) -> torch.Tensor:
    out = full_logical
    for d, axes in enumerate(spec):
        if axes:
            idx, n = col.combined_index(layout.coords, layout.sizes, axes)
            size = out.shape[d] // n
            out = out.narrow(d, idx * size, size)
    return out


def shard_tensor(full: torch.Tensor, info: ShardInfo) -> torch.Tensor:
    """This rank's shard (port layout) of the full port-layout ``full``."""
    logical = info.view.to_logical(full, info.logical_shape)
    return info.view.from_logical(_block(logical, info.spec, info.layout)).contiguous().clone()


class _FSDPGather(nn.Module):
    """Parametrization: the stored FSDP shard -> the tensor-parallel shard
    (all-gather along the FSDP logical dim on use; its backward sums the
    ranks' gradients over the FSDP axis when that axis holds data)."""

    def __init__(self, info: ShardInfo):
        super().__init__()
        self.info = info
        self.group = info.layout.group(info.layout.fsdp_axis)
        self.local_shape = info.local_logical_shape()

    def forward(self, local: torch.Tensor) -> torch.Tensor:
        info = self.info
        logical = info.view.to_logical(local, self.local_shape)
        gather = col.gather_sum_grad if info.fsdp_sums else col.gather_from
        return info.view.from_logical(gather(logical, self.group, info.fsdp_dim))


def _tensors(model: nn.Module):
    """(state-dict name, owning module, attribute name, tensor) for every
    parameter and persistent buffer of ``model`` (a parametrized one's
    stored tensor under its plain name)."""
    out = []
    for mname, mod in model.named_modules():
        if isinstance(mod, parametrize.ParametrizationList):
            continue
        at = f"{mname}." if mname else ""
        for attr, t in list(mod._parameters.items()) + [
                (b, mod._buffers[b]) for b in mod._buffers
                if b not in mod._non_persistent_buffers_set]:
            if t is not None:
                out.append((at + attr, mod, attr, t))
        if parametrize.is_parametrized(mod):
            out += [(at + attr, mod, attr, plist.original)
                    for attr, plist in mod.parametrizations.items()]
    return out


def _infos(model: nn.Module, mesh, model_axis, fsdp_axis, layout=None):
    heads = _head_counts(model)
    out = []
    for name, owner, attr, t in _tensors(model):
        if hasattr(t, "_mcl_shard"):
            out.append((name, owner, attr, t, t._mcl_shard))
            continue
        shape = tuple(t.shape)
        view = _view_of(name, shape, heads.get(name.rsplit(".", 1)[0], 0))
        lshape = view.logical_shape(shape)
        keys = _jax_keys(name, shape)
        info = ShardInfo(lshape, spec_for_leaf(keys, lshape, mesh, model_axis, fsdp_axis), view,
                         layout)
        out.append((name, owner, attr, t, info))
    return out


def param_shardings(model: nn.Module, mesh, model_axis: str = "model",
                    fsdp_axis: Optional[str] = None) -> Dict[str, Tuple]:
    """{state-dict name: spec} for every parameter and persistent buffer
    (one spec entry per JAX logical dimension; see the module docstring)."""
    return {name: info.spec for name, *_, info in _infos(model, mesh, model_axis, fsdp_axis)}


# -- sharding a model -----------------------------------------------------------------


@dataclasses.dataclass
class TP:
    """A module's tensor-parallel role: ``kind`` "col" (output features
    local), "row" (input features local, partial sums all-reduced),
    "vocab" (embedding rows [offset, offset + rows)), "experts" (experts
    [offset, offset + count)); ``group`` the model axis."""

    kind: str
    group: col.AxisGroup
    offset: int = 0
    count: int = 0


@dataclasses.dataclass
class AttentionPlan:
    """One LM attention's heads on this rank.  ``q``/``k``/``v``: "local"
    (whole heads of this rank), "gather" (output columns split mid-head:
    all-gathered to full) or "full" (replicated); ``kv_sel``: the KV heads
    this rank's query heads read from full K/V (None when K/V are local);
    ``o``: "local" (the attention output is o's local input rows),
    "scatter" (a full attention output is split to them), "gather" (local
    heads gathered for a replicated o) or "full"."""

    group: col.AxisGroup
    q: str
    k: str
    kv_sel: Optional[Tuple[int, ...]]
    o: str
    num_heads: int
    num_kv_heads: int


def _model_sharded(info: ShardInfo, dim: int) -> bool:
    d = info.spec[dim] if dim < len(info.spec) else None
    axes = (d,) if isinstance(d, str) else (d or ())
    return info.layout.model_axis in axes


def _attention_plan(attn, infos: Dict[str, ShardInfo], prefix: str,
                    layout: Layout) -> AttentionPlan:
    cfg = attn.full_cfg
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    m, r = layout.sizes[layout.model_axis], layout.coords[layout.model_axis]
    group = layout.group(layout.model_axis)

    def mode(proj, heads):
        info = infos[f"{prefix}.{proj}.weight"] if f"{prefix}.{proj}.weight" in infos else \
            infos[f"{prefix}.{proj}.kernel"]
        if not _model_sharded(info, 1):  # heads of [H, heads, hd], or out of int8 [in, out]
            return "full"
        return "local" if (heads * hd // m) % hd == 0 else "gather"

    q = mode("q_proj", hq)
    k = mode("k_proj", hk)
    o_info = infos.get(f"{prefix}.o_proj.weight") or infos[f"{prefix}.o_proj.kernel"]
    o_sharded = _model_sharded(o_info, 0)
    kv_sel = None
    if q == "local":
        nq, q0 = hq // m, r * (hq // m)
        if k == "local":
            nk = hk // m
        else:
            group_size = hq // hk
            idx = [(q0 + j) // group_size for j in range(nq)]
            uniq = sorted(set(idx))
            per = nq // len(uniq) if nq % len(uniq) == 0 else 0
            regular = per and all(idx[j] == uniq[j // per] for j in range(nq))
            kv_sel = tuple(uniq) if regular else tuple(idx)
            nk = len(kv_sel)
        o = "local" if o_sharded else "gather"
    else:
        nq, nk = hq, hk
        if k == "local":
            k = "gather"
        o = "scatter" if o_sharded else "full"
    return AttentionPlan(group, q, k, kv_sel, o, nq, nk)


def _assign_tp(model: nn.Module, infos: Dict[str, ShardInfo], layout: Layout) -> None:
    """Attach the tensor-parallel plans the modules read (module docstring)."""
    from multimodal_concept_learning_tpu_torch.models.lm import (
        CausalLM,
        LMAttention,
        LMBlock,
        LMMLP,
    )
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.models.vit import ViTLayer
    from multimodal_concept_learning_tpu_torch.ops.moe import MoEMLP

    group = layout.group(layout.model_axis)
    m, r = layout.sizes[layout.model_axis], layout.coords[layout.model_axis]

    def weight_info(prefix):
        for leaf in ("weight", "kernel"):
            if f"{prefix}.{leaf}" in infos:
                return infos[f"{prefix}.{leaf}"]
        raise KeyError(prefix)

    def role(prefix, module, kind, lora=None):
        # a Dense kernel [in, out]: col shards out (dim 1), row shards in (dim 0)
        if _model_sharded(weight_info(prefix), 1 if kind == "col" else 0):
            module._tp = TP(kind, group)
            if lora is not None:
                lora._tp = TP(kind, group)

    local_cfgs = {}
    names = {id(mod): n for n, mod in model.named_modules()}
    for mod in model.modules():
        prefix = names[id(mod)]
        if isinstance(mod, LMAttention):
            plan = _attention_plan(mod, infos, prefix, layout)
            mod._tp = plan
            for proj in ("q_proj", "k_proj", "v_proj"):
                lora = getattr(mod, proj + "_lora", None)
                if (plan.q if proj == "q_proj" else plan.k) in ("local", "gather"):
                    getattr(mod, proj)._tp = TP("col", group)
                    if lora is not None:
                        lora._tp = TP("col", group)
            if plan.o in ("local", "scatter"):
                mod.o_proj._tp = TP("row", group)
                if getattr(mod, "o_proj_lora", None) is not None:
                    mod.o_proj_lora._tp = TP("row", group)
            if mod.cfg.use_qk_norm:
                mod.q_norm._tp_partial = group if plan.q == "local" else None
                mod.k_norm._tp_partial = group if plan.k == "local" else None
            key = (plan.num_heads, plan.num_kv_heads)
            local_cfgs.setdefault(key, dataclasses.replace(
                mod.full_cfg, num_heads=plan.num_heads, num_kv_heads=plan.num_kv_heads))
            mod.cfg = local_cfgs[key]
        elif isinstance(mod, LMMLP):
            for proj in ("gate_proj", "up_proj"):
                role(f"{prefix}.{proj}", getattr(mod, proj), "col",
                     getattr(mod, proj + "_lora", None))
            role(f"{prefix}.down_proj", mod.down_proj, "row", getattr(mod, "down_proj_lora", None))
        elif isinstance(mod, ViTLayer):
            role(f"{prefix}.intermediate.dense", mod.intermediate["dense"], "col")
            role(f"{prefix}.output.dense", mod.output["dense"], "row")
        elif isinstance(mod, MoEMLP):
            info = infos[f"{prefix}.experts_gate"]
            if _model_sharded(info, 0):
                count = mod.num_experts // m
                mod._tp = TP("experts", group, offset=r * count, count=count)
        elif isinstance(mod, CausalLM):
            info = infos[f"{prefix}.model.embed_tokens.weight" if prefix else
                         "model.embed_tokens.weight"]
            if _model_sharded(info, 0):
                rows = info.logical_shape[0] // m
                mod.model.embed_tokens._tp = TP("vocab", group, offset=r * rows, count=rows)
    if len(local_cfgs) > 1:
        raise ValueError(f"LM attention layers disagree on their local heads: {list(local_cfgs)}")
    if local_cfgs:
        (local,) = local_cfgs.values()
        for mod in model.modules():
            if isinstance(mod, (CausalLM, LMBlock)):
                mod.cfg = local
            if isinstance(mod, MLLM):
                mod.cfg = dataclasses.replace(mod.cfg, lm=local)


def shard_params(model: nn.Module, mesh, model_axis: str = "model",
                 fsdp_axis: Optional[str] = None) -> nn.Module:
    """Shard ``model``'s parameters and int8 buffers over ``mesh`` in place
    (the JAX rules; module docstring) and return it.  The batch is striped
    over every axis but ``model_axis``.  Every rank calls it, with the same
    full weights; a model already sharded over the same mesh and axes is
    returned as it is."""
    done = getattr(model, "_mcl_layout", None)
    if done is not None:
        if not (done.mesh is mesh and done.model_axis == model_axis
                and done.fsdp_axis == fsdp_axis):
            raise ValueError("model is already sharded over another mesh or axes")
        return model
    layout = make_layout(mesh, model_axis, fsdp_axis)
    rows = _infos(model, mesh, model_axis, fsdp_axis, layout)
    infos = {name: info for name, *_, info in rows}
    fsdp_reduced = layout.fsdp_on and fsdp_axis in layout.data_axes
    for name, owner, attr, t, info in rows:
        fsdp_dims = [d for d, a in enumerate(info.spec)
                     if a == fsdp_axis or (isinstance(a, tuple) and fsdp_axis in a)]
        info.fsdp_dim = fsdp_dims[0] if fsdp_dims and layout.fsdp_on else None
        info.fsdp_sums = fsdp_reduced
        info.reduce_axes = tuple(a for a in layout.data_axes
                                 if not (info.fsdp_dim is not None and fsdp_reduced
                                         and a == fsdp_axis))
        with torch.no_grad():
            local = shard_tensor(t.detach(), info)
        if isinstance(t, nn.Parameter):
            new = nn.Parameter(local, requires_grad=t.requires_grad)
            owner._parameters[attr] = new
        else:
            new = local
            owner._buffers[attr] = new
        new._mcl_shard = info
        if info.fsdp_dim is not None:
            parametrize.register_parametrization(owner, attr, _FSDPGather(info), unsafe=True)
    model._mcl_layout = layout
    if layout.tp_on:
        _assign_tp(model, infos, layout)
    return model


def layout_of(model: nn.Module) -> Optional[Layout]:
    return getattr(model, "_mcl_layout", None)


def local_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{state-dict name: this rank's stored shard} of a sharded model."""
    return {name: t for name, _, _, t in _tensors(model)}


def gather_full(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor (``_mcl_shard``) at its full port-layout shape, on
    every rank (no gradient); any other tensor as it is."""
    info = getattr(t, "_mcl_shard", None)
    if info is None:
        return t.detach()
    local = info.view.to_logical(t.detach(), info.local_logical_shape())
    for d, axes in enumerate(info.spec):
        if axes:
            local = col.all_gather(local.contiguous(), info.layout.group(axes), d)
    return info.view.from_logical(local).contiguous()


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full (unsharded) state dict of a sharded model, on every rank."""
    return {name: gather_full(t) for name, t in local_tensors(model).items()}


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Copy a full state dict onto a sharded model's shards (strict)."""
    mine = local_tensors(model)
    if set(mine) != set(state_dict):
        raise KeyError(f"state dict keys differ: missing {sorted(set(mine) - set(state_dict))}, "
                       f"unexpected {sorted(set(state_dict) - set(mine))}")
    for name, t in mine.items():
        info = getattr(t, "_mcl_shard", None)
        src = state_dict[name].to(t.device, t.dtype)
        t.copy_(shard_tensor(src, info) if info is not None else src)


__all__ = ["AttentionPlan", "Layout", "ShardInfo", "TP", "axis_sizes", "canonical_name",
           "full_state_dict", "gather_full", "layout_of", "load_full_state_dict",
           "local_tensors", "make_layout", "mllm_param_spec", "param_shardings",
           "shard_params", "shard_tensor", "spec_for_leaf"]
