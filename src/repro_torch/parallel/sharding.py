"""Sharding rules: map every parameter / cache / batch leaf to a partition
spec, as the reference's ``repro/parallel/sharding.py``.

Axes:
  "data"  — batch + FSDP (ZeRO-style parameter/optimizer sharding)
  "model" — tensor parallel (heads / d_ff / experts / vocab) and
            sequence-parallel decode caches (context parallelism)
  "pod"   — multi-pod extension of the data axis

Rules are keyed by leaf *name*; stacked layer segments add one leading layer
axis which is handled generically (rank = rule rank + 1 -> prepend None).
Any axis whose dimension is not divisible by the mesh extent is dropped
(replicated), so one rule table works across all 10 archs.

The rules run on a mesh *description* (``MeshDesc``: axis names and
sizes), so they can be evaluated for the 16x16 and 2x16x16 production
meshes without their processes; a ``torch.distributed`` ``DeviceMesh``
with named dims reads the same. ``to_placements`` maps a spec onto a real
``DeviceMesh`` as ``torch.distributed.tensor`` placements, and
``distribute_tree`` / ``from_local_tree`` / ``local_tree`` /
``gather_tree`` / ``spec_tree`` move whole trees between full tensors,
``DTensor``s and their local blocks.

``hint`` and ``maybe_shard`` are the reference's sharding constraints:
under an active mesh (``use_mesh``) they place a ``DTensor`` on it by
their spec (a redistribute, which changes no value); without a mesh, and
for any other tensor, they are the identity. The port's model code calls
neither. Its activations are plain tensors, each data shard's whole on
every rank of "model", and the work that splits over "model" is written
out with the collectives of ``parallel.comm`` where the reference put its
constraints (``repro/models``): the heads of attention (``attention.py``
:56-58, 83, 148-149) and of MLA (``mla.py``:43, 62-64), the channels of
the SSM (``ssm.py``:97-98, 114), each running its hand-written kernel on
its rank's part, the d_ff of the MLPs (``mlp.py``:28-34) and the experts
of the MoE block (``moe.py``:189-201). The reference's remaining sites
(``common.py``:157 the logits, ``xlstm.py``:81-82, ``lm.py``:139, 289,
304 the residual stream, and its sequence-sharded variant) only place
data that the port keeps whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names (the
    dim split over their product), or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    """A mesh's axis names and sizes, without devices or processes."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def describe(mesh) -> MeshDesc:
    """The ``MeshDesc`` of a description or of a ``DeviceMesh`` with named
    dims."""
    if isinstance(mesh, MeshDesc):
        return mesh
    return MeshDesc(tuple(mesh.mesh_dim_names),
                    tuple(int(s) for s in mesh.shape))


# rule tables: leaf name -> per-dim axis names (before the stacked-layer dim).
# "D" = data/FSDP axis, "M" = model/TP axis, None = replicated.
_PARAM_RULES: Dict[str, Tuple] = {
    # embeddings / heads
    "embed": ("M", "D"),          # (V, d) vocab-parallel; audio (nq,V,d) handled by rank pad
    "head": ("D", "M"),
    "heads": (None, "D", "M"),
    "meta": (None, None),
    # attention
    "wq": ("D", "M", None),
    "wk": ("D", "M", None),
    "wv": ("D", "M", None),
    "wo": ("M", None, "D"),
    "q_norm": (None,), "k_norm": (None,),
    # mlp
    "wg": ("D", "M"), "wu": ("D", "M"), "wi": ("D", "M"), "wd": ("M", "D"),
    # moe
    "router": ("D", None), "bias": (None,),
    # mla
    "w_dq": ("D", "M"), "w_uq": ("D", "M", None),
    "w_dkv": ("D", "M"), "w_kr": ("D", None),
    "w_uk": ("D", "M", None), "w_uv": ("D", "M", None),
    # ssm
    "w_in": ("D", "M"), "conv_w": (None, "M"), "conv_b": ("M",),
    "w_dt1": ("M", None), "w_dt2": (None, "M"),
    "w_B": ("M", None), "w_C": ("M", None),
    "A_log": ("M", None), "D": ("M",), "b_dt": ("M",),
    "w_out": ("M", "D"),
    # xlstm
    "w_up": ("D", "M"), "w_z": ("D", "M"),
    "w_if": ("M", None), "b_if": (None,),
    "r_g": (None, "M", None), "w_g": ("D", "M"), "b_g": (None,),
    "w_down": ("M", "D"),
    # multimodal
    "w1": (None, "M"), "w2": ("M", "D"),
    "cond_proj": (None, "M"),
    "proj": ("D", "M"),
    # mixers / norms (1-D handled by fallback too)
    "mix_a": (None,), "mix_s": (None,),
}

# MoE expert tensors override the generic mlp names when under a "moe" subtree:
_MOE_RULES: Dict[str, Tuple] = {
    "wg": ("M", "D", None),       # (E, d, f): experts -> EP on model axis
    "wu": ("M", "D", None),
    "wd": ("M", None, "D"),
}


def _axis(mesh, tag):
    """Map rule tag to mesh axis name(s)."""
    if tag == "D":
        return ("pod", "data") if "pod" in mesh.axis_names else "data"
    if tag == "M":
        return "model"
    if tag == "E":      # expert dim: spread over model x data (full EP)
        return ("model", "data")
    return None


def _extent(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh.shape
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def _on(mesh, axis) -> bool:
    """Whether ``mesh`` has every axis of ``axis``."""
    return all(a in mesh.axis_names for a in _entry_axes(axis))


def _spec_for(mesh, rule: Tuple, shape: Tuple[int, ...]) -> PartitionSpec:
    """The rule's axes on each dim they divide; an axis the mesh lacks (a
    data-only mesh has no "model") leaves its dim replicated."""
    if len(shape) == len(rule) + 1:          # stacked layer segment
        rule = (None,) + rule
    if len(shape) != len(rule):
        rule = (None,) * len(shape)
    out = []
    for dim, tag in zip(shape, rule):
        ax = _axis(mesh, tag)
        if ax is not None and _on(mesh, ax) and dim % _extent(mesh, ax) == 0 \
                and dim > 0:
            out.append(ax)
        elif tag == "E" and _on(mesh, "model") \
                and dim % mesh.shape["model"] == 0 and dim > 0:
            out.append("model")           # fewer experts than chips: EP=TP
        else:
            out.append(None)
    return P(*out)


# ---------------------------------------------------------------------------
# trees: nested dicts, tuples and lists, walked in the reference's leaf
# order (dict keys sorted, as jax.tree_util flattens them)
# ---------------------------------------------------------------------------


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, tuple, list)) or isinstance(
        x, PartitionSpec)


def flatten_with_path(tree, path: Tuple = ()):
    """[(path, leaf)], a path being the dict keys and sequence indices
    from the root, in leaf order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_path(tree[k], path + (k,))]
    if not _is_leaf(tree):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def map_with_path(fn, tree, path: Tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if not _is_leaf(tree):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def map_tree(fn, *trees):
    """``fn`` over the matching leaves of trees of one structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: map_tree(fn, *(x[k] for x in trees)) for k in sorted(t)}
    if not _is_leaf(t):
        return type(t)(map_tree(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def param_pspec_tree(mesh, params_shapes, mode: str = "train") -> Any:
    """Partition-spec tree for a params tree (of tensors, meta tensors or
    anything with ``.shape``).

    mode="train": FSDP ("D" tags shard over data) + TP.
    mode="infer": replicate over data, shard over model only — serving has
    no optimizer state, so ZeRO-style gathering is pure collective waste."""
    mesh = describe(mesh)

    def one(path, leaf):
        keys = [k for k in path if isinstance(k, str)]
        name = keys[-1] if keys else None
        in_moe = "moe" in keys[:-1] or "shared" in keys[:-1]
        expert = in_moe and name in _MOE_RULES and "shared" not in keys[:-1]
        if expert:
            rule = _MOE_RULES[name]
        elif name in _PARAM_RULES:
            rule = _PARAM_RULES[name]
        else:
            rule = (None,) * len(leaf.shape)
        if mode == "infer":
            rule = tuple(None if t == "D" else t for t in rule)
            if expert:
                # replicating 100s-of-GB expert tables over "data" would
                # blow HBM: spread the expert dim over model x data instead
                rule = ("E",) + rule[1:]
        return _spec_for(mesh, rule, tuple(leaf.shape))

    return map_with_path(one, params_shapes)


# ---------------------------------------------------------------------------
# batch / cache / optimizer specs
# ---------------------------------------------------------------------------


def batch_pspec_tree(mesh, batch_shapes) -> Any:
    mesh = describe(mesh)
    d = _axis(mesh, "D")

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % _extent(mesh, d) == 0:
            spec[0] = d
        return P(*spec)

    return map_tree(one, batch_shapes)


def cache_pspec_tree(mesh, cache_shapes, cfg) -> Any:
    """Decode caches: batch on data; long sequence dims on model
    (sequence-parallel / context-parallel decode); feature dims on model
    where divisible. A leaf that is not a tensor (``cache["pos"]``, a
    Python int in the port) takes the spec of a 0-d one."""
    mesh = describe(mesh)
    m = _axis(mesh, "M")
    d = _axis(mesh, "D")

    def one(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        spec = [None] * len(shape)
        is_int32 = getattr(leaf, "dtype", None) == torch.int32
        if len(shape) == 0 or is_int32 and len(shape) <= 2:
            return P(*spec)
        # leading dims: (Ls, B, ...) — layer axis replicated, batch on data
        if len(shape) >= 2 and shape[1] % _extent(mesh, d) == 0:
            spec[1] = d
        # sequence-parallel: big 3rd dim (cache length) on model
        if len(shape) >= 3 and shape[2] >= 4096 \
                and shape[2] % _extent(mesh, m) == 0:
            spec[2] = m
        elif len(shape) >= 3:
            # feature dims on model if divisible (ssm di, xlstm dh, latent r)
            for i in range(2, len(shape)):
                if shape[i] % _extent(mesh, m) == 0 \
                        and shape[i] >= 2 * _extent(mesh, m):
                    spec[i] = m
                    break
        return P(*spec)

    return map_with_path(one, cache_shapes)


def opt_pspec_tree(mesh, params_shapes, opt_shapes) -> Any:
    """Optimizer-state specs mirror parameter specs (ZeRO via FSDP axis).

    Handles the int8-quantized moment layout {"q": ..., "scale": ...} where
    the scale drops the last (reduced) axis."""
    pspecs = dict(flatten_with_path(param_pspec_tree(mesh, params_shapes)))

    def build(moments):
        def one(path, leaf):
            if path and path[-1] in ("q", "scale"):
                base = pspecs.get(path[:-1], P())
                if path[-1] == "scale":
                    return (P(*(list(base) + [None]))
                            if len(base) < len(leaf.shape) else
                            P(*(list(base)[:-1] + [None])))
                return base
            return pspecs.get(path, P())
        return map_with_path(one, moments)

    return {"m": build(opt_shapes["m"]), "v": build(opt_shapes["v"]),
            "count": P()}


# ---------------------------------------------------------------------------
# specs on a real mesh
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(mesh, spec: PartitionSpec):
    """``spec`` as ``torch.distributed.tensor`` placements on the
    ``DeviceMesh`` ``mesh``: per mesh dim, ``Shard(d)`` for the tensor dim
    ``d`` whose entry names that axis, else ``Replicate()``. An entry of
    several axes (``("pod", "data")``) shards its dim on each, the first
    axis outermost, as a ``NamedSharding`` splits it."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for ax in _entry_axes(entry):
            if ax in names:
                out[names.index(ax)] = Shard(dim)
    return out


def local_block(mesh, spec: PartitionSpec, full: torch.Tensor):
    """This rank's block of ``full`` under ``spec`` on ``mesh`` (a view):
    each dim split over the product of its entry's axes, the first axis
    outermost."""
    names = tuple(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        axes = [a for a in _entry_axes(entry) if a in names]
        n = math.prod(mesh.size(names.index(a)) for a in axes)
        if n == 1:
            continue
        r = 0
        for a in axes:
            r = r * mesh.size(names.index(a)) + mesh.get_local_rank(a)
        w = full.shape[dim] // n
        full = full.narrow(dim, r * w, w)
    return full


def _global_shape(mesh, spec: PartitionSpec, local: torch.Tensor):
    names = tuple(mesh.mesh_dim_names)
    shape = list(local.shape)
    for dim, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if a in names:
                shape[dim] *= mesh.size(names.index(a))
    return torch.Size(shape)


@dataclasses.dataclass
class LocalBlock:
    """What a ``DTensor`` is on a ``comm.RecordingMesh`` (the dry run): a
    rank's block ``local`` of a tensor placed by ``spec``."""
    local: torch.Tensor
    spec: PartitionSpec
    device_mesh: Any

    def to_local(self) -> torch.Tensor:
        return self.local


def from_local_tree(mesh, tree, specs):
    """``DTensor``s of the ranks' local blocks (no collective);
    ``LocalBlock``s on a ``comm.RecordingMesh``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.comm import RecordingMesh
    if isinstance(mesh, RecordingMesh):
        return map_tree(lambda t, s: LocalBlock(t, s, mesh), tree, specs)

    def one(t, s):
        shape = _global_shape(mesh, s, t)
        return DTensor.from_local(t, mesh, to_placements(mesh, s),
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())
    return map_tree(one, tree, specs)


def distribute_tree(mesh, tree, specs):
    """Every leaf of ``tree`` as a ``DTensor`` placed by its spec. Every
    rank passes the same full tree and keeps a copy of its block (no
    collective), so the full tensors can be freed."""
    return from_local_tree(mesh, map_tree(
        lambda t, s: local_block(mesh, s, t).clone(), tree, specs), specs)


def local_tree(tree):
    """The rank's local blocks of a tree of ``DTensor``s."""
    return map_tree(lambda t: t.to_local(), tree)


def full_tensor(t) -> torch.Tensor:
    """The full tensor of the ``DTensor`` (or ``LocalBlock``) ``t``,
    gathered with blocking all-gathers (``comm.all_gather``), the innermost
    mesh dim first (a collective: every rank calls it).
    ``DTensor.full_tensor`` returns before its gather is done, and its
    result must not meet a collective of this process first."""
    from repro_torch.parallel import comm
    x, mesh = t.to_local(), t.device_mesh
    names = tuple(mesh.mesh_dim_names)
    spec = spec_tree(t)
    for axis in reversed(names):
        for dim, entry in enumerate(spec):
            if axis in _entry_axes(entry):
                x = comm.all_gather(x, dim, axis, mesh)
    return x


def gather_tree(tree):
    """The full tensors of a tree of ``DTensor``s (a collective: every rank
    calls it)."""
    return map_tree(full_tensor, tree)


def spec_tree(tree):
    """The partition specs of a tree of ``DTensor``s (or ``LocalBlock``s),
    read back from their placements and mesh dim names."""
    from torch.distributed.tensor import Shard

    def one(t):
        if isinstance(t, LocalBlock):
            return t.spec
        names = t.device_mesh.mesh_dim_names
        entries = [[] for _ in range(t.dim())]
        for name, pl in zip(names, t.placements):
            if isinstance(pl, Shard):
                entries[pl.dim].append(name)
        return P(*(None if not e else e[0] if len(e) == 1 else tuple(e)
                   for e in entries))
    return map_tree(one, tree)


# ---------------------------------------------------------------------------
# the active mesh and the model code's constraints
# ---------------------------------------------------------------------------

# the active meshes, innermost last: one list for the process, not a
# context variable or a thread-local, because the autograd engine runs a
# CUDA backward, and the recomputation of the layers that remat
# checkpointed, on threads of its own, which must see the mesh that the
# forward saw
_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` with named dims) the active mesh for
    the block, the counterpart of the reference's ``with mesh:``."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh():
    return _ACTIVE[-1] if _ACTIVE else None


def _keep(entry, names):
    if isinstance(entry, tuple):
        kept = tuple(a for a in entry if a in names)
        return kept or None
    return entry if entry in names else None


def constraint_spec(mesh, spec: PartitionSpec) -> PartitionSpec:
    """``spec`` with the entries naming axes that ``mesh`` lacks dropped
    (replicated): what ``maybe_shard`` pins."""
    names = set(describe(mesh).axis_names)
    return P(*(_keep(e, names) if e is not None else None for e in spec))


def _place(x, mesh, spec):
    """``x`` redistributed to ``spec`` when it is a ``DTensor`` on ``mesh``;
    any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    if spec is None or not isinstance(x, DTensor) or x.device_mesh != mesh:
        return x
    return x.redistribute(mesh, to_placements(mesh, spec))


def maybe_shard(x, spec: PartitionSpec):
    """``x`` placed by ``spec`` (``constraint_spec``: the axes the active
    mesh lacks dropped) when it is a ``DTensor`` on the active mesh; the
    identity without a mesh and for any other tensor."""
    mesh = current_mesh()
    return x if mesh is None else _place(x, mesh,
                                         constraint_spec(mesh, spec))


def hint_spec(mesh, shape: Sequence[int], *tags) -> Optional[PartitionSpec]:
    """The spec ``hint`` gives a tensor of ``shape``: each tag's axes, or
    None where the dim does not divide (None for a rank mismatch)."""
    if len(tags) != len(shape):
        return None
    mesh = describe(mesh)
    spec = []
    for dim, tag in zip(shape, tags):
        ax = _axis(mesh, tag)
        if ax is not None and _on(mesh, ax) \
                and dim % _extent(mesh, ax) == 0 and dim > 0:
            spec.append(ax)
        else:
            spec.append(None)
    return P(*spec)


def hint(x, *tags):
    """Sharding hint with symbolic tags: "D" (batch/FSDP axes), "M"
    (model), None. ``x`` placed by ``hint_spec`` (tags on dims that do not
    divide dropped) when it is a ``DTensor`` on the active mesh; the
    identity without a mesh and for any other tensor."""
    mesh = current_mesh()
    return x if mesh is None else _place(x, mesh,
                                         hint_spec(mesh, x.shape, *tags))
