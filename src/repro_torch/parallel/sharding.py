"""Sharding policies: logical param/activation axes -> mesh axes (port of
``repro.parallel.sharding``).

The model layer annotates every parameter with *logical* axis names
("embed", "ffn", "heads", "vocab", "experts", ...).  A ``Policy`` maps those
to mesh axes under the constraint that a mesh axis is used at most once per
tensor, with priority:

  1. "experts" -> the EP axis ("data"), expert parallelism,
  2. TP dims ("vocab"/"ffn"/"heads"/"inner") -> "model",
  3. "embed" -> the FSDP axes (param and optimizer-state sharding over
     "data" (+"pod")) when the policy enables it and the axis is free.

Per-arch policies: small and medium archs replicate over DP (DP+TP+EP);
jamba-398B and phi3.5-42b enable FSDP.  Optimizer state can be sharded
over DP (ZeRO-1) independently of the param policy.

A spec is a ``PartitionSpec``: a tuple with one entry a tensor dim, each a
mesh-axis name, a tuple of names or ``None``.  The policy reads only a
mesh's ``axis_names`` and ``shape`` (``launch.mesh.ModelMesh``, or any
object with both), so every mesh shape can be reasoned about without its
devices.

Placement.  On a ``ModelMesh`` with a ``device_mesh`` (a process group
exists), a spec becomes DTensor placements (``to_placements``: a dim named
by a mesh axis is ``Shard(dim)`` on that mesh dim, a tuple of axes shards
the dim over several mesh dims in mesh order, the rest, and any mesh dim
of size 1, ``Replicate()``);
``place`` / ``place_tree`` distribute tensors by specs, and
``make_constraint_fn``'s ``cs(x, kind)`` redistributes a DTensor to its
fitted activation spec (the reference's ``with_sharding_constraint``).
Without a ``device_mesh`` the tensors are plain and ``cs`` is the
identity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.launch.mesh import INDEX_AXIS, dp_axes, dp_size

TP_LOGICAL = ("vocab", "ffn", "heads", "inner")


class PartitionSpec(tuple):
    """Mesh axes a tensor's dims shard over: ``P("data", None)``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def mesh_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.axis_names)


# ---------------------------------------------------------------------------
# The mesh-distributed index ("index" axis): specs for core.mesh_index
# ---------------------------------------------------------------------------
#
# The distributed skiplist is not a model tensor: its leaves all carry a
# leading per-device axis and its batches split along the same axis, so
# the specs are fixed rather than policy-derived.

def index_state_spec() -> P:
    """Spec for the stacked index tree: leading [D] axis per leaf."""
    return P(INDEX_AXIS)


def index_batch_spec() -> P:
    """Spec for a [D * C] lane batch, split into per-device [C] chunks."""
    return P(INDEX_AXIS)


def index_replicated_spec() -> P:
    """Spec for globally replicated values (e.g. device_boundaries)."""
    return P()


def index_state_sharding(mesh, tree):
    """A spec a leaf of an index tree (dicts, lists, named tuples)."""
    return _map(lambda _: index_state_spec(), tree)


def _map(fn, tree, *rest, is_leaf=lambda x: False):
    """``fn`` over the leaves of trees of one structure."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


@dataclasses.dataclass(frozen=True)
class Policy:
    tp_axis: str = "model"
    ep_axis: str = "data"
    fsdp: bool = False              # shard "embed" dims over DP axes
    zero1: bool = True              # optimizer state sharded over DP axes
    # MoE distribution mode:
    #   "ep_a2a"  experts over EP axis, grouped all-to-all dispatch,
    #             expert ffn dim over TP (row-parallel all-reduce cost);
    #   "ep_ctp"  experts over EP, *capacity* over TP (no TP all-reduce;
    #             expert weights replicated over TP, which must fit);
    #   "dp"      experts fully replicated, tokens never move (best when
    #             expert weights are tiny beside the token volume).
    moe_mode: str = "ep_a2a"

    # ---- parameters -------------------------------------------------------

    def param_spec(self, axes: Tuple[Optional[str], ...], mesh,
                   shape: Tuple[int, ...] = None, *,
                   force_fsdp: bool = False) -> P:
        names = list(mesh.axis_names)
        dps = dp_axes(mesh)
        used = set()
        out = [None] * len(axes)

        def assign(i, mesh_ax):
            if mesh_ax is None or mesh_ax in used or mesh_ax not in names:
                return
            if shape is not None and shape[i] % _axsize(mesh, mesh_ax) != 0:
                return
            out[i] = mesh_ax
            used.add(mesh_ax)

        is_expert_tensor = "experts" in axes
        # pass 1: experts -> EP (unless DP-replicated MoE)
        if self.moe_mode != "dp":
            for i, a in enumerate(axes):
                if a == "experts":
                    assign(i, self.ep_axis)
        # pass 2: TP dims.  Expert tensors skip TP under "ep_ctp" (capacity
        # is TP-sharded instead, weights replicated over TP) and "dp".
        skip_tp = is_expert_tensor and self.moe_mode in ("ep_ctp", "dp")
        for i, a in enumerate(axes):
            if a in TP_LOGICAL and out[i] is None and not skip_tp:
                assign(i, self.tp_axis)
        # pass 2b: row-parallel fallback: if TP could not be placed (e.g.
        # 56 heads % 16 != 0), shard the "embed" (contraction) dim over the
        # TP axis instead, only for tensors too large to replicate (>= 32
        # MiB in bf16): a row-parallel backward all-gathers its grad_x.
        big = shape is None or math.prod(shape) * 2 >= 32 * 1024 * 1024
        if self.tp_axis not in used and len(axes) >= 2 and big:
            for i, a in enumerate(axes):
                if a == "embed" and out[i] is None:
                    assign(i, self.tp_axis)
                    break
        # pass 3: FSDP on "embed"
        if self.fsdp or force_fsdp:
            for i, a in enumerate(axes):
                if a == "embed" and out[i] is None:
                    free = tuple(ax for ax in dps if ax not in used)
                    if free and (shape is None
                                 or shape[i] % _prod(mesh, free) == 0):
                        out[i] = free if len(free) > 1 else free[0]
                        used.update(free)
                    break
        return P(*out)

    def param_sharding_tree(self, logical_axes_tree, abstract_tree, mesh, *,
                            force_fsdp: bool = False):
        """A spec tree parallel to the params tree."""
        return _map(lambda ax, ab: self.param_spec(
            ax, mesh, tuple(ab.shape), force_fsdp=force_fsdp),
            logical_axes_tree, abstract_tree, is_leaf=_is_axes)

    def opt_sharding_tree(self, logical_axes_tree, abstract_tree, mesh):
        """ZeRO-1: optimizer moments additionally sharded over DP axes."""
        return self.param_sharding_tree(logical_axes_tree, abstract_tree,
                                        mesh, force_fsdp=self.zero1)

    # ---- activations ------------------------------------------------------

    def batch_axes(self, mesh, global_batch: int):
        dps = dp_axes(mesh)
        if dps and global_batch % dp_size(mesh) == 0:
            return dps if len(dps) > 1 else dps[0]
        return None

    # Sequence parallelism for the residual stream (the seq dim of [B,S,d]
    # over TP between blocks); off, as the reference's measurements chose.
    seq_parallel: bool = False

    def act_spec(self, kind: str, mesh, global_batch: int) -> P:
        b = self.batch_axes(mesh, global_batch)
        if kind == "btd":            # [B, S, d]
            s = self.tp_axis if self.seq_parallel else None
            return P(b, s, None)
        if kind == "b1d":
            return P(b, None, None)
        if kind == "btv":            # logits
            return P(b, None, self.tp_axis)
        if kind == "bt":             # tokens / labels
            return P(b, None)
        if kind == "bpd":            # stub frontend embeddings
            return P(b, None, None)
        if kind == "b":
            return P(b)
        if kind == "gtd":            # grouped tokens [G, Tg, d] -> DP
            return P(b, None, None)
        if kind == "gecd_dp":        # dispatch buffers, group-sharded
            return P(b, None, None, None)
        if kind == "gecd_ep":        # dispatch buffers, expert-sharded
            if self.moe_mode == "dp":
                return P(b, None, self.tp_axis, None)
            if self.moe_mode == "ep_ctp":
                return P(None, self.ep_axis, self.tp_axis, None)
            return P(None, self.ep_axis, None, None)
        if kind == "gecf":           # expert hidden [G,E,C,f]
            if self.moe_mode == "dp":
                return P(b, None, self.tp_axis, None)
            if self.moe_mode == "ep_ctp":
                return P(None, self.ep_axis, self.tp_axis, None)
            return P(None, self.ep_axis, None, self.tp_axis)
        raise ValueError(kind)

    def cache_seq_axes(self, mesh, global_batch: int):
        """Axes for the KV-cache sequence dim: whatever DP doesn't use,
        always including the TP axis (the decode combine runs there)."""
        b = self.batch_axes(mesh, global_batch)
        used = set(b if isinstance(b, tuple) else ([b] if b else []))
        return tuple(a for a in mesh.axis_names if a not in used)

    def cache_spec_tree(self, cache_abstract, mesh, global_batch: int):
        """Specs for the serve cache tree (shape-keyed heuristics)."""
        b = self.batch_axes(mesh, global_batch)
        seq = self.cache_seq_axes(mesh, global_batch)

        def fit(spec, shape):
            """Drop entries whose mesh-axis size doesn't divide the dim."""
            return P(*(ax if ax is None or shape[i] % _axsize(mesh, ax) == 0
                       else None for i, ax in enumerate(spec)))

        def spec_for(path, leaf):
            name = path[-1] if path else ""
            nd = len(leaf.shape)
            if name == "len":
                return P(None, b)                       # [reps, B]
            if name == "pos":
                return P(b)                             # [B]
            if name == "enc_out":
                return P(b, None, None)                 # [B, F, d]
            if name in ("k", "v"):                      # [reps,B,S,kvH,dh]
                s = seq if len(seq) > 1 else (seq[0] if seq else None)
                return fit(P(None, b, s, None, None), leaf.shape)
            if name == "h":                             # [reps,B,di,N]
                return fit(P(None, b, self.tp_axis, None), leaf.shape)
            if name == "conv":                          # [reps,B,K,di]
                return fit(P(None, b, None, self.tp_axis), leaf.shape)
            if name == "wkv":                           # [reps,B,H,D,D]
                return fit(P(None, b, self.tp_axis, None, None), leaf.shape)
            if name == "shift":                         # [reps,B,1,d]
                return fit(P(None, b, None, None), leaf.shape)
            return P(*([None] * nd))

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                t = [walk(v, path) for v in tree]
                return type(tree)(t) if not isinstance(tree, list) else t
            return spec_for(path, tree)

        return walk(cache_abstract, ())


def _axsize(mesh, ax) -> int:
    if isinstance(ax, tuple):
        return _prod(mesh, ax)
    return mesh.shape[ax]


def _prod(mesh, axs) -> int:
    out = 1
    for a in axs:
        out *= mesh.shape[a]
    return out


def fitted_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """``spec`` with the entries whose mesh-axis size does not divide the
    dim (or past the tensor's rank) dropped."""
    return P(*(ax if ax is not None and i < len(shape)
               and shape[i] % _axsize(mesh, ax) == 0 else None
               for i, ax in enumerate(spec)))


def to_placements(spec: P, device_mesh) -> list:
    """DTensor placements of ``spec`` on ``device_mesh`` (its
    ``mesh_dim_names`` are the axis names): ``Shard(dim)`` on each mesh dim
    named for tensor dim ``dim`` (a tuple entry names several, which split
    the dim in mesh order, as the reference's ``P(("pod", "data"))``
    does), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            # a split over one device is no split
            if a is not None and device_mesh.size(names.index(a)) > 1:
                out[names.index(a)] = Shard(dim)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole(placements) -> list:
    """``placements`` with each partial sum reduced (``Replicate``)."""
    from torch.distributed.tensor import Partial, Replicate
    return [Replicate() if isinstance(p, Partial) else p for p in placements]


def on_shards(fn, out, ins, device_mesh, grads=None):
    """``fn``, a function of local tensors, as one of DTensors
    (``local_map``): each input is redistributed to its placements in
    ``ins``, ``fn`` runs on the rank's shards, its outputs are laid out as
    ``out``, and the inputs' gradients as ``grads`` (default: as ``ins``).
    Every op of the model plane that DTensor has no strategy for, or
    would run by gathering, goes through here with its layout stated."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads, device_mesh=device_mesh,
                     redistribute_inputs=True)


def _aligned_dim(shape_in, dim: int, shape_out, k: int):
    """The dim of ``shape_out`` that a split of ``shape_in``'s ``dim`` into
    ``k`` even parts stays, a split into ``k`` even parts, under a reshape;
    ``None`` where there is none.  It exists where some output dim starts
    at the same flat offset as ``dim`` (equal products of the dims before)
    and both sizes divide by ``k``: each part is then one contiguous run of
    the trailing flat index on both sides."""
    if shape_in[dim] % k:
        return None
    before = math.prod(shape_in[:dim])
    for d, n in enumerate(shape_out):
        if math.prod(shape_out[:d]) == before and n % k == 0:
            return d
    return None


def reshape_placements(t, shape):
    """How DTensor ``t`` reshapes to ``shape`` on local shards: (the
    placements ``t`` must have first, the result's).  A split that stays
    aligned with the new shape (``_aligned_dim``) is kept; a split that
    does not (8 kv heads of a dim split 16 ways) is gathered: its mesh dims
    become ``Replicate`` in the first list, the one collective a reshape
    may cost.  A partial sum stays one (a reshape is linear)."""
    from torch.distributed.tensor import Replicate, Shard
    src, dst = list(t.placements), list(t.placements)
    dims = {p.dim for p in src if isinstance(p, Shard)}
    for dim in dims:
        ms = [m for m, p in enumerate(src) if p == Shard(dim)]
        k = math.prod(t.device_mesh.size(m) for m in ms)
        d = _aligned_dim(tuple(t.shape), dim, tuple(shape), k)
        for m in ms:
            src[m] = Replicate() if d is None else src[m]
            dst[m] = Replicate() if d is None else Shard(d)
    return src, dst


def place(t, spec: P, mesh):
    """``t`` laid out by ``spec`` on ``mesh.device_mesh``: a DTensor is
    redistributed (the reference's jit resharding an argument to its
    ``in_shardings``); a plain tensor, the same whole tensor on every
    rank, becomes a DTensor of which each rank keeps its shard (no
    communication).  ``t`` itself on a mesh without a ``device_mesh``."""
    dm = getattr(mesh, "device_mesh", None)
    if dm is None:
        return t
    placements = to_placements(fitted_spec(spec, tuple(t.shape), mesh), dm)
    if is_dtensor(t):
        return t.redistribute(dm, placements)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, dm, placements, src_data_rank=None)


def place_tree(tree, spec_tree, mesh):
    """``place`` over the leaves of ``tree`` (dicts, lists, named tuples)
    with the specs of ``spec_tree`` at the same positions."""
    return _map(lambda t, spec: place(t, spec, mesh), tree, spec_tree)


def zeros_tree(abstract_tree, spec_tree, mesh, device=None):
    """Zeros shaped as ``abstract_tree``'s leaves: DTensors laid out by
    ``spec_tree`` on ``mesh.device_mesh`` (each rank allocates only its
    shard), or plain tensors on ``device`` without one."""
    dm = getattr(mesh, "device_mesh", None)

    def zeros(ab, spec):
        shape = tuple(ab.shape)
        if dm is None:
            return torch.zeros(shape, dtype=ab.dtype, device=device)
        from torch.distributed.tensor import zeros as dzeros
        return dzeros(shape, dtype=ab.dtype, device_mesh=dm,
                      placements=to_placements(
                          fitted_spec(spec, shape, mesh), dm))
    return _map(zeros, abstract_tree, spec_tree)


def _all_to_all(x, m: int, src: int, dst: int):
    """DTensor ``x`` split along dim ``src`` on mesh dim ``m``, split along
    ``dst`` there instead: one all-to-all over the mesh dim's group (each
    rank sends its block of every other rank's ``dst`` slice)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Shard
    dm = x.device_mesh
    k, group = dm.size(m), dm.get_group(m)

    def local(t):
        chunks = [c.contiguous() for c in t.chunk(k, dim=dst)]
        send = torch.cat([c.reshape(-1) for c in chunks])
        recv = funcol.all_to_all_single_autograd(send, None, None, group)
        recv = funcol.wait_tensor(recv)
        return torch.cat([r.reshape(chunks[0].shape)
                          for r in recv.chunk(k)], dim=src)

    out = list(x.placements)
    out[m] = Shard(dst)
    return on_shards(local, out, (list(x.placements),), dm)(x)


def redistribute(x, placements):
    """``x.redistribute`` to ``placements``, a move of a split from one
    tensor dim to another on the same mesh dim taken as an all-to-all
    (the MoE dispatch's reshards; DTensor's own takes an all-gather on a
    CPU mesh)."""
    from torch.distributed.tensor import Shard
    for m, (cur, tgt) in enumerate(zip(x.placements, placements)):
        if (isinstance(cur, Shard) and isinstance(tgt, Shard)
                and cur.dim != tgt.dim):
            x = _all_to_all(x, m, cur.dim, tgt.dim)
    return x.redistribute(x.device_mesh, placements)


def make_constraint_fn(policy: Policy, mesh, global_batch: int):
    """The ``cs(x, kind)`` hook threaded through model code.

    Shape-aware: spec entries whose mesh-axis size does not divide the dim
    are dropped (e.g. 32 MoE experts on a 16-wide EP axis still shard; 6
    experts would not); ``cs.spec(x, kind)`` is that fitted spec.  On a
    mesh with a ``device_mesh``, ``cs`` redistributes the DTensor ``x`` to
    it (the reference's ``with_sharding_constraint``: the collectives a
    change of layout needs); without one it is the identity.  Carries
    ``moe_groups`` (the DP degree, for the grouped MoE dispatch),
    ``moe_mode`` and ``device_mesh``."""
    dm = getattr(mesh, "device_mesh", None)

    def spec(x, kind):
        return fitted_spec(policy.act_spec(kind, mesh, global_batch),
                           tuple(x.shape), mesh)

    def cs(x, kind):
        if dm is None:
            return x
        if not is_dtensor(x):
            raise TypeError(f"cs({kind!r}): a plain tensor on a mesh with "
                            "a device_mesh; place the step's inputs first")
        return redistribute(x, to_placements(spec(x, kind), dm))

    cs.spec = spec
    cs.zeros_cache = lambda cache_abs: zeros_tree(
        cache_abs, policy.cache_spec_tree(cache_abs, mesh, global_batch),
        mesh)
    cs.moe_groups = (dp_size(mesh)
                     if global_batch % max(dp_size(mesh), 1) == 0 else 1)
    cs.moe_mode = policy.moe_mode
    cs.device_mesh = dm
    return cs


def policy_for(arch_name: str) -> Policy:
    """Per-arch distribution policy.

    MoE modes by arithmetic intensity:
    * granite (32 tiny experts, top-8: weights a layer 100 MB against more
      than 1 GB a device of tokens) -> "dp": replicate experts, never move
      tokens;
    * phi3.5 (16 x 157 MB experts, 1/EP-shard fits a device) -> "ep_ctp":
      capacity over TP, no row-parallel all-reduce;
    * jamba (348B of expert weights, which must stay ffn-TP-sharded to
      fit) -> "ep_a2a".
    """
    if "jamba" in arch_name:
        return Policy(fsdp=True, zero1=True, moe_mode="ep_a2a")
    if "phi35" in arch_name:
        return Policy(fsdp=True, zero1=True, moe_mode="ep_ctp")
    if "granite" in arch_name:
        return Policy(fsdp=False, zero1=True, moe_mode="dp")
    return Policy(fsdp=False, zero1=True)
