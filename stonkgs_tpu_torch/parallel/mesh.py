"""The {data, model} mesh of the port and its sharding rules, on torch.distributed.

The port of the JAX package's ``stonkgs_tpu/parallel/mesh.py``.  A
:class:`Mesh` lays the ranks of the process group out as an
``n_data x n_model`` grid (rank = data index * n_model + model index,
``torch.distributed.device_mesh.init_device_mesh``) with one process group
for each axis:

* ``data``: the batch is split over it; the gradients of every leaf are
  summed over it by explicit collectives in the train step;
* ``model``: the KG table is split by rows and the MLM/ELM/protein
  decoders by columns (:func:`param_pspec`); :mod:`stonkgs_tpu_torch.parallel.tp`
  holds the lookups and the loss that never gather them whole.

``fsdp=True`` also splits every large replicated leaf along the ``data``
axis (its largest dimension that ``n_data`` divides, the JAX package's
``_fsdp_spec``): parameters and both AdamW moments stay split between
steps (ZeRO-3 storage); the step all-gathers them before the forward and
reduce-scatters their gradients after the backward.

Every rank holds only its own slice of a split leaf.  A spec is a tuple
with one entry a dimension, ``"data"``, ``"model"`` or ``None``, and ``()``
for a replicated leaf: the ``PartitionSpec`` of the JAX package as a plain
tuple.  :func:`shard_params` returns the rank's slices with a
:class:`ParamLayout` that records every leaf's spec and full shape, which
the train step, the optimizer's clip and the checkpoints read.

The collectives go through :func:`all_reduce_`, :func:`all_gather` and
:func:`reduce_scatter`: on a gloo group a CUDA tensor is copied to the
host, reduced there and copied back (ranks that share one card cannot use
NCCL); an NCCL group never takes that branch.  A group of one rank skips
the call, so a 1 x 1 mesh runs the unmeshed arithmetic bit for bit.

The JAX package's ``replicate_unsharded`` has no counterpart: the step
count and the seed of a train state are Python ints here, not arrays that
must be placed on the mesh.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from stonkgs_tpu_torch.utils.tree import tree_flatten_with_path, tree_map_with_path

DATA_AXIS = "data"
MODEL_AXIS = "model"

# leaves smaller than this stay replicated under fsdp (biases, LayerNorms)
FSDP_MIN_SIZE = 65_536

# a leaf of one layer of an encoder: the JAX package stacks the layers on a
# leading axis, the port keeps a list of per-layer dicts
_LAYER = re.compile(r"^(.*/encoder)/(\d+)/(.*)$")


class Mesh:
    """An ``n_data x n_model`` grid of the ranks of the process group.

    Built by :func:`make_mesh`; ``Mesh(n_data, n_model)`` without a device
    mesh holds the shape alone, which the spec functions need (and a
    mesh of one rank, which needs no collective)."""

    def __init__(self, n_data: int = 1, n_model: int = 1, device_mesh=None):
        self.shape = {DATA_AXIS: int(n_data), MODEL_AXIS: int(n_model)}
        self.device_mesh = device_mesh
        if device_mesh is not None:
            self.data_group = device_mesh.get_group(DATA_AXIS)
            self.model_group = device_mesh.get_group(MODEL_AXIS)
            self.world_group = dist.group.WORLD
            self.data_index = dist.get_rank(self.data_group)
            self.model_index = dist.get_rank(self.model_group)
        else:
            self.data_group = self.model_group = self.world_group = None
            self.data_index = self.model_index = 0

    def require_groups(self) -> None:
        """Raise for a mesh of several ranks that has no process groups."""
        if self.size > 1 and self.device_mesh is None:
            raise ValueError(f"{self!r} holds a shape only: build it with make_mesh")

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def is_main(self) -> bool:
        """Whether this is the rank that writes files (data and model index 0)."""
        return self.data_index == 0 and self.model_index == 0

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, model={self.n_model}, "
                f"index=({self.data_index}, {self.model_index}))")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The {data, model} mesh over every rank of the process group.

    ``n_data`` defaults to ``world // n_model``; the mesh must cover the
    world.  Without a process group only a 1 x 1 mesh can be made."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the {world} ranks "
                         "of the process group")
    if not initialized:
        return Mesh(1, 1)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = init_device_mesh(device_type, (n_data, n_model),
                                   mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(n_data, n_model, device_mesh)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through the host: a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place and return it."""
    if group_size(group) == 1:
        return t
    if _staged(t, group):
        buf = t.detach().cpu()
        dist.all_reduce(buf, op=op, group=group)
        return t.copy_(buf)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The slices of every rank of ``group`` concatenated along ``dim``, in
    group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    x = t.detach().movedim(dim, 0).contiguous()
    staged = _staged(x, group)
    if staged:
        x = x.cpu()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.to(t.device).movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``group``, of which this rank keeps its slice
    along ``dim`` (group-rank order)."""
    n = group_size(group)
    if n == 1:
        return t
    x = t.detach().movedim(dim, 0).contiguous()
    staged = _staged(x, group)
    if staged:
        x = x.cpu()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.to(t.device).movedim(0, dim).contiguous()


def data_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``t`` summed over the data axis (a new tensor, outside autograd): the
    global count behind a batch mean whose shards hold their own rows."""
    if mesh is None or mesh.n_data == 1:
        return t
    return all_reduce_(t.detach().clone(), mesh.data_group)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def param_pspec(path: str) -> tuple:
    """The spec of a parameter from its tree path (the JAX package's rules).

    Split on ``model``: ``kg_backbone`` by rows; the ``text``, ``entity``
    and ``prot`` decoders by columns, and their bias vectors.  Replicated
    otherwise."""
    if path.endswith("kg_backbone"):
        return (MODEL_AXIS, None)
    if "entity_decoder" in path or "text_decoder" in path or "prot_decoder" in path:
        return (None, MODEL_AXIS)
    if path.endswith("entity_bias") or path.endswith("text_bias") or path.endswith("prot_bias"):
        return (MODEL_AXIS,)
    return ()


def _fsdp_spec(shape, n_data: int, min_size: int) -> tuple:
    """Split the largest ``n_data``-divisible dim on the data axis (the
    last of equal ones); ``()`` below ``min_size`` elements or when none
    divides."""
    size = 1
    for s in shape:
        size *= int(s)
    if size < min_size:
        return ()
    best = None
    for axis, s in enumerate(shape):
        if s % n_data == 0 and (best is None or s >= shape[best]):
            best = axis
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = DATA_AXIS
    return tuple(spec)


def param_specs(params: dict, mesh: Optional[Mesh] = None, fsdp: bool = False,
                fsdp_min_size: Optional[int] = None) -> Dict[str, tuple]:
    """``{path: spec}`` for every leaf (the JAX package's
    ``_tree_paths_and_specs``).

    Under ``fsdp`` a replicated leaf that is not an embedding table is
    split by :func:`_fsdp_spec`.  A leaf of an encoder layer is judged as
    the JAX package judges its stacked leaf, ``(layers,) + shape``: the
    size gate counts every layer and the split dimension is the stacked
    one's; where that is the layer axis itself the port keeps the leaf
    replicated (a layer's leaf has no such axis)."""
    flat = tree_flatten_with_path(params)
    n_data = mesh.n_data if mesh is not None else 1
    min_size = FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size
    layers: Dict[str, int] = {}
    for path in flat:
        m = _LAYER.match(path)
        if m:
            layers[m.group(1)] = max(layers.get(m.group(1), 0), int(m.group(2)) + 1)
    specs = {}
    for path, leaf in flat.items():
        spec = param_pspec(path)
        if fsdp and spec == () and n_data > 1 and "embedding" not in path:
            m = _LAYER.match(path)
            if m:
                stacked = _fsdp_spec((layers[m.group(1)],) + tuple(leaf.shape), n_data, min_size)
                spec = stacked[1:] if stacked and stacked[0] is None else ()
            else:
                spec = _fsdp_spec(tuple(leaf.shape), n_data, min_size)
        specs[path] = spec
    return specs


def _pad_to_multiple(t: torch.Tensor, dim: int, m: int) -> torch.Tensor:
    pad = (-t.shape[dim]) % m
    if pad == 0:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def pad_params_for_mesh(params: dict, mesh: Mesh) -> dict:
    """Zero-pad the model-split dims to multiples of the model axis.

    The padding is inert: padded KG rows are never gathered (ids are below
    the table's size) and the losses give padded decoder columns ``-inf``
    (:func:`stonkgs_tpu_torch.parallel.tp.tp_masked_cross_entropy`)."""
    n_model = mesh.n_model
    if n_model == 1:
        return params

    def pad(path, t):
        for dim, name in enumerate(param_pspec(path)):
            if name == MODEL_AXIS:
                t = _pad_to_multiple(t, dim, n_model)
        return t

    return tree_map_with_path(pad, params)


# ---------------------------------------------------------------------------
# the layout of a sharded tree
# ---------------------------------------------------------------------------

REPLICATED, MODEL_SPLIT, DATA_SPLIT = "replicated", "model", "data"


@dataclasses.dataclass
class ParamLayout:
    """Where every leaf of a parameter tree lives on a mesh: its spec and
    its full (unpadded) shape, by tree path.  A tree of optimizer moments
    over the trainable subtree has the same paths."""

    mesh: Mesh
    specs: Dict[str, tuple]
    shapes: Dict[str, tuple]

    def split(self, path: str) -> Optional[Tuple[int, str]]:
        """(dim, axis) of the split dimension of a leaf, or None where it is
        whole on every rank (an axis of one rank splits nothing: a 1 x 1
        mesh then runs the unmeshed arithmetic, the clip's norm included)."""
        for dim, name in enumerate(self.specs.get(path, ())):
            if name is not None and self.mesh.shape[name] > 1:
                return dim, name
        return None

    def kind(self, path: str) -> str:
        s = self.split(path)
        return REPLICATED if s is None else (MODEL_SPLIT if s[1] == MODEL_AXIS else DATA_SPLIT)

    @property
    def has_fsdp(self) -> bool:
        return any(self.kind(p) == DATA_SPLIT for p in self.specs)

    def shard_leaf(self, path: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full, unpadded leaf (a new tensor where
        the leaf is split, ``full`` itself where it is replicated)."""
        s = self.split(path)
        if s is None:
            return full
        dim, axis = s
        m = self.mesh
        if axis == MODEL_AXIS:
            n, i = m.n_model, m.model_index
            full = _pad_to_multiple(full, dim, n)
        else:
            n, i = m.n_data, m.data_index
        return full.chunk(n, dim=dim)[i].clone()

    def gather_leaf(self, path: str, local: torch.Tensor) -> torch.Tensor:
        """The full, unpadded leaf from every rank's slice (a collective)."""
        s = self.split(path)
        if s is None:
            return local
        dim, axis = s
        group = self.mesh.model_group if axis == MODEL_AXIS else self.mesh.data_group
        return all_gather(local, group, dim).narrow(dim, 0, self.shapes[path][dim])

    def shard(self, tree, prefix: str = ""):
        """Slices of a tree of full leaves; ``prefix`` is the paths' root."""
        return tree_map_with_path(lambda p, t: self.shard_leaf(p, t), tree, prefix)

    def gather(self, tree, prefix: str = ""):
        """Full, unpadded leaves of a tree of slices, on every rank."""
        return tree_map_with_path(lambda p, t: self.gather_leaf(p, t), tree, prefix)

    def gather_fsdp(self, tree, prefix: str = ""):
        """The tree with its data-split leaves all-gathered (the step's
        view of the parameters: model-split leaves stay split)."""
        def g(path, t):
            s = self.split(path)
            if s is None or s[1] != DATA_AXIS:
                return t
            return all_gather(t, self.mesh.data_group, s[0])
        return tree_map_with_path(g, tree, prefix)

    # -- the train step's reductions -------------------------------------

    def reduce_grads(self, paths: List[str], grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Local gradients of the step's view -> this rank's gradients of the
        global batch, in the layout's slices.

        * model-split leaves: summed over the data axis;
        * data-split (FSDP) leaves: reduce-scattered over the data axis;
        * replicated leaves: summed over the whole world and divided by
          ``n_model``.  The ranks of one data index hold equal gradients
          up to the order of a kernel's atomic adds; summing them all keeps
          every replica's parameters bit-identical.  With ``n_model`` 1
          the world is the data axis.
        Data-split leaves are averaged over the model axis likewise."""
        m = self.mesh
        out = list(grads)
        by_kind: Dict[str, List[int]] = {REPLICATED: [], MODEL_SPLIT: [], DATA_SPLIT: []}
        for i, p in enumerate(paths):
            by_kind[self.kind(p)].append(i)
        _bucket_all_reduce(out, by_kind[REPLICATED], m.world_group,
                           1.0 / m.n_model if m.n_model > 1 else None)
        _bucket_all_reduce(out, by_kind[MODEL_SPLIT], m.data_group, None)
        for i in by_kind[DATA_SPLIT]:
            g = reduce_scatter(out[i], m.data_group, self.split(paths[i])[0])
            if m.n_model > 1:
                g = all_reduce_(g, m.model_group).mul_(1.0 / m.n_model)
            out[i] = g
        return out

    def grad_norm(self, paths: List[str]) -> Optional[Callable]:
        """The global-norm function for gradients in this layout, or None
        when every leaf is whole on every rank (the local norm is global).

        The squares of model-split slices are summed over the model axis,
        of data-split slices over the data axis; a replicated leaf counts
        once.  The result is the norm of the global gradient, as the JAX
        package's clip computes it over its global arrays."""
        kinds = [self.kind(p) for p in paths]
        if all(k == REPLICATED for k in kinds):
            return None
        m = self.mesh

        def norm(g: List[torch.Tensor]) -> torch.Tensor:
            sq = torch.stack(torch._foreach_norm(g)).square()
            parts = {}
            for k in (REPLICATED, MODEL_SPLIT, DATA_SPLIT):
                idx = [i for i, kk in enumerate(kinds) if kk == k]
                parts[k] = sq[idx].sum() if idx else sq.new_zeros(())
            all_reduce_(parts[MODEL_SPLIT], m.model_group)
            all_reduce_(parts[DATA_SPLIT], m.data_group)
            return (parts[REPLICATED] + parts[MODEL_SPLIT] + parts[DATA_SPLIT]).sqrt()

        return norm


def _bucket_all_reduce(grads: List[torch.Tensor], idx: List[int], group,
                       scale: Optional[float]) -> None:
    """All-reduce ``grads[i]`` for ``i`` in ``idx`` as one flat buffer."""
    if not idx or group_size(group) == 1:
        return
    flat = torch.cat([grads[i].reshape(-1) for i in idx])
    all_reduce_(flat, group)
    if scale is not None:
        flat.mul_(scale)
    offset = 0
    for i in idx:
        n = grads[i].numel()
        grads[i] = flat[offset: offset + n].view_as(grads[i])
        offset += n


def shard_params(params: dict, mesh: Mesh, fsdp: bool = False,
                 fsdp_min_size: Optional[int] = None):
    """This rank's slices of a full parameter tree and their layout:
    ``(local_params, ParamLayout)``.

    Model-split dims are padded first (:func:`pad_params_for_mesh`);
    ``fsdp=True`` splits the large replicated leaves over the data axis
    (leaves below ``fsdp_min_size``, default :data:`FSDP_MIN_SIZE`, stay
    whole).  A split leaf's slice is a new tensor; a replicated leaf is
    the caller's tensor itself."""
    specs = param_specs(params, mesh, fsdp, fsdp_min_size)
    shapes = {p: tuple(t.shape) for p, t in tree_flatten_with_path(params).items()}
    layout = ParamLayout(mesh, specs, shapes)
    return layout.shard(params), layout


def shard_batch(batch: dict, mesh: Mesh, micro_batches: int = 1) -> dict:
    """This rank's rows of a global batch (numpy arrays or tensors): the
    rank's contiguous share of every micro-batch, so that the micro-batch
    ``i`` of every data rank together is the global micro-batch ``i``.
    Ranks that share a data index get the same rows."""
    n, d = mesh.n_data, mesh.data_index
    if n == 1:
        return batch

    def take(v):
        rows = v.shape[0]
        if rows % (micro_batches * n):
            raise ValueError(f"a batch of {rows} rows does not split into {micro_batches} "
                             f"micro-batches over {n} data ranks")
        per = rows // micro_batches
        b = per // n
        v = v.reshape((micro_batches, per) + tuple(v.shape[1:]))[:, d * b: (d + 1) * b]
        return v.reshape((micro_batches * b,) + tuple(v.shape[2:]))

    return {k: take(v) for k, v in batch.items()}
