"""Logical devices and sharded leaves — the port's counterpart of the parts
of ``repro.distributed.sharding`` and ``jax.sharding`` the elastic instance
uses.

One controller drives every logical device, as JAX does.  A logical device
is an index into ``all_devices``, a list of ``torch.device``s; several
logical devices may name the same card (or the CPU), so all accounting and
placement goes by logical id, never by ``torch.device``:

* ``Mesh`` is ``make_instance_mesh``'s grid: a configuration's logical ids
  reshaped to ``(dp, tp)`` in row-major order;
* ``NamedSharding`` splits a shape over that grid by a per-dimension spec
  (``None``, ``"dp"``, ``"tp"`` or ``("dp", "tp")``), with the shard indices
  ``jax.sharding.NamedSharding.devices_indices_map`` gives: row-major over
  the named axes, and ``slice(None)`` along a dimension whose axes have
  size 1 in all;
* ``ShardedTensor`` is the counterpart of a ``jax.Array`` under such a
  sharding: one tensor per logical device, each a distinct tensor even
  where two logical devices share a card.  Placing a shard on a logical
  device is a real copy (``place``), never ``.to(device)``, which returns
  the tensor itself on the same device;
* ``ParallelCtx`` says how a model step maps onto the logical devices;
* ``tp_all_reduce``, ``tp_gather``, ``tp_all_gather`` and ``tp_broadcast``
  carry the sums and gathers between the TP ranks of a replica, in rank
  order.

Parameter and cache trees are nested dicts and lists; ``tree_*`` walk them
in JAX's order (dict keys sorted, list items in order).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]


# ------------------------------------------------------------------- trees

def tree_leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``"a/b/0/c"`` path, leaf) pairs in JAX's flattening order; a
    NamedTuple's fields are ``.name``, as ``str`` of JAX's key gives them
    (the training checkpoints' keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], f"{prefix}{k}/")
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from tree_leaves_with_path(getattr(tree, f),
                                             f"{prefix}.{f}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> list:
    """The leaves in JAX's flattening order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """The same nesting with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               f"{prefix}.{f}/")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def local_view(tree, device: int):
    """Logical device ``device``'s view of a tree: each sharded leaf's shard
    there; plain tensors as they are."""
    return tree_map_with_path(
        lambda _, t: t.shard(device) if isinstance(t, ShardedTensor) else t,
        tree)


# -------------------------------------------------------------------- mesh

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A configuration's logical devices as a ``(dp, tp)`` grid, row-major
    (the port of ``make_instance_mesh``'s ``jax.sharding.Mesh``)."""
    dp: int
    tp: int
    devices: Tuple[int, ...]                 # logical ids, row-major
    all_devices: Tuple[torch.device, ...]    # logical id -> torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    def coords(self, device: int) -> Dict[str, int]:
        slot = self.devices.index(device)
        return {"dp": slot // self.tp, "tp": slot % self.tp}

    def torch_device(self, device: int) -> torch.device:
        return self.all_devices[device]


def check_devices(cfg, all_devices: Sequence[torch.device]) -> None:
    """Raise for a configuration naming a logical device the list lacks:
    nothing maps a missing device onto another one."""
    missing = [d for d in cfg.devices if not 0 <= d < len(all_devices)]
    if missing:
        raise ValueError(f"{cfg.describe()}: logical devices {missing} are "
                         f"not in all_devices ({len(all_devices)} entries)")


def make_instance_mesh(cfg, all_devices: Sequence[torch.device]) -> Mesh:
    check_devices(cfg, all_devices)
    return Mesh(cfg.dp, cfg.tp, tuple(cfg.devices), tuple(all_devices))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: Spec

    def axes(self, dim: int) -> Tuple[str, ...]:
        ax = self.spec[dim] if dim < len(self.spec) else None
        if ax is None:
            return ()
        return (ax,) if isinstance(ax, str) else tuple(ax)

    def devices_indices_map(self, shape) -> Dict[int, Tuple[slice, ...]]:
        """Logical id -> the shard's index (one slice per dimension)."""
        out = {}
        for dev in self.mesh.devices:
            coords = self.mesh.coords(dev)
            index = []
            for dim, size in enumerate(shape):
                axes = self.axes(dim)
                n = math.prod(self.mesh.shape[a] for a in axes)
                if n == 1:
                    index.append(slice(None))
                    continue
                if size % n:
                    raise ValueError(f"dimension {dim} of {tuple(shape)} "
                                     f"does not split over {axes} ({n})")
                pos = 0
                for a in axes:
                    pos = pos * self.mesh.shape[a] + coords[a]
                step = size // n
                index.append(slice(pos * step, (pos + 1) * step))
            out[dev] = tuple(index)
        return out


def index_shape(shape, index) -> Tuple[int, ...]:
    return tuple(len(range(*s.indices(n))) for n, s in zip(shape, index))


def place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``t`` on ``device`` — always a new tensor, also when ``t``
    is already there (a move between two logical devices on one card)."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


# ------------------------------------------------------------------ leaves

class ShardedTensor:
    """A logical array of ``shape`` held as one tensor per logical device
    under ``sharding`` (the port's ``jax.Array`` with a ``NamedSharding``).
    ``shards`` maps logical id -> that device's piece."""

    def __init__(self, shape, sharding: NamedSharding,
                 shards: Dict[int, torch.Tensor]):
        self.shape = tuple(shape)
        self.sharding = sharding
        target = sharding.devices_indices_map(self.shape)
        if set(shards) != set(target):
            raise ValueError(f"shards on {sorted(shards)}, the sharding "
                             f"names {sorted(target)}")
        dtypes = {t.dtype for t in shards.values()}
        if len(dtypes) != 1:
            raise ValueError(f"shards of several dtypes {dtypes}")
        for dev, t in shards.items():
            want = index_shape(self.shape, target[dev])
            if tuple(t.shape) != want:
                raise ValueError(f"shard on {dev} is {tuple(t.shape)}, its "
                                 f"index wants {want}")
        self.dtype = dtypes.pop()
        self._index = target
        # mesh order, as jax.Array.addressable_shards
        self.shards = {dev: shards[dev] for dev in sharding.mesh.devices}

    @property
    def nbytes(self) -> int:
        """Bytes of the logical array (as ``jax.Array.nbytes``)."""
        return math.prod(self.shape) * self.dtype.itemsize

    @property
    def addressable_shards(self) -> List[Tuple[int, Tuple[slice, ...],
                                               torch.Tensor]]:
        """(logical id, index, tensor) per shard, in mesh order."""
        return [(d, self._index[d], t) for d, t in self.shards.items()]

    def shard(self, device: int) -> torch.Tensor:
        return self.shards[device]

    def __getitem__(self, i: int) -> "ShardedTensor":
        """Entry ``i`` of an unsplit leading axis (one layer of a stacked
        leaf): views of every shard."""
        if self.sharding.axes(0):
            raise IndexError("the leading axis is split over devices")
        sub = NamedSharding(self.sharding.mesh, tuple(self.sharding.spec[1:]))
        return ShardedTensor(self.shape[1:], sub,
                             {d: t[i] for d, t in self.shards.items()})

    @classmethod
    def from_tensor(cls, t: torch.Tensor, sharding: NamedSharding,
                    keep_on: int = -1) -> "ShardedTensor":
        """Shard a whole tensor: each logical device gets a copy of its
        piece.  Logical device ``keep_on`` takes ``t`` itself where its
        piece is all of ``t`` (the device the whole tensor was made for)."""
        mesh = sharding.mesh
        shards = {}
        for dev, index in sharding.devices_indices_map(t.shape).items():
            if dev == keep_on and index_shape(t.shape, index) == t.shape \
                    and t.device == mesh.torch_device(dev):
                shards[dev] = t
            else:
                shards[dev] = place(t[index], mesh.torch_device(dev))
        return cls(t.shape, sharding, shards)

    def gather(self, device="cpu") -> torch.Tensor:
        """The logical array assembled on ``device`` (tests, checks)."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for _, index, t in self.addressable_shards:
            out[index] = t.to(device)
        return out


# ----------------------------------------------------------------- compute

@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """How a model step maps onto logical devices (the port of
    ``repro.distributed.sharding.ParallelCtx``; it holds the logical
    devices with their ``(dp, tp)`` shape instead of a mesh object).

    Expert parallelism spans every device, EP = DP x TP, in slot order,
    and the expert FFN's hidden dim stays whole, as in the reference's
    elastic engine context (``moe_tp=False``), so the expert FFN needs no
    sum over TP ranks.  ``moe_dispatch`` selects ``moe_ep``'s body over
    dense banks: ``"expert_slots"`` (one capacity slot set per expert) or
    ``"packed"`` (one per destination device); the engine never selects
    packed, and pooled pages always take the expert-slot body."""
    devices: Tuple[int, ...]                 # logical ids, slot order
    dp: int
    tp: int
    all_devices: Tuple[torch.device, ...]
    moe_dispatch: str = "expert_slots"       # or "packed"

    @property
    def num_ep(self) -> int:
        return self.dp * self.tp

    @property
    def replicas(self) -> Tuple[int, ...]:
        """The first logical device of each DP replica."""
        return self.devices[::self.tp]

    def torch_device(self, device: int) -> torch.device:
        return self.all_devices[device]

    def replica_devices(self, replica: int) -> Tuple[int, ...]:
        """Replica ``replica``'s logical devices, TP rank 0 first."""
        return self.devices[replica * self.tp:(replica + 1) * self.tp]


# ------------------------------------------------------------- collectives
#
# The sums and gathers between the TP ranks of one replica: the port's
# counterparts of the collectives GSPMD inserts where a TP-split product
# meets replicated activations.  Each takes one tensor per rank, in rank
# order, and returns one result per rank, on that rank's device, in a
# fixed order (no reduction order depends on timing).  On one card they are
# copies and adds; a multi-card build may replace them by NCCL collectives
# with the same signatures.

def tp_all_reduce(parts: Sequence[torch.Tensor],
                  devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of ``parts`` (one per rank, rank 0 first, added in that
    order) on every rank's device: each rank r > 0 sends its part to rank
    0 (``place``, a copy also where the two ranks share a card), which
    adds it and sends the sum back.  One rank: its part itself."""
    total = parts[0]
    for p in parts[1:]:
        total = total + place(p, devices[0])
    return tp_broadcast(total, devices)


def tp_gather(parts: Sequence[torch.Tensor], devices: Sequence[torch.device],
              dim: int) -> torch.Tensor:
    """``parts`` (one per rank) joined along ``dim`` in rank order on rank
    0's device: each part is copied into its slice of the result.  One
    rank: its part itself."""
    if len(parts) == 1:
        return parts[0]
    sizes = [p.shape[dim] for p in parts]
    shape = list(parts[0].shape)
    shape[dim] = sum(sizes)
    whole = torch.empty(shape, dtype=parts[0].dtype, device=devices[0])
    for p, piece in zip(parts, whole.split(sizes, dim)):
        piece.copy_(p)
    return whole


def tp_all_gather(parts: Sequence[torch.Tensor],
                  devices: Sequence[torch.device],
                  dim: int) -> List[torch.Tensor]:
    """``parts`` (one per rank) joined along ``dim`` in rank order, on
    every rank's device (:func:`tp_gather`, then :func:`tp_broadcast`).
    One rank: its part itself."""
    return tp_broadcast(tp_gather(parts, devices, dim), devices)


def tp_broadcast(t: torch.Tensor,
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Rank 0's ``t`` on every rank's device: ``t`` itself for rank 0, a
    copy for each other rank (the replication over 'tp' of rows the
    expert-parallel MoE returned to rank 0)."""
    return [t] + [place(t, d) for d in devices[1:]]
