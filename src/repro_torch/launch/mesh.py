"""Mesh construction over ``torch.distributed``: the port's counterpart of
``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axes ``("data", "model")``.  Serving is SPMD: every rank runs
the same engine host logic on the same requests, and only the tensors are
sharded (``launch/shardings.py``).  The same program runs on one card as a
1-rank NCCL group, under ``torch.distributed.run`` over every card of a
machine (one process a card), and on the CPU as gloo ranks::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.serve --mesh auto

``make_serve_mesh`` starts the default process group when none is running:
from the environment under ``torch.distributed.run`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; each rank's card is ``cuda:LOCAL_RANK``),
else a 1-rank group of its own on an in-process store.  The mesh is built
only when asked for, never when this module is imported.

``make_role_meshes`` splits the ranks into the disaggregated pair's two
disjoint submeshes (``--roles``): a rank is a card, so a prefill burst on
the prefill ranks cannot take the decode ranks' cycles::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.serve --roles prefill=1,decode=1

Training takes a mesh of any shape: ``make_host_mesh`` lays one over the
first ranks of the group (tests, examples), and ``make_production_mesh``
the reference's pod layouts — (16, 16) as ("data", "model"), or (2, 16,
16) as ("pod", "data", "model") — which the dry run
(``launch/dryrun.py``) builds on a fake group of 256 or 512 ranks.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

#: the serving mesh's axes, major to minor
MESH_AXES = ("data", "model")


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry batch parallelism (``"pod"`` only on a multi-pod
    production mesh)."""
    names = getattr(mesh, "mesh_dim_names", None) \
        or getattr(mesh, "axis_names", ())
    return ("pod", "data") if "pod" in names else ("data",)


def start_group(device: str) -> None:
    """The default process group for ``device`` ("cuda": NCCL, "cpu":
    gloo), unless one is running: from ``torch.distributed.run``'s
    environment, or a 1-rank group on an in-process store."""
    if dist.is_initialized():
        return
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for a 'cuda' "
                               "mesh; pass device='cpu' for gloo ranks")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda"):
    """Single pod: 16x16 = 256 ranks, axes (data, model).  Multi-pod:
    2x16x16 = 512 ranks, axes (pod, data, model) — the ``pod`` axis carries
    only gradient/batch parallelism.  Built over the first ranks of the
    default group (started here if none is running): the dry run's fake
    group of that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes, device=device)


def make_host_mesh(shape=(1,), axes=("data",), *, device: str = "cuda"):
    """A mesh of ``shape`` and ``axes`` over the first ``prod(shape)`` ranks
    of the default group (started here if none is running)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for k in shape:
        n *= k
    start_group(device)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"need {n} devices, have {world}")
    return DeviceMesh(device, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_serve_mesh(dp: int | None = None, mp: int = 1, *,
                    device: str = "cuda"):
    """Serving mesh: a (data, model) grid over the first dp*mp ranks of the
    default process group (started here if none is running).

    ``dp`` defaults to every rank not consumed by ``mp`` — so
    ``make_serve_mesh()`` is pure data parallelism over all ranks, the
    layout that keeps sharded serving's tokens the single-device engine's
    (per-slot math never crosses a shard).  ``mp > 1`` adds tensor
    parallelism through the Mensa cluster specs in shardings.py."""
    from torch.distributed.device_mesh import DeviceMesh
    if mp < 1:
        raise ValueError(f"mp must be >= 1, got {mp}")
    start_group(device)
    world = dist.get_world_size()
    if dp is None:
        dp = max(1, world // mp)
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    if dp * mp > world:
        raise RuntimeError(f"mesh {dp}x{mp} needs {dp * mp} ranks, "
                           f"have {world}")
    return DeviceMesh(device, torch.arange(dp * mp).reshape(dp, mp),
                      mesh_dim_names=MESH_AXES)


@dataclasses.dataclass(frozen=True)
class RoleConfig:
    """Device partition for disaggregated serving: ``prefill`` data-parallel
    ranks feed ``decode`` ranks over disjoint submeshes of one device set.
    ``mp`` multiplies both (tensor parallelism within each role)."""
    prefill: int
    decode: int
    mp: int = 1

    def __post_init__(self):
        if self.prefill < 1 or self.decode < 1 or self.mp < 1:
            raise ValueError(f"role counts must be >= 1, got {self}")

    @property
    def devices(self) -> int:
        return (self.prefill + self.decode) * self.mp


def parse_roles_arg(spec: str) -> RoleConfig | None:
    """Parse a ``--roles`` string: "off"/"none"/"" (interleaved engine) or
    "prefill=N,decode=M" (disaggregated, N+M devices)."""
    s = spec.strip().lower()
    if s in ("off", "none", ""):
        return None
    kv = {}
    for part in s.split(","):
        key, eq, val = part.partition("=")
        try:
            if not eq:
                raise ValueError
            kv[key.strip()] = int(val)
        except ValueError as e:
            raise ValueError(f"--roles {spec!r}: expected "
                             f"'prefill=N,decode=M' or 'off'") from e
    unknown = set(kv) - {"prefill", "decode"}
    if unknown or set(kv) != {"prefill", "decode"}:
        raise ValueError(f"--roles {spec!r}: expected exactly "
                         f"'prefill=N,decode=M' or 'off'")
    return RoleConfig(prefill=kv["prefill"], decode=kv["decode"])


def make_role_meshes(roles: RoleConfig, *, device: str = "cuda"):
    """Disjoint (data, model) submeshes for the two roles over the default
    process group (started here if none is running): prefill takes the
    first ``prefill*mp`` ranks as a (prefill, mp) mesh, decode the next
    ``decode*mp`` as a (decode, mp) mesh.  Disjointness is the point — a
    prefill burst cannot steal decode's cycles — so the partition raises
    rather than oversubscribing.  Each rank is one card, so the group must
    hold exactly the roles' ranks: a rank outside both would hold a card
    and serve nothing.  Every rank builds both meshes, in the same order
    (``new_group`` is collective).  Returns ``(prefill_mesh, decode_mesh,
    role)``, ``role`` this rank's, "prefill" or "decode"."""
    from torch.distributed.device_mesh import DeviceMesh
    start_group(device)
    world = dist.get_world_size()
    if roles.devices > world:
        raise RuntimeError(f"roles {roles.prefill}+{roles.decode} (mp="
                           f"{roles.mp}) need {roles.devices} devices, "
                           f"have {world}")
    if roles.devices < world:
        raise RuntimeError(f"roles {roles.prefill}+{roles.decode} (mp="
                           f"{roles.mp}) use {roles.devices} devices, have "
                           f"{world}: start {roles.devices} processes")
    n_pre = roles.prefill * roles.mp
    ranks = torch.arange(roles.devices)
    pre = DeviceMesh(device, ranks[:n_pre].reshape(roles.prefill, roles.mp),
                     mesh_dim_names=MESH_AXES)
    dec = DeviceMesh(device, ranks[n_pre:].reshape(roles.decode, roles.mp),
                     mesh_dim_names=MESH_AXES)
    return pre, dec, "prefill" if dist.get_rank() < n_pre else "decode"


def parse_mesh_arg(spec: str, *, device: str = "cuda"):
    """Parse a ``--mesh`` string: "auto" (all ranks, data-parallel),
    "off"/"none" (no mesh), or "DPxMP" (e.g. "4x2")."""
    s = spec.strip().lower()
    if s in ("off", "none", ""):
        return None
    if s == "auto":
        return make_serve_mesh(device=device)
    dp, _, mp = s.partition("x")
    try:
        dp, mp = int(dp), int(mp) if mp else 1
    except ValueError as e:
        raise ValueError(f"--mesh {spec!r}: expected 'auto', 'off', or "
                         f"'DPxMP' like '4x2'") from e
    return make_serve_mesh(dp, mp, device=device)
