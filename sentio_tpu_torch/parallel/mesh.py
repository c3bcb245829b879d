"""Device mesh construction — the counterpart of
``sentio_tpu/parallel/mesh.py``.

A :class:`Mesh` is an array of ``torch.device`` with JAX's named axes,
outermost to innermost ``dcn``, ``dp``, ``pp``, ``ep``, ``sp``, ``tp``.
JAX's serving mesh is single-controller: one process drives every device
and XLA inserts the collectives. The port keeps that design: one process
drives the mesh, and :mod:`.collectives` holds the collectives the
Megatron layout, the ring and the pipeline need (a sum and a gather over
``tp``, a permutation over ``sp`` or ``pp``).

A device may repeat in a mesh (``[cuda:0, cuda:0]``): every coordinate
still holds its own weight shard and pool, and launches its own kernels,
while the collectives between shards on one card are additions and
concatenations on that card's stream. That is how one card runs a real
tp=2 mesh, as JAX's tests lay a mesh over 8 virtual host devices.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from sentio_tpu_torch.config import MeshConfig

logger = logging.getLogger(__name__)

AXIS_DCN = "dcn"
AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_EP = "ep"
AXIS_SP = "sp"
AXIS_TP = "tp"

# canonical axis order, outermost → innermost
MESH_AXES = (AXIS_DCN, AXIS_DP, AXIS_PP, AXIS_EP, AXIS_SP, AXIS_TP)


class MeshError(Exception):
    pass


@dataclass(frozen=True)
class MeshSpec:
    """Resolved mesh geometry."""

    dcn: int
    dp: int
    pp: int
    ep: int
    sp: int
    tp: int

    @property
    def shape(self) -> tuple[int, int, int, int, int, int]:
        return (self.dcn, self.dp, self.pp, self.ep, self.sp, self.tp)

    @property
    def n_devices(self) -> int:
        return self.dcn * self.dp * self.pp * self.ep * self.sp * self.tp


def resolve_spec(config: MeshConfig, n_devices: int) -> MeshSpec:
    """Turn a (possibly partial) MeshConfig into concrete axis sizes.

    ``dp_size == 0`` means "absorb all remaining devices on the data axis"."""
    tp = max(1, config.tp_size)
    sp = max(1, config.sp_size)
    pp = max(1, config.pp_size)
    ep = max(1, config.ep_size)
    dcn = max(1, config.dcn_size)
    fixed = tp * sp * pp * ep * dcn
    if n_devices % fixed != 0:
        raise MeshError(
            f"{n_devices} devices not divisible by tp*sp*pp*ep*dcn={fixed} "
            f"(tp={tp}, sp={sp}, pp={pp}, ep={ep}, dcn={dcn})"
        )
    dp = config.dp_size if config.dp_size > 0 else n_devices // fixed
    spec = MeshSpec(dcn=dcn, dp=dp, pp=pp, ep=ep, sp=sp, tp=tp)
    if spec.n_devices != n_devices:
        raise MeshError(
            f"mesh {spec.shape} needs {spec.n_devices} devices, have {n_devices}"
        )
    return spec


class Mesh:
    """``devices``: an object array of ``torch.device`` of the mesh's shape,
    one axis per name in ``axis_names``; ``shape`` maps each name to its
    size, as JAX's ``mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = MESH_AXES) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise MeshError(f"a mesh of {devices.ndim} dims needs as many axis names, "
                            f"got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The first device: where the mesh's gathered results land."""
        return self.devices.flat[0]

    @property
    def one_card(self) -> bool:
        """Every coordinate on the same device."""
        return len(set(self.devices.flat)) == 1

    def coords(self):
        """Every (coordinate, device) pair, in row-major order."""
        for coord in np.ndindex(*self.devices.shape):
            yield coord, self.devices[coord]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def visible_devices(backend: str = "") -> list[torch.device]:
    """The devices a mesh is laid over by default, as ``jax.devices()``:
    every visible card ("" or "cuda"; none where CUDA is missing), or the
    host ("cpu", one device)."""
    if backend == "cpu":
        return [torch.device("cpu")]
    if backend not in ("", "cuda", "gpu"):
        raise MeshError(f"MESH_BACKEND={backend!r}: expected '', 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _normal(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_mesh(config: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """Build the device mesh over ``devices`` (default: every visible card,
    so a one-card host refuses tp=2 with JAX's :class:`MeshError`). An
    explicit list may repeat a device. The devices are laid out in the
    order given, as JAX's plain reshape lays out host devices."""
    config = config or MeshConfig()
    if devices is None:
        devices = visible_devices(config.backend)
    devices = [_normal(d) for d in devices]
    spec = resolve_spec(config, len(devices))
    grid = np.empty(spec.n_devices, dtype=object)
    grid[:] = devices
    mesh = Mesh(grid.reshape(spec.shape), MESH_AXES)
    logger.info("mesh built: %s over %d %s devices", mesh.shape, spec.n_devices,
                devices[0].type if devices else "no")
    return mesh


def split_mesh_dp(mesh: Mesh, n: int) -> list[Mesh]:
    """Split ``mesh`` into ``n`` submeshes along ``dp`` — one per
    data-parallel serving replica. Each keeps every other axis, so no
    collective crosses replicas. ``dp`` must divide evenly."""
    if n <= 0:
        raise MeshError(f"cannot split a mesh into {n} replicas")
    if n == 1:
        return [mesh]
    dp = mesh.shape[AXIS_DP]
    if dp % n != 0:
        raise MeshError(
            f"mesh dp={dp} not divisible by {n} replicas — set MESH_DP to a "
            f"multiple of REPLICAS (or REPLICAS to a divisor of dp)"
        )
    axis = MESH_AXES.index(AXIS_DP)
    return [Mesh(chunk, MESH_AXES) for chunk in np.split(mesh.devices, n, axis=axis)]


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes a request batch is sharded over (all data-like axes)."""
    return tuple(a for a in (AXIS_DCN, AXIS_DP) if mesh.shape[a] > 1) or (AXIS_DP,)


def batch_multiple(mesh: Mesh) -> int:
    """Batches split over the data axes must be a multiple of this."""
    return mesh.shape[AXIS_DCN] * mesh.shape[AXIS_DP]
