"""Device-mesh construction.

The reference is strictly single-process / single-device (SURVEY.md section 2,
parallelism inventory: no collectives of any kind). This module is the entry
point of the scale-out path: a flat 1-D ``jax.sharding.Mesh`` over the local
GPUs (and across hosts via ``jax.distributed.initialize``), consumed by the
sharded Gram assembler and the distributed dense factorizations. The cards
of one host are joined all to all by NVLink, so the mesh follows the
algorithm alone.

Why 1-D (and not a ScaLAPACK-style 2-D process grid): the panel algorithms'
communication is one panel broadcast per step - ``O(n B)`` bytes - for a
total of ``~4 n_pad^2`` bytes received per device over a whole
factorization, against ``n_pad^3 / 3P`` flops of per-device compute; the
ratio of compute to traffic grows with ``n_pad / P``. A 2-D layout would
cut per-device traffic to O(n^2/sqrt(P)) and matters only at device counts
far past one host. Real collective time on a 4-card NVLink host is not
measured yet (ROADMAP B3).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def device_count() -> int:
    return len(jax.devices())


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "p") -> Mesh:
    """Build the 1-D mesh over the first ``n_devices`` devices.

    Axis ``'p'`` is the block-cyclic panel axis consumed by every
    distributed algorithm in :mod:`.cholesky` / :mod:`.gram`.
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {len(devs)} "
            f"devices are visible (platform {jax.default_backend()!r}; on "
            "CPU set XLA_FLAGS=--xla_force_host_platform_device_count=N)"
        )
    return Mesh(np.asarray(devs[:n_devices]), (axis_name,))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Multi-host bring-up; returns whether the distributed runtime started.

    Only needed across hosts: one process drives all of its host's cards.
    With ``num_processes > 1`` the coordinator/process identity is passed
    through to ``jax.distributed.initialize`` (call before any device use;
    each host then builds the same global :func:`make_mesh`). Otherwise
    (single process, CPU testing) this is a no-op.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    return False
