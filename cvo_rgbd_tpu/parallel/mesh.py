"""Device-mesh construction helpers.

The reference's only parallel resource is the TBB thread pool
(cvo.cpp:362); the equivalent here is a `jax.sharding.Mesh` over the
devices of one host and, across hosts, over the network (multi-host),
built here.  The cards of one host are joined all to all, so the axis
order follows the algorithm only.  SURVEY.md
section 2.6 maps each reference reduction to its collective.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh from `axes` = {name: size}; -1 means "the rest".

    Default: all devices on a single "sp" (point-sharding) axis.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if axes is None:
        axes = {"sp": n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n}")
    arr = np.array(devices[:total]).reshape(sizes)
    return Mesh(arr, names)


def multihost_initialize(**kwargs):
    """Initialize jax.distributed for multi-host meshes.

    One entry point with LOUD failure semantics: only the benign
    "already initialized" case is swallowed (so drivers can call this
    unconditionally); any real init failure — bad coordinator address,
    unreachable peers, size mismatch — is logged and re-raised, instead
    of surfacing later as a confusing mesh-size error.

    Launch contract (one process per host, standard jax.distributed):
        multihost_initialize(coordinator_address="host0:8476",
                             num_processes=H, process_id=h)
    after which `jax.devices()` is the GLOBAL device list and
    `make_mesh({"dp": H, "sp": -1})` lays dp across hosts (outer axis)
    and sp over the devices of each host.  See tests/test_multihost.py for a live 2-process
    CPU-backend exercise of this path.
    """
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return  # benign: this process already initialized the service
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" in str(e).lower():
            return  # benign: repeated call in the same process
        import logging

        logging.getLogger(__name__).error(
            "jax.distributed.initialize(%s) failed: %s", kwargs, e
        )
        raise
